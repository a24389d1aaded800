"""parse_ms.range: the codec's ``parse`` span (``_parse`` of the whole
container inside ``decode_range``) per range request, in ms, from the
codec's timer (codec.timer) over a trace run's window."""


def read(run):
    n = sum(s.kind == "range" for s in run.spans)
    sec = run.stages.get("range", {}).get("parse")
    return None if sec is None or not n else 1e3 * sec / n
