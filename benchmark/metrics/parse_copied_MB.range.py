"""parse_copied_MB.range: the codec's ``parse copied bytes`` counter (the
container's bytes that ``_parse`` slices or copies) per range request, in
MB (1e6 B), from the codec's timer over a trace run's window."""


def read(run):
    n = sum(s.kind == "range" for s in run.spans)
    nbytes = run.stages.get("range", {}).get("parse copied bytes")
    return None if nbytes is None or not n else nbytes / 1e6 / n
