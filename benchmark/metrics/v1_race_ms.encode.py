"""v1_race_ms.encode: the codec's ``v1 race`` span (the host
``v1_compress`` of ``_race_v1``, where the race runs) per encode request,
in ms, from the codec's timer over a trace run's window."""


def read(run):
    n = sum(s.kind == "encode" for s in run.spans)
    sec = run.stages.get("encode", {}).get("v1 race")
    return None if sec is None or not n else 1e3 * sec / n
