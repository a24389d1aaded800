"""dispatch_ms.encode: the codec's ``dispatch`` span (the global layout's
launches: both candidates' torch-op stages and their fetches) per encode
request, in ms, from the codec's timer over a trace run's window."""


def read(run):
    n = sum(s.kind == "encode" for s in run.spans)
    sec = run.stages.get("encode", {}).get("dispatch")
    return None if sec is None or not n else 1e3 * sec / n
