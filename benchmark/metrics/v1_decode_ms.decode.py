"""v1_decode_ms.decode: the codec's ``v1 decode`` span (the host
``v1_decompress`` of a v1 blob) per decode request, in ms, from the
codec's timer over a trace run's window."""


def read(run):
    n = sum(s.kind == "decode" for s in run.spans)
    sec = run.stages.get("decode", {}).get("v1 decode")
    return None if sec is None or not n else 1e3 * sec / n
