"""encode_p95_ms: the 95th percentile of the wall time of all encode
requests in the window."""

from benchmark.core.readers import p95_ms


def read(run):
    return p95_ms(run, ("encode",))
