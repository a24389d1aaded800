"""decode_p95_ms: the 95th percentile of the wall time of all decode
requests in the window, whole or ranged."""

from benchmark.core.readers import p95_ms


def read(run):
    return p95_ms(run, ("decode", "range"))
