"""encode_MBps: input bytes of every encode request in the window
(1e6 B a MB) over their summed wall time."""

from benchmark.core.readers import rate_MBps


def read(run):
    return rate_MBps(run, ("encode",))
