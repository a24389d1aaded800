"""decode_MBps: restored bytes of every whole-object decode request in
the window over their summed wall time."""

from benchmark.core.readers import rate_MBps


def read(run):
    return rate_MBps(run, ("decode",))
