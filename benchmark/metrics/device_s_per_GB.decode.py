"""device_s_per_GB.decode: the device time of the decode steps (CUDA
events around each step) per GB decoded."""

from benchmark.core.readers import stage_s_per_GB


def read(run):
    return stage_s_per_GB(run, "decode", ("device",))
