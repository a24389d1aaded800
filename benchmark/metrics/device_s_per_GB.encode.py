"""device_s_per_GB.encode: the step pipeline's device time of the
encode steps (CUDA events around each step) per GB encoded."""

from benchmark.core.readers import stage_s_per_GB


def read(run):
    return stage_s_per_GB(run, "encode", ("device",))
