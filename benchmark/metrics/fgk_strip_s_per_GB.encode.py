"""fgk_strip_s_per_GB.encode: the codec's ``fgk strip`` span (the sharded
FGK encode's strip of its word rows into the payload, with the
synchronisations it holds) per GB encoded, from the stage split
(codec.timer) of a trace run."""

from benchmark.core.readers import stage_s_per_GB


def read(run):
    return stage_s_per_GB(run, "encode", ("fgk strip",))
