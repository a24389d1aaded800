"""fgk_rows_s_per_GB.decode: the codec's ``fgk rows`` device span (CUDA
events around an FGK decode's cut of its staged payload into word rows)
per GB decoded, from the stage split (codec.timer) of a trace run."""

from benchmark.core.readers import stage_s_per_GB


def read(run):
    return stage_s_per_GB(run, "decode", ("fgk rows",))
