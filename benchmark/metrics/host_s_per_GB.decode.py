"""host_s_per_GB.decode: the codec host layer's stages of the decode
(parse, the bytes copy, crc32) per GB decoded, from the stage split."""

from benchmark.core.readers import stage_s_per_GB


def read(run):
    return stage_s_per_GB(run, "decode", ("parse", "bytes", "crc32"))
