"""host_s_per_GB.encode: the codec host layer's stages of the encode
(host staging, payload bytes, crc32, container) per GB encoded, from the
stage split (codec.timer) of a trace run."""

from benchmark.core.readers import stage_s_per_GB


def read(run):
    return stage_s_per_GB(run, "encode",
                          ("host staging", "payload", "crc32", "container"))
