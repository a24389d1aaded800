"""PyTorch + CUDA port of the v3 chunk-parallel Huffman codec.

Runs on an NVIDIA H100 through hand-written CUDA kernels (``csrc/``,
bound by ``ops/_build.py``), and writes the same v3 container bytes as the
JAX package ``huffman_codec_tpu`` for the configurations it supports. It
imports nothing of JAX nor of the JAX package.

- ``models``  — ``TorchCodec`` (the v3 container) and ``V1Codec`` (the
                reference's v1 wire format), on the device
- ``ops``     — the kernels' wrappers and plain versions, and the torch
                ops around them
- ``native``  — the host C++ runtime of the v1 and v2 formats
- ``pyref``   — the exact pure-Python model of the v1 format
- ``utils``   — timers, profiler traces, metrics, table dumps
- ``cli``     — the command line, ``python -m huffman_codec_tpu_torch``
- ``parallel`` — data-parallel steps over a ``torch.distributed`` group
                (one process a rank), and the elastic re-dispatch helpers
"""

from huffman_codec_tpu_torch.formats import (
    FLAG_ADAPT,
    FLAG_DIFF,
    HUFF_HEADER_BYTES,
    make_huff_header,
    parse_huff_header,
)
from huffman_codec_tpu_torch.models.chunked import (
    MAIN_PATH,
    CodecConfig,
    TorchCodec,
    config_from_fields,
)
from huffman_codec_tpu_torch.models.reference import V1Codec

__all__ = ["CodecConfig", "FLAG_ADAPT", "FLAG_DIFF", "HUFF_HEADER_BYTES",
           "MAIN_PATH", "TorchCodec", "V1Codec", "config_from_fields",
           "make_huff_header", "parse_huff_header"]
