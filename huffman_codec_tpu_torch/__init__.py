"""PyTorch + CUDA port of the v3 chunk-parallel Huffman codec.

Runs on an NVIDIA H100 through hand-written CUDA kernels (``csrc/``,
bound by ``ops/_build.py``), and writes the same v3 container bytes as the
JAX package ``huffman_codec_tpu`` for the configurations it supports. It
imports nothing of JAX nor of the JAX package.
"""

from huffman_codec_tpu_torch.models.chunked import (
    MAIN_PATH,
    CodecConfig,
    TorchCodec,
    config_from_fields,
)
from huffman_codec_tpu_torch.models.reference import V1Codec

__all__ = ["CodecConfig", "MAIN_PATH", "TorchCodec", "V1Codec",
           "config_from_fields"]
