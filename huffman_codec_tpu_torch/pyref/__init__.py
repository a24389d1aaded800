"""Exact scalar model of the reference wire format (v1), in pure Python.

A copy of the JAX package's model, so the port depends on nothing of it.
Slow but bit-exact: the command line falls back to it when the host C++
runtime cannot be built, and ``utils/dump.py`` replays its FGK tree.
"""

from huffman_codec_tpu_torch.pyref.codec import compress, decompress  # noqa: F401
from huffman_codec_tpu_torch.pyref.fgk import FGKTree  # noqa: F401
from huffman_codec_tpu_torch.pyref.rle import rle_decode, rle_encode  # noqa: F401
