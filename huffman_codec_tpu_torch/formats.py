"""Wire constants of the v3 container, kept here so the port depends on
nothing of the JAX package (values from huffman_codec_tpu/formats.py and
huffman_codec_tpu/models/chunked.py)."""

from __future__ import annotations

FLAG_DIFF = 0x80  # bit7: diff model used
FLAG_ADAPT = 0x40  # bit6: adaptive block RLE used
FLAG_SHARDED = 0x20  # v3-only: transforms applied per input chunk
FLAG_AGROUP = 0x10  # v3-only: grouped adaptive tile manifest

V3_MAGIC = b"HCTPU\x03"
ENTROPY_FGK = 0
ENTROPY_CANONICAL = 1
ENTROPY = {"fgk": ENTROPY_FGK, "canonical": ENTROPY_CANONICAL}

GROUP_K = 64  # tiles per manifest group in grouped-manifest mode
