"""Wire constants of the v3 container and what ``decode()`` needs to tell
a v1 or v2 blob apart, kept here so the port depends on nothing of the JAX
package (values from huffman_codec_tpu/formats.py and
huffman_codec_tpu/models/chunked.py).

v1 is the reference-compatible format,
``[byteCount u64 LE][flags u8][huffman bits, MSB-first, 0-padded]``, where
byteCount is the post-transform symbol count; v2 is the native chunked
FGK container and starts with ``V2_MAGIC``."""

from __future__ import annotations

import struct

FLAG_DIFF = 0x80  # bit7: diff model used
FLAG_ADAPT = 0x40  # bit6: adaptive block RLE used
FLAG_SHARDED = 0x20  # v3-only: transforms applied per input chunk
FLAG_AGROUP = 0x10  # v3-only: grouped adaptive tile manifest

V3_MAGIC = b"HCTPU\x03"
ENTROPY_FGK = 0
ENTROPY_CANONICAL = 1
ENTROPY = {"fgk": ENTROPY_FGK, "canonical": ENTROPY_CANONICAL}

GROUP_K = 64  # tiles per manifest group in grouped-manifest mode

V2_MAGIC = b"HCTPU\x02"  # 6 bytes; cannot be a sane v1 byteCount prefix
HUFF_HEADER_BYTES = 9  # v1: byteCount u64 LE, flags u8


def is_v2(data: bytes) -> bool:
    return data[: len(V2_MAGIC)] == V2_MAGIC


def parse_huff_header(header: bytes) -> tuple[int, bool, bool]:
    """v1 header -> (byteCount, diff used, adaptive RLE used)."""
    if len(header) < HUFF_HEADER_BYTES:
        raise ValueError("invalid or missing Huffman coding header")
    byte_count, flags = struct.unpack("<QB", header[:HUFF_HEADER_BYTES])
    return byte_count, bool(flags & FLAG_DIFF), bool(flags & FLAG_ADAPT)
