"""Wire constants of the v3 container, what ``decode()`` needs to tell a
v1 or v2 blob apart, the v1 headers and the v1 bit order, kept here so the
port depends on nothing of the JAX package (values from
huffman_codec_tpu/formats.py and huffman_codec_tpu/models/chunked.py).

v1 is the reference-compatible format,
``[byteCount u64 LE][flags u8][huffman bits, MSB-first, 0-padded]``, where
byteCount is the post-transform symbol count; v2 is the native chunked
FGK container (``make_v2_container``, ``parse_v2_container``) and starts
with ``V2_MAGIC``."""

from __future__ import annotations

import struct
from dataclasses import dataclass

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
V2_VERSION = 1
HUFF_HEADER_BYTES = 9  # v1: byteCount u64 LE, flags u8


def is_v2(data: bytes) -> bool:
    return data[: len(V2_MAGIC)] == V2_MAGIC


@dataclass(frozen=True)
class V2Header:
    flags: int  # same bit meanings as v1 (FLAG_DIFF | FLAG_ADAPT)
    orig_size: int  # original (pre-transform) input size in bytes
    symbol_count: int  # post-transform symbol count (sum over chunks)
    chunk_size: int  # symbols per chunk (the last chunk may be short)
    chunk_bits: tuple[int, ...]  # compressed bit length per chunk

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_bits)


def make_v2_container(header: V2Header, payload: bytes) -> bytes:
    """The v2 layout: ``[magic 6B][version u8][flags u8]``, then
    ``[orig_size u64 LE][symbol_count u64 LE][chunk_size u32 LE]
    [n_chunks u32 LE]``, ``[chunk_bits u64 LE x n_chunks]`` and the
    payload, each chunk's FGK bitstream 0-padded to a byte, in chunk
    order."""
    return b"".join([
        V2_MAGIC, bytes([V2_VERSION, header.flags]),
        struct.pack("<QQII", header.orig_size, header.symbol_count,
                    header.chunk_size, header.n_chunks),
        struct.pack(f"<{header.n_chunks}Q", *header.chunk_bits), payload])


def parse_v2_container(data: bytes) -> tuple[V2Header, bytes]:
    """Inverse of ``make_v2_container``: (header, payload). A truncated
    blob raises what ``struct.unpack`` (or the indexing) raises."""
    if not is_v2(data):
        raise ValueError("not a v2 container")
    if data[6] != V2_VERSION:
        raise ValueError(f"unsupported v2 version {data[6]}")
    orig_size, symbol_count, chunk_size, n_chunks = struct.unpack(
        "<QQII", data[8:32])
    off = 32 + 8 * n_chunks
    chunk_bits = struct.unpack(f"<{n_chunks}Q", data[32:off])
    return V2Header(flags=data[7], orig_size=orig_size,
                    symbol_count=symbol_count, chunk_size=chunk_size,
                    chunk_bits=chunk_bits), data[off:]


def make_huff_header(byte_count: int, use_diff: bool,
                     use_adapt: bool) -> bytes:
    """The v1 header: byteCount u64 LE, then the flags byte."""
    flags = (FLAG_DIFF if use_diff else 0) | (FLAG_ADAPT if use_adapt else 0)
    return struct.pack("<QB", byte_count, flags)


def parse_huff_header(header: bytes) -> tuple[int, bool, bool]:
    """v1 header -> (byteCount, diff used, adaptive RLE used)."""
    if len(header) < HUFF_HEADER_BYTES:
        raise ValueError("invalid or missing Huffman coding header")
    byte_count, flags = struct.unpack("<QB", header[:HUFF_HEADER_BYTES])
    return byte_count, bool(flags & FLAG_DIFF), bool(flags & FLAG_ADAPT)


def block_count(width: int, height: int, block_size: int) -> int:
    """Tiles of a width x height matrix at block size ``block_size``."""
    return -(-width // block_size) * -(-height // block_size)


def make_adapt_rle_header(width: int, height: int, block_size: int,
                          scan_dirs) -> bytes:
    """The v1 adaptive header, ``[W u64 BE][H u64 BE][bs u64 BE]`` and a
    direction bit a tile (1 = horizontal), MSB-first, 0-padded. The
    big-endian u64s are the opposite of the outer header's byteCount."""
    return struct.pack(">QQQ", width, height, block_size) + pack_bits_msb(
        int(bool(d)) for d in scan_dirs)


def parse_adapt_rle_header(data: bytes):
    """The v1 adaptive header at the start of a decoded stream,
    ``[W u64 BE][H u64 BE][bs u64 BE][a direction bit a tile, MSB-first]``
    -> (W, H, bs, dirs (list of bool), header bytes)."""
    if len(data) < 24:
        raise ValueError("invalid or missing adaptive block RLE header")
    width, height, block_size = struct.unpack(">QQQ", data[:24])
    if block_size == 0:
        raise ValueError("invalid adaptive block RLE header")
    n_blocks = block_count(width, height, block_size)
    n_dir_bytes = (n_blocks + 7) // 8
    if len(data) < 24 + n_dir_bytes:
        raise ValueError("invalid adaptive block RLE header")
    dirs = [bool((data[24 + i // 8] >> (7 - i % 8)) & 1)
            for i in range(n_blocks)]
    return width, height, block_size, dirs, 24 + n_dir_bytes


def pack_bits_msb(bits) -> bytes:
    """Pack an iterable of 0/1 into bytes MSB-first, zero-padded (the v1
    payload's bit order)."""
    out = bytearray()
    acc = n = 0
    for b in bits:
        acc = (acc << 1) | (b & 1)
        n += 1
        if n == 8:
            out.append(acc)
            acc = n = 0
    if n:
        out.append(acc << (8 - n))
    return bytes(out)


def unpack_bits_msb(data: bytes) -> list[int]:
    """Bytes exploded into bits, MSB-first."""
    return [(byte >> i) & 1 for byte in data for i in range(7, -1, -1)]
