"""Full v1 (reference-compatible) pipeline — exact model of main.cpp.

compress: input -> [diff model] -> (stream RLE | adaptive block RLE)
               -> FGK Huffman bits -> header ++ MSB-first packed bytes
decompress: exact inverse, driven by header flags only (main.cpp:115-125).
"""

from __future__ import annotations

from huffman_codec_tpu_torch.formats import (
    make_huff_header,
    pack_bits_msb,
    parse_huff_header,
    unpack_bits_msb,
)
from huffman_codec_tpu_torch.pyref.fgk import fgk_decode, fgk_encode
from huffman_codec_tpu_torch.pyref.rle import (
    adapt_rle_decode,
    adapt_rle_encode,
    rle_decode,
    rle_encode,
)


def apply_diff_model(data) -> bytearray:
    """vec[i] -= vec[i-1] with implicit prev=0, mod-256 (transform.cpp:220-229)."""
    out = bytearray(len(data))
    prev = 0
    for i, b in enumerate(data):
        out[i] = (b - prev) & 0xFF
        prev = b
    return out


def revert_diff_model(data) -> bytearray:
    """Prefix sum mod 256 (transform.cpp:231-239)."""
    out = bytearray(len(data))
    acc = 0
    for i, b in enumerate(data):
        acc = (acc + b) & 0xFF
        out[i] = acc
    return out


def compress(data: bytes, use_diff: bool = False, use_adapt: bool = False,
             width: int = 512) -> bytes:
    """Exact model of huffCompress (main.cpp:39-87)."""
    if use_adapt and len(data) % width != 0:
        raise ValueError("invalid size of input 2D data detected")  # exit 6
    height = len(data) // width

    buf = bytes(data)
    if use_diff:
        buf = bytes(apply_diff_model(buf))
    if use_adapt:
        buf = adapt_rle_encode(buf, width, height)
    else:
        buf = bytes(rle_encode(buf))

    bits = fgk_encode(buf)
    # byteCount is the POST-transform symbol count (main.cpp:75)
    return make_huff_header(len(buf), use_diff, use_adapt) + pack_bits_msb(bits)


def decompress(blob: bytes) -> bytes:
    """Exact model of huffDecompress (main.cpp:90-128)."""
    symbol_count, use_diff, use_adapt = parse_huff_header(blob)
    bits = unpack_bits_msb(blob[9:])
    try:
        decoded = fgk_decode(bits, symbol_count)
    except IndexError:
        raise ValueError("invalid Huffman coding file contents")  # exit 9
    if use_adapt:
        out = adapt_rle_decode(decoded)
    else:
        out, _ = rle_decode(decoded)
    if use_diff:
        out = revert_diff_model(out)
    return bytes(out)
