"""The port's pure-Python model of the v1 format (``huffman_codec_tpu_torch.
pyref``) against the JAX package's (``huffman_codec_tpu.pyref``), on inputs
of at most 32 KiB: the same bytes from every function, the same FGK tree
state after the same updates, and the same v1 bit order and adaptive
header (``huffman_codec_tpu_torch.formats``). Every comparison is exact.
"""

import struct

import numpy as np
import pytest

from huffman_codec_tpu import formats as jformats
from huffman_codec_tpu.pyref import codec as jcodec
from huffman_codec_tpu.pyref import fgk as jfgk
from huffman_codec_tpu.pyref import rle as jrle

from huffman_codec_tpu_torch import formats
from huffman_codec_tpu_torch.pyref import codec, fgk, rle

CONFIGS = [(False, False), (True, False), (False, True), (True, True)]
IDS = ["none", "m", "a", "am"]


def _gradient(w: int, h: int, seed: int) -> bytes:
    """A smooth gradient with noise and a flat patch: runs for the RLE,
    skewed symbols for the FGK coder."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = (x * 2 + y * 3) // 5 + rng.integers(-2, 3, (h, w))
    img[h // 4: h // 2, w // 4: w // 2] = 9
    return (img & 255).astype(np.uint8).tobytes()


def _runs(n: int, seed: int) -> bytes:
    """Runs of every length around the MNP-5 limits (3, 258, 516)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([int(rng.integers(0, 4))]) * int(
            rng.choice([1, 2, 3, 4, 257, 258, 259, 516, 600]))
    return bytes(out[:n])


@pytest.mark.parametrize("use_diff,use_adapt", CONFIGS, ids=IDS)
def test_compress_equals_jax(use_diff, use_adapt):
    data = _gradient(64, 96, 1)
    blob = codec.compress(data, use_diff, use_adapt, 64)
    assert blob == jcodec.compress(data, use_diff, use_adapt, 64)
    assert codec.decompress(blob) == data
    assert jcodec.decompress(blob) == data


@pytest.mark.parametrize("n", [0, 1, 3, 4, 600, 4096])
def test_rle_equals_jax(n):
    data = _runs(n, n)
    enc = rle.rle_encode(data)
    assert enc == jrle.rle_encode(data)
    assert rle.rle_decode(enc) == jrle.rle_decode(enc)
    assert bytes(rle.rle_decode(enc)[0]) == data


@pytest.mark.parametrize("w,h", [(64, 64), (40, 24), (8, 8)])
def test_adapt_rle_equals_jax(w, h):
    data = _gradient(w, h, w + h)
    enc = rle.adapt_rle_encode(data, w, h)
    assert enc == jrle.adapt_rle_encode(data, w, h)
    assert rle.adapt_rle_decode(enc) == jrle.adapt_rle_decode(enc)
    assert bytes(rle.adapt_rle_decode(enc)) == data


def test_adapt_rle_errors_equal_jax():
    """The three broken payloads of the reference's exit codes 13-15."""
    hdr = struct.pack(">QQQ", 8, 8, 8) + b"\x80"
    for payload in (hdr + b"AAA" + bytes([200]), hdr + b"AB",
                    hdr + bytes(range(64)) + b"ZZ"):
        with pytest.raises(ValueError) as got:
            rle.adapt_rle_decode(payload)
        with pytest.raises(ValueError) as want:
            jrle.adapt_rle_decode(payload)
        assert str(got.value) == str(want.value)


def test_fgk_tree_state_equals_jax():
    data = _gradient(32, 32, 3) + bytes(range(256)) * 2
    a, b = fgk.FGKTree(), jfgk.FGKTree()
    for sym in data:
        assert a.encode(sym) == b.encode(sym)
        a.update(sym)
        b.update(sym)
    for name in jfgk.FGKTree.__slots__:
        assert getattr(a, name) == getattr(b, name), name
    bits = fgk.fgk_encode(data)
    assert bits == jfgk.fgk_encode(data)
    assert fgk.fgk_decode(bits, len(data)) == data


def test_v1_formats_equal_jax():
    bits = [int(b) for b in np.random.default_rng(4).integers(0, 2, 1237)]
    packed = formats.pack_bits_msb(bits)
    assert packed == jformats.pack_bits_msb(bits)
    assert formats.unpack_bits_msb(packed) == jformats.unpack_bits_msb(packed)
    dirs = [bool(b) for b in bits[:45]]
    hdr = formats.make_adapt_rle_header(72, 40, 8, dirs)
    assert hdr == jformats.make_adapt_rle_header(72, 40, 8, dirs)
    assert formats.parse_adapt_rle_header(hdr) == \
        jformats.parse_adapt_rle_header(hdr)
