"""The port's device ``V1Codec`` against the JAX package's and the host
runtime's v1 encoder, on the CPU (the plain versions of the FGK kernels).

Its bytes equal JAX ``V1Codec``'s and native ``v1_compress``'s in the four
pipeline configs on a 64 x 64 image, and it decodes them exactly on its
device path (adaptive mode through the tile walk), as the host runtime
does. Every comparison is exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from huffman_codec_tpu.models import CodecConfig as JaxConfig  # noqa: E402
from huffman_codec_tpu.models import V1Codec as JaxV1Codec  # noqa: E402

from huffman_codec_tpu_torch import CodecConfig, V1Codec  # noqa: E402
from huffman_codec_tpu_torch.edge_cases import (  # noqa: E402
    adapt_v1_blob,
    broken_adapt_v1_blobs,
)
from huffman_codec_tpu_torch.native import runtime  # noqa: E402


def _image(w=64, h=64):
    y, x = np.mgrid[0:h, 0:w]
    img = ((x // 3 + y // 5) % 256).astype(np.uint8)
    img[10:20, 10:30] = 7
    return img.tobytes()


@pytest.mark.parametrize("use_diff,use_adapt",
                         [(False, False), (True, False), (False, True),
                          (True, True)], ids=["none", "m", "a", "am"])
def test_v1codec_equals_jax_and_native(use_diff, use_adapt):
    data = _image()
    codec = V1Codec(CodecConfig(use_diff=use_diff, use_adapt=use_adapt,
                                width=64), device="cpu")
    blob = codec.encode(data)
    assert blob == JaxV1Codec(JaxConfig(use_diff=use_diff,
                                        use_adapt=use_adapt,
                                        width=64)).encode(data)
    assert blob == runtime.v1_compress(data, use_diff, use_adapt, 64)
    assert codec.decode(blob) == data
    assert runtime.v1_decompress(blob) == data


def test_v1codec_empty_and_invalid():
    codec = V1Codec(CodecConfig(use_adapt=True, width=64), device="cpu")
    assert codec.encode(b"") == JaxV1Codec(
        JaxConfig(use_adapt=True, width=64)).encode(b"")
    assert codec.decode(codec.encode(b"")) == b""
    with pytest.raises(ValueError):
        codec.encode(b"x" * 100)  # size % width != 0
    with pytest.raises(ValueError):  # 16 symbols cannot fit one byte
        V1Codec(device="cpu").decode(b"\x10" + bytes(7) + b"\x00g")


def test_v1codec_default_device_is_cuda():
    if torch.cuda.is_available():
        assert V1Codec().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            V1Codec()


BROKEN = broken_adapt_v1_blobs()


@pytest.mark.parametrize("code", list(BROKEN))
def test_v1codec_broken_adaptive_payloads_raise(code):
    """The reference's errors (exit codes 13-15), as the host runtime and
    pyref raise them."""
    blob, message = BROKEN[code]
    with pytest.raises(ValueError, match=message):
        V1Codec(device="cpu").decode(blob)
    with pytest.raises(runtime.NativeError, match=message):
        runtime.v1_decompress(blob)


def test_v1codec_mutated_adaptive_payloads_equal_pyref():
    """Adaptive payloads of a few tiles cut short, extended or with one
    byte changed: the device decode returns the JAX package's pyref's
    bytes or raises its message, tile after tile in the reference's order,
    and the host runtime agrees."""
    from huffman_codec_tpu.pyref import codec as py
    from huffman_codec_tpu.pyref import rle

    rng = np.random.default_rng(5)
    seen = set()
    for _ in range(40):
        w, h = (int(v) for v in rng.integers(8, 24, 2))
        matrix = rng.integers(0, 3, w * h).astype(np.uint8).tobytes()
        p = bytearray(rle.adapt_rle_encode(matrix, w, h))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            p = p[:int(rng.integers(len(p) - 20, len(p)))]
        elif kind == 1:
            p += bytes([int(rng.integers(0, 256))])
        else:
            p[int(rng.integers(len(p) - 20, len(p)))] = int(
                rng.integers(0, 256))
        blob = adapt_v1_blob(bytes(p))
        try:
            want = py.decompress(blob)
        except ValueError as e:
            want = str(e)
        try:
            got = V1Codec(device="cpu").decode(blob)
        except ValueError as e:
            got = str(e)
        try:
            host = runtime.v1_decompress(blob)
        except runtime.NativeError as e:
            host = str(e)
        assert got == want
        assert host == want
        seen.add(want if isinstance(want, str) else "decoded")
    assert len(seen) >= 3, seen


def test_group_walk_reports_decoded_sizes():
    """The walk's second output: each tile's decoded size as walked, its
    size on a valid stream."""
    from huffman_codec_tpu_torch.ops import kernels as K
    from huffman_codec_tpu_torch.ops.adapt import _tile_geom_arrays
    from huffman_codec_tpu_torch.pyref import rle

    matrix = _image(40, 24)
    p = rle.adapt_rle_encode_fixed(matrix, 40, 24, 8)
    body = torch.frombuffer(bytearray(p[24 + 2:]), dtype=torch.uint8)
    sizes = torch.from_numpy(_tile_geom_arrays(40, 24, 8))
    lens, dec = K.group_tile_lens(body, torch.zeros(1, dtype=torch.int32),
                                  sizes, len(body), len(body),
                                  with_decoded=True)
    assert torch.equal(dec, sizes) and int(lens.sum()) == len(body)
    assert torch.equal(lens, K.group_tile_lens(
        body, torch.zeros(1, dtype=torch.int32), sizes, len(body),
        len(body)))
    lens, dec = K.group_tile_lens(body[:-3], torch.zeros(1, dtype=torch.int32),
                                  sizes, len(body) - 3, len(body) - 3,
                                  with_decoded=True)
    assert int(dec[-1]) < int(sizes[-1]) and torch.equal(dec[:-1], sizes[:-1])
