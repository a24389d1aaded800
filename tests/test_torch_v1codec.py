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
