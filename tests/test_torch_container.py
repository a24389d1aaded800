"""The port's v3 container I/O against the JAX package's: the parser reads
JAX-made containers into the same fields, the fields re-serialise
byte-equal, and the manifest helpers agree."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from huffman_codec_tpu.models import chunked as jch  # noqa: E402
from huffman_codec_tpu.ops.pallas_kernels import lane_words_cap as jax_lwc  # noqa: E402
from huffman_codec_tpu.ops.rle import rle_max_encoded_len as jax_rmel  # noqa: E402
from huffman_codec_tpu_torch import CodecConfig, TorchCodec, config_from_fields  # noqa: E402
from huffman_codec_tpu_torch.models import chunked as tch  # noqa: E402
from huffman_codec_tpu_torch.ops.kernels import lane_words_cap  # noqa: E402
from huffman_codec_tpu_torch.ops.rle import rle_max_encoded_len  # noqa: E402

RNG = np.random.default_rng(77)


def _data(n):
    i = np.arange(n)
    x = ((i // 97) + (i % 31) + RNG.integers(0, 3, n)) & 255
    x[n // 3: n // 3 + 700] = 11  # long runs
    return x.astype(np.uint8).tobytes()


def _jcfg(use_diff):
    return jch.CodecConfig(use_diff=use_diff, chunk_size=4096, lane=512,
                           layout="sharded", step_chunks=2)


@pytest.fixture(scope="module")
def blobs():
    """JAX-made sharded containers: diff on, diff off (three steps with a
    partial tail chunk), and the empty container."""
    data = _data(4096 * 5 + 321)
    return {
        "diff": jch.TPUCodec(_jcfg(True)).encode(data),
        "nodiff": jch.TPUCodec(_jcfg(False)).encode(data),
        "empty": jch.TPUCodec(_jcfg(True)).encode(b""),
    }


def _same_field(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
    return a == b


@pytest.mark.parametrize("kind", ["diff", "nodiff", "empty"])
def test_parse_matches_jax(blobs, kind):
    want = jch.TPUCodec._parse(blobs[kind])
    got = tch.TorchCodec._parse(blobs[kind])
    assert sorted(got) == sorted(want)
    for k in want:
        assert _same_field(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["diff", "nodiff", "empty"])
def test_reserialise_is_byte_equal(blobs, kind):
    blob = blobs[kind]
    hdr = tch.TorchCodec._parse(blob)
    cfg = config_from_fields(dataclasses.asdict(_jcfg(kind != "nodiff")))
    codec = TorchCodec(cfg, device="cpu")
    sharded = (hdr["rle_lens"], hdr["carries"]) if hdr["n_chunks"] else None
    out = codec._container(blob[hdr["payload_off"]:], hdr["orig"],
                           hdr["total"], hdr["chunk_bits"],
                           hdr.get("tables"), hdr.get("lane_words"), sharded,
                           hdr["crc"], hdr["chunk_size"], hdr["lane"])
    assert out == blob


@pytest.mark.parametrize("width", [1, 3, 4, 5, 8, 13])
def test_packk_unpackk_match_jax(width):
    vals = RNG.integers(0, 1 << width, 301)
    assert tch._packk(vals, width) == jch._packk(vals, width)
    raw = jch._packk(vals, width)
    np.testing.assert_array_equal(tch._unpackk(raw, 301, width),
                                  jch._unpackk(raw, 301, width))


def test_size_helpers_match_jax():
    for n in (0, 1, 3, 4096, 65536, 1 << 20):
        assert rle_max_encoded_len(n) == jax_rmel(n)
    for lane in (64, 128, 512, 2048, 32768):
        assert lane_words_cap(lane) == jax_lwc(lane)
        for cs in (4096, 65536):
            assert (tch._sharded_cap(cs, "canonical", lane)
                    == jch._sharded_cap(cs, "canonical", lane))


def test_config_crosses_packages():
    jcfg = jch.CodecConfig(use_diff=True, chunk_size=65536, lane=512,
                           layout="sharded", step_chunks=256)
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.flags() == jcfg.flags()
    assert dataclasses.asdict(CodecConfig()) == dataclasses.asdict(
        jch.CodecConfig())
    with pytest.raises(ValueError):
        config_from_fields({"use_diff": True, "bogus": 1})


@pytest.mark.parametrize("cfg", [
    CodecConfig(),  # global layout
    CodecConfig(layout="sharded", use_adapt=True),
    CodecConfig(layout="sharded", entropy="fgk"),
])
def test_unsupported_configs_raise(cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchCodec(cfg, device="cpu")


def test_invalid_configs_raise_value_error():
    with pytest.raises(ValueError):
        TorchCodec(CodecConfig(layout="sharded", chunk_size=1000), "cpu")
    with pytest.raises(ValueError):
        TorchCodec(CodecConfig(layout="bogus"), device="cpu")


def test_non_v3_input_raises():
    codec = TorchCodec(device="cpu")
    with pytest.raises(NotImplementedError):
        codec.decode(b"\x10" + bytes(8) + b"\x00garbage")  # v1 header shape
    with pytest.raises(NotImplementedError):
        codec.decode(b"HCTPU\x02" + bytes(40))


@pytest.mark.parametrize("hdr", [
    {"flags": 0, "entropy": 1},  # global layout
    {"flags": tch.FLAG_SHARDED | tch.FLAG_ADAPT, "entropy": 1},
    {"flags": tch.FLAG_SHARDED, "entropy": 0},  # FGK
])
def test_unsupported_containers_raise(hdr):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchCodec(device="cpu")._check_supported(hdr)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert TorchCodec().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TorchCodec()
