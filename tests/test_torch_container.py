"""The port's v3 container I/O against the JAX package's: the parser reads
JAX-made containers, and the port's own of every kind (global whole-file,
chunked and adaptive, sharded adaptive, FGK, table widths 4 and 5,
lane-word widths 8 and not 8, lane 100), into the same fields without
reading the payload, the fields re-serialise byte-equal, and the manifest
helpers agree."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from huffman_codec_tpu.models import chunked as jch  # noqa: E402
from huffman_codec_tpu.ops.pallas_kernels import lane_words_cap as jax_lwc  # noqa: E402
from huffman_codec_tpu.ops.rle import rle_max_encoded_len as jax_rmel  # noqa: E402
from huffman_codec_tpu_torch import CodecConfig, TorchCodec, config_from_fields  # noqa: E402
from huffman_codec_tpu_torch.edge_cases import (  # noqa: E402
    ODD_CONFIGS, odd_config_input)
from huffman_codec_tpu_torch.models import chunked as tch  # noqa: E402
from huffman_codec_tpu_torch.models.entropy import lookup  # noqa: E402
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


def _gradient(rng, h, w, noise):
    y, x = np.mgrid[:h, :w]
    return ((x + 2 * y + rng.integers(-noise, noise + 1, (h, w))) & 255
            ).astype(np.uint8).tobytes()


def _fibonacci(rng):
    """22 symbols whose counts are the Fibonacci numbers (46,367 bytes),
    each spread evenly so that no two neighbours are equal and the RLE
    keeps the histogram: the deepest code is 21 bits, a 5-bit table."""
    c = [1, 1]
    while len(c) < 22:
        c.append(c[-1] + c[-2])
    pos = np.concatenate([(np.arange(n) + rng.random()) / n for n in c])
    sym = np.repeat(np.arange(22) * 11, c)
    return sym[np.argsort(pos, kind="stable")].astype(np.uint8).tobytes()


# the port's containers of each kind: (CodecConfig fields, input, what
# encodes it: None for encode(), else the global candidate's ``whole``
# flag or the adaptive block size, which skip the v1 race), and the
# container's table width and whether its lane-word width is 8
PORT_KINDS = {
    "global_whole": (dict(use_diff=True), (_gradient, 96, 128, 2), True,
                     (4, False)),
    "global_chunked": (dict(use_diff=True, chunk_size=4096),
                       (_gradient, 96, 128, 2), False, (4, True)),
    "global_adapt": (dict(use_diff=True, use_adapt=True, width=64),
                     (_gradient, 64, 64, 1), 8, (4, True)),
    "global_adapt_grouped": (dict(use_diff=True, use_adapt=True, width=128),
                             (_gradient, 128, 128, 2), 4, (4, True)),
    "sharded_adapt": (dict(use_diff=True, use_adapt=True, width=64,
                           chunk_size=1024, lane=64, layout="sharded"),
                      (_gradient, 69, 64, 3), None, (4, False)),
    "fgk": (dict(use_diff=True, entropy="fgk", layout="sharded",
                 chunk_size=2048), (_gradient, 40, 100, 2), None, None),
    "table_width_5": (dict(use_diff=False, layout="sharded",
                           chunk_size=65536), (_fibonacci,), None,
                      (5, False)),
    "random_bytes": (dict(use_diff=False, layout="sharded", chunk_size=4096),
                     (lambda rng: rng.integers(0, 256, 3 * 4096 + 77,
                                               dtype=np.uint8).tobytes(),),
                     None, (4, True)),
    "lane_100": (dict(use_diff=True, **ODD_CONFIGS["sharded-1000-100"]),
                 (lambda rng: odd_config_input("sharded-1000-100"),), None,
                 (4, False)),
}


@pytest.fixture(scope="module")
def port_blobs():
    out, rng = {}, np.random.default_rng(18)
    for kind, (fields, (make, *args), how, _) in PORT_KINDS.items():
        codec = TorchCodec(CodecConfig(**fields), device="cpu")
        data = make(rng, *args)
        if how is None:
            out[kind] = codec.encode(data)
        elif isinstance(how, bool):
            out[kind] = codec._encode_global(data, None, how)
        else:
            out[kind] = codec._encode_global(data, how, False)
    return out


def _same_field(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and (a == b).all()
    return a == b


@pytest.mark.parametrize("kind", ["diff", "nodiff", "empty", *PORT_KINDS])
def test_parse_matches_jax(blobs, port_blobs, kind):
    blob = blobs[kind] if kind in blobs else port_blobs[kind]
    if kind in PORT_KINDS:
        widths = PORT_KINDS[kind][3]
        if widths is not None:  # the kind this case stands for
            assert (blob[9], blob[10] == 8) == widths
    want = jch.TPUCodec._parse(blob)
    got = tch.TorchCodec._parse(blob)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _same_field(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["diff", "empty", *PORT_KINDS])
def test_parse_reads_no_payload_byte(blobs, port_blobs, kind):
    """The container cut at ``payload_off`` parses to the same fields: the
    parse reads the manifest alone, where it lies."""
    blob = blobs[kind] if kind in blobs else port_blobs[kind]
    whole = tch.TorchCodec._parse(blob)
    assert whole["payload_off"] < len(blob) or kind == "empty"
    cut = tch.TorchCodec._parse(memoryview(blob)[: whole["payload_off"]])
    assert sorted(cut) == sorted(whole)
    for k in whole:
        assert _same_field(cut[k], whole[k]), k


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


@pytest.mark.parametrize("width", range(1, 33))
def test_packk_unpackk_match_jax(width):
    vals = RNG.integers(0, 1 << width, 301)
    assert tch._packk(vals, width) == jch._packk(vals, width)
    raw = jch._packk(vals, width)
    got = tch._unpackk(raw, 301, width)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, jch._unpackk(raw, 301, width))
    np.testing.assert_array_equal(got, vals)


@pytest.mark.parametrize("width", range(1, 33))
@pytest.mark.parametrize("count", [1, 8, 77, 1000])
def test_unpackk_at_an_unaligned_offset(width, count):
    """Fields read at an odd byte offset inside a longer buffer equal the
    JAX unpacker's on the bytes sliced out."""
    raw = jch._packk(RNG.integers(0, 1 << width, count), width)
    head = RNG.integers(0, 256, 13, dtype=np.uint8).tobytes()
    tail = RNG.integers(0, 256, 9, dtype=np.uint8).tobytes()
    got = tch._unpackk(head + raw + tail, count, width, len(head))
    assert got.dtype == np.int64 and got.shape == (count,)
    np.testing.assert_array_equal(got, jch._unpackk(raw, count, width))


@pytest.mark.parametrize("width", [1, 5, 7, 8, 12, 25, 26, 32])
@pytest.mark.parametrize("count", [3, 16, 301])
def test_unpackk_reads_no_byte_past_its_fields(width, count):
    """A buffer that ends at the fields' last byte suffices, the bytes after
    it change nothing, and one byte fewer is refused."""
    vals = RNG.integers(0, 1 << width, count)
    raw = jch._packk(vals, width)
    assert len(raw) == (count * width + 7) // 8
    exact = tch._unpackk(b"\x5a\xa5" + raw, count, width, 2)
    np.testing.assert_array_equal(exact, vals)
    for pad in (b"\x00" * 8, b"\xff" * 8):
        np.testing.assert_array_equal(
            tch._unpackk(b"\x5a\xa5" + raw + pad, count, width, 2), vals)
    with pytest.raises(ValueError):
        tch._unpackk(b"\x5a\xa5" + raw[:-1], count, width, 2)


def test_size_helpers_match_jax():
    for n in (0, 1, 3, 4096, 65536, 1 << 20):
        assert rle_max_encoded_len(n) == jax_rmel(n)
    for lane in (64, 128, 512, 2048, 32768):
        assert lane_words_cap(lane) == jax_lwc(lane)
        for cs in (4096, 65536):
            assert (lookup("canonical").cap(cs, lane)
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
    CodecConfig(layout="sharded", entropy="huffman"),
])
def test_unsupported_configs_raise(cfg):
    # FGK entropy is supported (test_fgk_config_and_container_supported);
    # an unknown entropy mode still raises
    with pytest.raises(ValueError, match="unknown entropy"):
        TorchCodec(cfg, device="cpu")


@pytest.mark.parametrize("layout", ["sharded", "global"])
def test_fgk_config_and_container_supported(layout):
    codec = TorchCodec(CodecConfig(layout=layout, entropy="fgk"), "cpu")
    codec._check_supported({"flags": tch.FLAG_SHARDED, "entropy": 0})
    assert codec.decode(codec.encode(b"")) == b""


def test_invalid_configs_raise_value_error():
    with pytest.raises(ValueError):
        TorchCodec(CodecConfig(layout="sharded", chunk_size=1000), "cpu")
    with pytest.raises(ValueError):
        TorchCodec(CodecConfig(layout="bogus"), device="cpu")


def test_non_v3_input_raises():
    # v1 and v2 blobs go to the host runtime; malformed ones raise
    from huffman_codec_tpu_torch.native.runtime import NativeError

    codec = TorchCodec(device="cpu")
    with pytest.raises(ValueError):
        codec.decode(b"\x10" + bytes(7) + b"\x00g")  # 16 symbols in 1 byte
    with pytest.raises(NativeError):
        codec.decode(b"HCTPU\x02" + bytes(40))


@pytest.mark.parametrize("hdr", [
    {"flags": tch.FLAG_SHARDED, "entropy": 7},  # no such entropy mode
])
def test_unsupported_containers_raise(hdr):
    # an FGK header (entropy 0) passes: test_fgk_config_and_container_supported
    with pytest.raises(ValueError, match="unknown entropy"):
        TorchCodec(device="cpu")._check_supported(hdr)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert TorchCodec().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            TorchCodec()
