"""The port's global layout against the JAX package's, on the CPU: the
fat-lane decode's plain version against the Pallas kernel in interpret
mode and the XLA decoder, each best-of-two candidate and the whole
``encode()`` byte-equal with ``TPUCodec``, and each package decoding the
other's blobs, v1 included.

Integer codec: every comparison is exact bytes. Inputs come from numpy
with fixed seeds. Inputs stay under 100 KB, because the plain decode loops
once per symbol of a lane (8192 to 16384 here), and the JAX shapes are few
and all in this module, because every (length, config) pair compiles its
own XLA stages.
"""

import dataclasses
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from huffman_codec_tpu.models import chunked as jch  # noqa: E402
from huffman_codec_tpu.native import runtime as jax_native  # noqa: E402
from huffman_codec_tpu.ops import canonical as jcan  # noqa: E402
from huffman_codec_tpu.ops import pallas_kernels as jpk  # noqa: E402
from huffman_codec_tpu_torch import CodecConfig, TorchCodec, config_from_fields  # noqa: E402
from huffman_codec_tpu_torch.formats import V3_MAGIC  # noqa: E402
from huffman_codec_tpu_torch.native import runtime as port_native  # noqa: E402
from huffman_codec_tpu_torch.ops import canonical as tcan  # noqa: E402
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402

N = 40000


def _gradient(n, seed):
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    return (((i // 512) * 2 + (i % 512) // 3 + rng.integers(-2, 3, n))
            & 255).astype(np.uint8)


def _inputs():
    rng = np.random.default_rng(31)
    # ten 4096-byte stretches, each over its own 16 symbols: one table for
    # the whole stream pays ~7 bits a symbol, a table per chunk ~4
    drift = np.concatenate([rng.integers(16 * k, 16 * k + 16, 4096)
                            for k in range(10)])[:N]
    return {
        "gradient": _gradient(N, 3).tobytes(),
        "random": rng.integers(0, 256, N, dtype=np.uint8).tobytes(),
        "drift": drift.astype(np.uint8).tobytes(),
        "random70k": rng.integers(0, 256, 70000, dtype=np.uint8).tobytes(),
        "empty": b"",
    }


INPUTS = _inputs()


def _port(jcfg):
    return TorchCodec(config_from_fields(dataclasses.asdict(jcfg)),
                      device="cpu")


# -- the fat-lane decode ------------------------------------------------------

LANE = 2048  # a fat-lane geometry small enough for interpret mode


@pytest.fixture(scope="module")
def fat():
    """One chunk of 8 lanes with a partial last lane, encoded by the JAX
    package and re-padded to the decoder's fixed stride."""
    rng = np.random.default_rng(2024)
    data = rng.integers(0, 200, 6 * LANE, dtype=np.uint8)
    data[3000:7000] = 9
    n, L = 5 * LANE + 321, 8 * LANE
    mat = np.zeros((1, L), np.uint8)
    mat[0, :data.size] = data
    lens = np.array([n], np.int32)
    buf, lane_words, tables = jcan.canonical_encode_batch(
        jnp.asarray(mat), jnp.asarray(lens), lane=LANE)
    buf, lw = np.asarray(buf), np.asarray(lane_words)
    W = buf.shape[2]
    col = np.arange(W)
    words = np.where(col[None, None, :] < lw[:, :, None], buf, 0).astype(
        np.uint32)
    return dict(words=words, tables=np.array(tables), lw=lw, n=n, L=L, W=W,
                want=mat[0, :n])


@pytest.mark.parametrize("C,nl", [(1, 8), (2, 4)], ids=["1x8", "rebatched2x4"])
def test_lanemajor_plain_matches_pallas_interpret(fat, C, nl):
    words = fat["words"].reshape(C, nl, fat["W"])
    tables = np.tile(fat["tables"], (C, 1))
    lens = np.clip(fat["n"] - np.arange(C) * (fat["L"] // C), 0,
                   fat["L"] // C).astype(np.int32)
    want = np.asarray(jpk.lane_decode_lanemajor(
        jnp.asarray(words), jnp.asarray(tables), jnp.asarray(lens),
        lane=LANE, interpret=True))
    got = K.lane_decode_lanemajor(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(tables),
        torch.from_numpy(lens), LANE, 31).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(-1)[: fat["n"]], fat["want"])


def test_lanemajor_plain_matches_xla_decoder(fat):
    lens = np.array([fat["n"]], np.int32)
    flat = fat["words"].reshape(1, -1)
    want = np.asarray(jcan.canonical_decode_batch(
        jnp.asarray(flat), jnp.asarray(fat["tables"]), jnp.asarray(fat["lw"]),
        jnp.asarray(lens), lane=LANE, out_len=fat["L"]))
    got = K.lane_decode_lanemajor_plain(
        torch.from_numpy(fat["words"].view(np.int32)),
        torch.from_numpy(fat["tables"]), torch.from_numpy(lens), LANE, 31)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_batch_sends_fat_lanes_to_the_lanemajor_kernel(monkeypatch):
    seen = []
    for name in ("lane_decode", "lane_decode_lanemajor"):
        monkeypatch.setattr(
            K, name, lambda buf, lt, ln, lane, max_len, _n=name: (
                seen.append(_n), torch.zeros((buf.shape[0], buf.shape[1] * lane),
                                             dtype=torch.uint8))[1])
    for lane in (512, 4096, 8192, 32768):
        tcan.canonical_decode_batch(
            torch.zeros((1, 2 * 8), dtype=torch.int32),
            torch.zeros((1, 256), dtype=torch.uint8),
            torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), lane=lane, out_len=lane)
    assert seen == ["lane_decode", "lane_decode", "lane_decode_lanemajor",
                    "lane_decode_lanemajor"]


def test_lanemajor_wrapper_rejects_bad_geometry():
    buf = torch.zeros((1, 1, 8), dtype=torch.int32)
    lt = torch.zeros((1, 256), dtype=torch.uint8)
    ln = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        K.lane_decode_lanemajor(buf, lt, ln, 8200, 31)
    with pytest.raises(ValueError):
        K.lane_decode_lanemajor(buf, lt, ln, 8192, 32)


# -- each candidate alone -----------------------------------------------------

CAND = [(k, d, w) for k in ("gradient", "random") for d in (False, True)
        for w in (True, False)]


@pytest.mark.parametrize(
    "kind,use_diff,whole", CAND,
    ids=[f"{k}-{'diff' if d else 'nodiff'}-{'whole' if w else 'chunked'}"
         for k, d, w in CAND])
def test_candidate_is_byte_equal_to_jax(kind, use_diff, whole):
    jcfg = jch.CodecConfig(use_diff=use_diff)
    want = jch.TPUCodec(jcfg)._encode_global(INPUTS[kind], None, whole)
    got = _port(jcfg)._encode_global(INPUTS[kind], None, whole)
    assert len(got) == len(want)
    assert got == want
    hdr = TorchCodec._parse(got)
    assert (hdr["n_chunks"], hdr["lane"]) == ((1, 8192) if whole
                                              else (1, 2048))


# -- the whole encode() --------------------------------------------------------

# name -> (input, JAX config, what wins: (format, chunk_size, lane))
PATHS = {
    "whole_file_wins": ("gradient", jch.CodecConfig(), ("v3", 65536, 8192)),
    "chunked_wins": ("drift", jch.CodecConfig(chunk_size=4096),
                     ("v3", 4096, 2048)),
    "v1_wins_race": ("gradient", jch.CodecConfig(use_diff=True), ("v1",)),
    "above_race_gate": ("random70k", jch.CodecConfig(),
                        ("v3", 131072, 16384)),
    "whole_file_off": ("gradient", jch.CodecConfig(whole_file=False),
                       ("v3", 65536, 512)),
    "empty": ("empty", jch.CodecConfig(use_diff=True), ("v3", 65536, 512)),
}


@pytest.fixture(scope="module")
def jax_blobs():
    return {name: jch.TPUCodec(jcfg).encode(INPUTS[kind])
            for name, (kind, jcfg, _) in PATHS.items()}


@pytest.mark.parametrize("name", list(PATHS))
def test_encode_is_byte_equal_to_jax(jax_blobs, name):
    kind, jcfg, wins = PATHS[name]
    got = _port(jcfg).encode(INPUTS[kind])
    want = jax_blobs[name]
    assert len(got) == len(want)
    assert got == want
    if wins[0] == "v1":
        assert got[:6] != V3_MAGIC
        count, flags = struct.unpack("<QB", got[:9])
        assert flags == 0x80 and count <= 8 * (len(got) - 9)
    else:
        hdr = TorchCodec._parse(got)
        assert (hdr["chunk_size"], hdr["lane"]) == wins[1:]
        assert not hdr["flags"] & 0x20  # not the sharded layout


def test_race_gate_is_the_container_size(jax_blobs):
    # 70000 random bytes are under the 1 MiB input gate; it is the v3
    # container above 64 KiB that keeps the v1 race from running
    assert len(INPUTS["random70k"]) <= TorchCodec._V1_RACE_MAX_IN
    assert len(jax_blobs["above_race_gate"]) > TorchCodec._V1_RACE_MAX_OUT


@pytest.mark.parametrize("name", list(PATHS))
def test_port_decodes_jax_blob(jax_blobs, name):
    kind, jcfg, _ = PATHS[name]
    assert _port(jcfg).decode(jax_blobs[name]) == INPUTS[kind]


@pytest.mark.parametrize("name", ["whole_file_wins", "chunked_wins",
                                  "v1_wins_race", "whole_file_off", "empty"])
def test_jax_decodes_port_blob(name):
    kind, jcfg, _ = PATHS[name]
    blob = _port(jcfg).encode(INPUTS[kind])
    assert jch.TPUCodec(jcfg).decode(blob) == INPUTS[kind]


def test_default_config_is_the_global_layout():
    codec = TorchCodec(device="cpu")
    assert codec.config == CodecConfig()
    assert dataclasses.asdict(codec.config) == dataclasses.asdict(
        jch.TPUCodec().config)


# -- v1 and v2 blobs through the port's own host runtime -----------------------


@pytest.mark.parametrize("use_diff", [False, True], ids=["nodiff", "diff"])
def test_native_v1_matches_the_jax_packages_runtime(use_diff):
    data = INPUTS["gradient"][:8192]
    blob = port_native.v1_compress(data, use_diff)
    assert blob == jax_native.v1_compress(data, use_diff)
    assert TorchCodec(device="cpu").decode(blob) == data
    assert jax_native.v1_decompress(blob) == data


def test_port_decodes_v2_blob():
    data = INPUTS["gradient"][:20000]
    blob = jax_native.v2_compress(data, use_diff=True, chunk_size=4096)
    assert TorchCodec(device="cpu").decode(blob) == data


def test_port_loads_its_own_native_library():
    lib = port_native.build()
    assert lib == port_native.library_path() and lib.exists()
    assert "huffman_codec_tpu" not in lib.parts
    assert lib.parent.name == "torch_native"


def test_v1_header_is_checked_before_the_native_decoder(monkeypatch):
    codec = TorchCodec(device="cpu")
    monkeypatch.setattr(port_native, "v1_decompress", lambda blob: pytest.fail(
        "the native decoder was given an inconsistent blob"))
    with pytest.raises(ValueError, match="header"):
        codec.decode(b"\x05\x00\x00")  # shorter than the header
    with pytest.raises(ValueError, match="contents"):
        # 1000 symbols cannot come out of two payload bytes
        codec.decode(struct.pack("<QB", 1000, 0) + b"\xff\xff")


# -- corrupt containers ---------------------------------------------------------


@pytest.fixture(scope="module")
def port_blob():
    return _port(jch.CodecConfig()).encode(INPUTS["gradient"])


def test_corrupt_crc_raises(port_blob):
    blob = bytearray(port_blob)
    blob[39] ^= 0x01  # the header's crc32 field
    with pytest.raises(ValueError, match="crc32"):
        TorchCodec(device="cpu").decode(bytes(blob))


def test_wrong_orig_raises(port_blob):
    blob = bytearray(port_blob)
    blob[11:19] = struct.pack("<Q", N - 1)
    with pytest.raises(ValueError, match="size mismatch"):
        TorchCodec(device="cpu").decode(bytes(blob))


def test_sharded_only_entry_points_refuse_global_containers(port_blob):
    codec = TorchCodec(device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        codec.decode_range(port_blob, 0, 10)
    with pytest.raises(ValueError, match="sharded"):
        codec.stage_decode_steps(port_blob)
    with pytest.raises(ValueError, match="sharded"):
        codec.encode_chunk_range(INPUTS["gradient"], 0, 1)
