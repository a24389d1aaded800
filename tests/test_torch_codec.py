"""The port's sharded canonical codec against the JAX package's, on the
CPU: byte-equal containers for the same input and config, and each
package decodes the other's containers.

Small geometry (4096-byte chunks, 512-symbol lanes, 2 chunks per step,
so every non-empty input here spans several steps); every input is made
with numpy from a seed.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from huffman_codec_tpu.models import chunked as jch  # noqa: E402
from huffman_codec_tpu_torch import TorchCodec, config_from_fields  # noqa: E402

CS = 4096


def _gradient(n, seed):
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    return (((i // 512) * 2 + (i % 512) // 3 + rng.integers(-2, 3, n))
            & 255).astype(np.uint8)


def _inputs():
    rng = np.random.default_rng(5)
    mixed = np.concatenate([
        _gradient(CS, 1),                       # smooth gradient + noise
        rng.integers(0, 256, CS),               # incompressible chunk
        np.full(CS, 65),                        # single-symbol chunk
        np.r_[np.full(300, 4), np.full(700, 9), np.full(CS - 1000, 200)],
        _gradient(1234, 2),                     # partial tail chunk
    ]).astype(np.uint8)
    return {
        "mixed": mixed.tobytes(),
        "random": rng.integers(0, 256, 2 * CS + 777, dtype=np.uint8).tobytes(),
        "empty": b"",
    }


INPUTS = _inputs()


def _jcfg(use_diff):
    return jch.CodecConfig(use_diff=use_diff, chunk_size=CS, lane=512,
                           layout="sharded", step_chunks=2)


def _port(use_diff):
    cfg = config_from_fields(dataclasses.asdict(_jcfg(use_diff)))
    return TorchCodec(cfg, device="cpu")


@pytest.fixture(scope="module")
def jax_blobs():
    return {(k, d): jch.TPUCodec(_jcfg(d)).encode(v)
            for d in (False, True) for k, v in INPUTS.items()}


CASES = [(k, d) for d in (False, True) for k in INPUTS]
IDS = [f"{k}-{'diff' if d else 'nodiff'}" for k, d in CASES]


@pytest.mark.parametrize("kind,use_diff", CASES, ids=IDS)
def test_encode_is_byte_equal_to_jax(jax_blobs, kind, use_diff):
    got = _port(use_diff).encode(INPUTS[kind])
    want = jax_blobs[(kind, use_diff)]
    assert len(got) == len(want)
    assert got == want


@pytest.mark.parametrize("kind,use_diff", CASES, ids=IDS)
def test_port_decodes_jax_container(jax_blobs, kind, use_diff):
    assert _port(use_diff).decode(jax_blobs[(kind, use_diff)]) == INPUTS[kind]


@pytest.mark.parametrize("use_diff", [False, True], ids=["nodiff", "diff"])
def test_jax_decodes_port_container(use_diff):
    blob = _port(use_diff).encode(INPUTS["mixed"])
    assert jch.TPUCodec(_jcfg(use_diff)).decode(blob) == INPUTS["mixed"]


MIXED_LEN = len(INPUTS["mixed"])


@pytest.mark.parametrize("start,length", [
    (0, 100), (4000, 300), (4095, 2), (2 * CS, CS), (MIXED_LEN - 5, 5),
    (0, MIXED_LEN), (100, 0)])
def test_decode_range_of_jax_container(jax_blobs, start, length):
    blob = jax_blobs[("mixed", True)]
    got = _port(True).decode_range(blob, start, length)
    assert got == INPUTS["mixed"][start:start + length]


def test_decode_range_out_of_bounds():
    blob = _port(False).encode(INPUTS["random"])
    with pytest.raises(ValueError):
        _port(False).decode_range(blob, len(INPUTS["random"]) - 2, 3)


def test_step_size_does_not_change_the_container():
    data = INPUTS["mixed"]
    ref = _port(True).encode(data)
    for step in (1, 3, None):
        cfg = dataclasses.replace(_port(True).config, step_chunks=step)
        codec = TorchCodec(cfg, device="cpu")
        assert codec.encode(data) == ref
        assert codec.decode(ref) == data


def test_chunk_range_restarts_through_its_carry():
    # re-encoding chunks [2, 4) alone gives the same manifest rows and lane
    # buffers as the same step inside the full encode
    data = np.frombuffer(INPUTS["mixed"], np.uint8)
    codec = _port(True)
    full = codec.encode_chunk_range(data, 2, 4)
    alone = codec.encode_chunk_range(data[: 4 * CS].copy(), 2, 4)
    for a, b in zip(full, alone):
        assert torch.equal(a, b)
    assert int(full[4][0]) == int(data[2 * CS - 1])  # carry byte


def test_corrupt_payload_fails_crc():
    codec = _port(True)
    blob = bytearray(codec.encode(INPUTS["mixed"]))
    hdr = codec._parse(bytes(blob))
    blob[hdr["payload_off"]] ^= 0xFF
    with pytest.raises(ValueError, match="crc32"):
        codec.decode(bytes(blob))
