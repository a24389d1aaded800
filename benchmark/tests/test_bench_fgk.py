"""The reference of the v3 FGK sharded container (``reference/v3_fgk``)
against the port's own FGK path on the CPU (the plain versions of the
kernels): a sound container judges 0, and each fault judges more. The
reference's FGK successor search is held equal to the DFS it replaced."""

from __future__ import annotations

import struct

import numpy as np
import pytest

from benchmark import reference
from benchmark.core import cells, loop, traffic
from benchmark.reference import fgk, v3_fgk
from benchmark.tests.conftest import SEED

CHUNK = 1024  # the port's plain FGK loop runs once a symbol: keep it short
N_CHUNKS = 6


class DFSTree(fgk.FGKTree):
    """The successor search as the reference's pruned DFS
    (huffman.cpp:157-184), as the frozen copy had it."""

    def _find_succ_slot(self, f: int) -> int:
        def dfs(k: int) -> int:
            if not self.is_leaf(k) and self.freq[k] > f:
                lo, hi = dfs(self.left[k]), dfs(self.right[k])
                if lo != fgk.NIL and hi != fgk.NIL:
                    return min(lo, hi)
                return lo if lo != fgk.NIL else hi
            return k if self.freq[k] == f else fgk.NIL

        return dfs(0)


def _dfs_encode(data: bytes) -> list[int]:
    tree, bits = DFSTree(), []
    for sym in data:
        bits.extend(tree.encode(sym))
        tree.update(sym)
    return bits


@pytest.mark.parametrize("kind", ["uniform", "geometric", "few", "runs",
                                  "bulk"])
def test_successor_scan_equals_the_dfs(kind):
    rng = np.random.default_rng(list(kind.encode()))
    streams = []
    for _ in range(6):
        n = int(rng.integers(1, 1500))
        if kind == "uniform":
            s = rng.integers(0, 256, n)
        elif kind == "geometric":
            s = np.minimum(rng.geometric(rng.uniform(0.02, 0.9), n), 255)
        elif kind == "few":
            s = rng.integers(0, int(rng.integers(1, 12)), n)
        elif kind == "runs":
            s = np.repeat(rng.integers(0, 256, n), rng.integers(1, 9, n))[:n]
        else:
            s = _bulk_object()[:n]
        streams.append(bytes(np.asarray(s, np.uint8)))
    for s in streams:
        assert fgk.fgk_encode(s) == _dfs_encode(s)


def _bulk_object() -> np.ndarray:
    """Bytes of the bulk mix's data models (gradients with noise and a
    random block), made on the CPU."""
    mix = cells.find_cell("sharded-m.bulk").mix
    mix["objects"].update(min_bytes=1 << 16, max_bytes=1 << 17)
    mix["data"][0]["random_block_max"] = CHUNK
    return traffic.build(mix, SEED, CHUNK).objects[-1]


def _cfg(use_diff: bool, entropy: str = "fgk") -> dict:
    return dict(layout="sharded", entropy=entropy, chunk_size=CHUNK,
                lane=512, use_diff=use_diff, step_chunks=4)


@pytest.fixture(scope="module", params=[True, False], ids=["diff",
                                                           "nodiff"])
def made(request):
    """(config, input of 6 chunks with a short tail, the port's FGK
    container of it, the codec)."""
    from huffman_codec_tpu_torch import CodecConfig, TorchCodec

    cfg = _cfg(request.param)
    codec = TorchCodec(CodecConfig(**cfg), device="cpu")
    x = _bulk_object()[: N_CHUNKS * CHUNK - 300]
    return cfg, x, codec.encode(x.tobytes()), codec


def _judge(blob, x, cfg):
    got = reference.judge_encode(blob, x, cfg, "cpu",
                                 rng=np.random.default_rng(SEED),
                                 name="v3_fgk")
    assert got["bad_tables"] == 0 and got["v1"] == 0
    return got["bad_bytes"]


def test_sound_container_judges_0(made):
    cfg, x, blob, _ = made
    assert v3_fgk.chunks_judged(N_CHUNKS, np.random.default_rng(1)) == list(
        range(N_CHUNKS))  # every chunk, the short tail too
    assert _judge(blob, x, cfg) == 0
    got = v3_fgk.sizes(blob)
    bits = np.frombuffer(blob, "<u4", N_CHUNKS, 43)
    assert got == {"rle_bytes": struct.unpack_from("<Q", blob, 19)[0],
                   "payload_bytes": len(blob) - 43 - 9 * N_CHUNKS,
                   "out_bytes": len(x),
                   "code_bits": int(bits.sum())}


def _streams(blob):
    """(bit counts, each chunk's stream offset and bytes) of a container."""
    bits = np.frombuffer(blob, "<u4", N_CHUNKS, 43).astype(np.int64)
    nb = (bits + 7) // 8
    return bits, 43 + 9 * N_CHUNKS + np.cumsum(nb) - nb, nb


def _payload_byte(blob, x, codec):
    b = bytearray(blob)
    b[(43 + 9 * N_CHUNKS + len(b)) // 2] ^= 0x04
    return bytes(b), x


def _bit_count(blob, x, codec):
    """A chunk's bit count one less, in the same whole bytes."""
    bits, _, _ = _streams(blob)
    c = next(c for c in range(N_CHUNKS) if bits[c] % 8 != 1)
    b = bytearray(blob)
    struct.pack_into("<I", b, 43 + 4 * c, int(bits[c]) - 1)
    return bytes(b), x


def _streams_swapped(blob, x, codec):
    """Chunks 1 and 2 exchange their streams and bit counts, so that the
    container keeps its shape."""
    bits, at, nb = _streams(blob)
    s1 = blob[at[1]: at[1] + nb[1]]
    s2 = blob[at[2]: at[2] + nb[2]]
    b = bytearray(blob[: at[1]] + s2 + s1 + blob[at[2] + nb[2]:])
    struct.pack_into("<II", b, 43 + 4, int(bits[2]), int(bits[1]))
    assert len(b) == len(blob) and bytes(b) != blob
    return bytes(b), x


def _input_bit(blob, x, codec):
    y = x.copy()
    y[len(y) // 3] ^= 1
    return blob, y


def _canonical(blob, x, codec):
    from huffman_codec_tpu_torch import CodecConfig, TorchCodec

    other = TorchCodec(CodecConfig(**_cfg(codec.config.use_diff,
                                          "canonical")), device="cpu")
    return other.encode(x.tobytes()), x


def _lsb(blob, x, codec):
    return loop.Lossy(codec).encode(x.tobytes()), x


@pytest.mark.parametrize("fault", [_payload_byte, _bit_count,
                                   _streams_swapped, _input_bit, _canonical,
                                   _lsb], ids=lambda f: f.__name__[1:])
def test_fault_judges_more_than_0(made, fault):
    cfg, x, blob, codec = made
    bad, data = fault(blob, x, codec)
    assert _judge(bad, data, cfg) > 0


def test_chunks_judged_by_the_seed():
    a = v3_fgk.chunks_judged(2048, np.random.default_rng([SEED, 19, 4]))
    assert a == v3_fgk.chunks_judged(2048, np.random.default_rng(
        [SEED, 19, 4]))
    assert len(set(a)) == v3_fgk.CHUNKS_JUDGED and a == sorted(a)
    assert a[0] == 0 and a[-1] == 2047
    assert a != v3_fgk.chunks_judged(2048, np.random.default_rng(
        [SEED, 19, 5]))


def test_refuses_what_it_cannot_judge():
    v3_fgk.check(_cfg(True))
    for bad in ({"layout": "global"}, {"entropy": "canonical"},
                {"use_adapt": True}):
        with pytest.raises(ValueError):
            v3_fgk.check({**_cfg(True), **bad})
