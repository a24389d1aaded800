"""FGK entropy in the PyTorch port against the JAX package, on the CPU.

The plain FGK versions against ``fgk_encode_batch``/``fgk_decode_batch``,
the port's ``pack_codes`` against the JAX one, and FGK containers of
``TorchCodec(cfg, "cpu")`` byte-equal to ``TPUCodec(cfg)``'s and decoded
across the packages. Inputs are made with numpy from a seed; every
comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from huffman_codec_tpu.models import CodecConfig as JaxConfig  # noqa: E402
from huffman_codec_tpu.models import TPUCodec  # noqa: E402
from huffman_codec_tpu.ops import adapt as jad  # noqa: E402
from huffman_codec_tpu.ops.diff import diff_apply as jax_diff  # noqa: E402
from huffman_codec_tpu.ops import fgk as jfgk  # noqa: E402
from huffman_codec_tpu.ops import pack as jpack  # noqa: E402

from huffman_codec_tpu_torch import TorchCodec, config_from_fields  # noqa: E402
from huffman_codec_tpu_torch.edge_cases import fgk_edge_rows  # noqa: E402
from huffman_codec_tpu_torch.ops import adapt as tad  # noqa: E402
from huffman_codec_tpu_torch.ops.diff import diff_apply  # noqa: E402
from huffman_codec_tpu_torch.ops import fgk as tfgk  # noqa: E402
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.ops import pack as tpack  # noqa: E402

RNG = np.random.default_rng(11)
# the cases of tests/test_jax_fgk.py
CASES = [
    b"",
    b"a",
    b"ab",
    b"aab",
    b"abracadabra",
    b"aaaaaaaabbbbcccd" * 4,
    bytes(RNG.integers(0, 4, 200, dtype=np.uint8)),
    bytes(RNG.integers(0, 256, 300, dtype=np.uint8)),
    bytes(range(256)),
    bytes(RNG.integers(0, 256, 1000, dtype=np.uint8)),
]
L = 1000  # one shape for every batch: one JAX compile
N_WORDS = tfgk.n_words_for(L)


def _batch(idx):
    x = np.zeros((len(idx), L), np.uint8)
    ln = np.zeros(len(idx), np.int32)
    for r, i in enumerate(idx):
        x[r, :len(CASES[i])] = np.frombuffer(CASES[i], np.uint8)
        ln[r] = len(CASES[i])
    return x, ln


@pytest.mark.parametrize("idx", [(0, 9), (1, 8), (2, 7), (3, 6), (4, 5)],
                         ids=lambda i: f"{i[0]}-{i[1]}")
def test_plain_fgk_equals_jax(idx):
    x, ln = _batch(idx)
    jw, jb = jfgk.fgk_encode_batch(jnp.asarray(x), jnp.asarray(ln), N_WORDS)
    tw, tb = K.fgk_encode(torch.from_numpy(x), torch.from_numpy(ln), N_WORDS)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int32))
    jd = jfgk.fgk_decode_batch(jw, jnp.asarray(ln), L)
    td = K.fgk_decode(tw, torch.from_numpy(ln), L)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(td.numpy(), x)


def test_plain_fgk_edge_rows_round_trip():
    """The edge batch the kernels are held to on the card: the plain
    encoder's streams decode back, and every stream fits its words."""
    x, ln = fgk_edge_rows(2100, 9)
    keep = ln <= 1100  # the plain loop runs once a symbol: the short rows
    x, ln = x[keep][:, :1100], ln[keep]
    nw = tfgk.n_words_for(1100)
    w, bits = K.fgk_encode(torch.from_numpy(x), torch.from_numpy(ln), nw)
    assert int(bits.max()) <= 32 * nw
    d = K.fgk_decode(w, torch.from_numpy(ln), 1100)
    valid = np.arange(1100)[None, :] < ln[:, None]
    np.testing.assert_array_equal(d.numpy(), np.where(valid, x, 0))


@pytest.mark.parametrize("maxlen", [4, 31, 64])
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_pack_codes_equals_jax(n, maxlen):
    rng = np.random.default_rng(n * 100 + maxlen)
    lens = rng.integers(1, maxlen + 1, n).astype(np.int32)
    tail = int(rng.integers(0, max(1, n // 3)))
    if tail:
        lens[n - tail:] = 0  # the zero-length tail of padded symbols
    v = rng.integers(0, 1 << 63, n, dtype=np.int64).view(np.uint64)
    v = v | (rng.integers(0, 2, n).astype(np.uint64) << np.uint64(63))
    sh = (64 - lens).astype(np.uint64)
    v = np.where(lens > 0, (v << sh) >> sh, 0).astype(np.uint64)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    nw = int(lens.sum()) // 32 + 2
    jw, jt = jpack.pack_codes(jnp.asarray(lo), jnp.asarray(hi),
                              jnp.asarray(lens), nw)
    tw, tt = tpack.pack_codes(torch.from_numpy(lo.astype(np.int64)),
                              torch.from_numpy(hi.astype(np.int64)),
                              torch.from_numpy(lens), nw)
    assert int(tt) == int(jt)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int32))


def test_words_bytes_and_get_bit_equal_jax():
    data = RNG.integers(0, 256, 41, dtype=np.uint8)
    jw = jpack.bytes_to_words(jnp.asarray(data), 11)
    tw = tpack.bytes_to_words(torch.from_numpy(data), 11)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int32))
    np.testing.assert_array_equal(tpack.words_to_bytes(tw, 41).numpy(), data)
    pos = np.array([0, 5, 31, 32, 200, 351, 352, 1000], np.int64)  # clamps
    jb = [int(jpack.get_bit(jw, jnp.int32(p))) for p in pos]
    tb = tpack.get_bit(tw[None, :].expand(len(pos), -1),
                       torch.from_numpy(pos))
    assert tb.tolist() == jb


# the FGK configs the JAX package's tests compile (sharded chunk 512 with
# and without diff, global chunk 256 with diff, global adaptive at width
# 64) and sharded adaptive
def _ramp(n):
    rng = np.random.default_rng(41)
    out = np.empty(n, np.uint8)
    out[: n // 2] = (np.arange(n // 2) // 7).astype(np.uint8)
    out[n // 2:] = rng.integers(0, 32, n - n // 2, dtype=np.uint8)
    return out.tobytes()


def _image(w=64, h=48):
    y, x = np.mgrid[0:h, 0:w]
    img = ((x // 3 + y // 5) % 256).astype(np.uint8)
    img[10:20, 10:30] = 7
    return img.tobytes()


# name: (config, input, block size forced on the global adaptive encode)
CODEC_CASES = {
    "sharded-512": (JaxConfig(chunk_size=512, lane=64, layout="sharded",
                              entropy="fgk"), _ramp(1500), None),
    "sharded-512-diff": (JaxConfig(use_diff=True, chunk_size=512,
                                   entropy="fgk", layout="sharded"),
                         _ramp(1500), None),
    "global-256-diff": (JaxConfig(use_diff=True, chunk_size=256,
                                  entropy="fgk"), _image(), None),
    "global-adapt-64": (JaxConfig(use_diff=True, use_adapt=True, width=64,
                                  chunk_size=256, entropy="fgk"), _image(),
                        None),
    # 96 tiles at block size 8: a grouped manifest, whose choice prices
    # the FGK payload by its bits
    "global-adapt-grouped": (JaxConfig(use_adapt=True, width=64,
                                       chunk_size=512, entropy="fgk"),
                             _image(64, 96), 8),
    "sharded-adapt": (JaxConfig(use_adapt=True, width=64, chunk_size=512,
                                layout="sharded", entropy="fgk"),
                      _image(64, 64), None),
}


def _v3_blobs(jcfg, data, bs):
    """Both packages' v3 containers. The global layout's ``encode`` may
    return a v1 blob (the race), so its v3 candidate is taken directly,
    at the block size both searches choose unless ``bs`` forces one."""
    tc = TorchCodec(config_from_fields(dataclasses.asdict(jcfg)), "cpu")
    jc = TPUCodec(jcfg)
    if jcfg.layout == "sharded":
        return tc, jc, tc.encode(data), jc.encode(data)
    if jcfg.use_adapt and bs is None:
        x = np.frombuffer(data, np.uint8)
        h = len(data) // jcfg.width
        bs = tad.adapt_search_best_v3(
            diff_apply(torch.from_numpy(x.copy())) if jcfg.use_diff
            else torch.from_numpy(x.copy()), jcfg.width, h)
        jx = jnp.asarray(x)
        assert bs == jad.adapt_search_best_v3(
            jax_diff(jx) if jcfg.use_diff else jx, jcfg.width, h)
    assert tc.global_candidates(len(data)) == [False]
    return (tc, jc, tc._encode_global(data, bs, False),
            jc._encode_global(data, bs, False))


@pytest.mark.parametrize("name", list(CODEC_CASES))
def test_fgk_container_equals_jax_and_cross_decodes(name):
    jcfg, data, bs = CODEC_CASES[name]
    tc, jc, tb, jb = _v3_blobs(jcfg, data, bs)
    assert tb[:6] == b"HCTPU\x03" and tb[8] == 0  # v3, entropy FGK
    if name == "global-adapt-grouped":
        assert tb[7] & 0x10  # FLAG_AGROUP
    assert tb == jb
    assert tc.decode(jb) == data
    if name != "sharded-adapt":
        # the JAX package cannot decode sharded-adaptive FGK containers,
        # its own included (its band decode reads the canonical manifest)
        assert jc.decode(tb) == data


def test_fgk_decode_range_and_steps():
    jcfg, data, _ = CODEC_CASES["sharded-512-diff"]
    cfg = dataclasses.replace(
        config_from_fields(dataclasses.asdict(jcfg)), step_chunks=2)
    tc = TorchCodec(cfg, "cpu")
    blob = TPUCodec(jcfg).encode(data)
    for start, length in ((500, 30), (0, 1500), (1023, 2), (1499, 1)):
        assert tc.decode_range(blob, start, length) == \
            data[start:start + length]
    steps = tc.decode_steps(blob)
    assert len(steps) == 2
    assert torch.cat(steps).numpy()[:len(data)].tobytes() == data
