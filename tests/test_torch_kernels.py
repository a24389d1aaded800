"""The PyTorch port's kernels (plain versions on the CPU) against the JAX
package's Pallas kernels run with ``interpret=True``.

Integer codec: every comparison is exact (tolerance 0). All inputs come
from numpy with fixed seeds and go through both packages as numpy arrays.
Shapes are the codec's small test geometry: 4096-byte chunks, 512-symbol
lanes, the 8192-byte canonical RLE cap (16 lanes).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from huffman_codec_tpu.ops import canonical as jcan  # noqa: E402
from huffman_codec_tpu.ops import pallas_kernels as jpk  # noqa: E402
from huffman_codec_tpu.ops.rle import rle_classify as jax_rle_classify  # noqa: E402
from huffman_codec_tpu_torch.ops import canonical as tcan  # noqa: E402
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.ops import rle as trle  # noqa: E402

CS, LANE, CAP = 4096, 512, 8192
NL = CAP // LANE
RNG = np.random.default_rng(2024)


def _gradient(n, seed):
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    return (((i // 64) * 3 + (i % 64) + rng.integers(-2, 3, n)) & 255).astype(
        np.uint8)


def _rows():
    """(chunks (8, CS) u8, lens (8,), carries (8,)): random bytes, gradient
    with noise, long runs (> 258 and >= 2 * 258), one symbol, two symbols,
    a partial tail, an empty chunk and a one-byte chunk."""
    runs = np.concatenate([np.full(259, 7), np.full(516, 9), np.full(517, 1),
                           np.full(300, 3), np.arange(100) % 5,
                           np.full(CS - 1692, 200)])
    rows = [RNG.integers(0, 256, CS), _gradient(CS, 1), runs,
            np.full(CS, 65), RNG.integers(0, 2, CS), _gradient(CS, 2),
            np.zeros(CS), np.full(CS, 5)]
    lens = np.array([CS, CS, CS, CS, CS, 1000, 0, 1], np.int32)
    carries = np.array([0, 1, 255, 65, 3, 9, 0, 77], np.uint8)
    return np.stack(rows).astype(np.uint8), lens, carries


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def enc():
    """The RLE streams of both diff modes from the JAX kernel, and the
    port's plain version on the same rows."""
    chunks, lens, carries = _rows()
    out = {}
    for use_diff in (False, True):
        js, jl = jpk.rle_diff_encode_fused(
            jnp.asarray(chunks), jnp.asarray(lens), jnp.asarray(carries),
            use_diff, CAP, interpret=True)
        ts, tl = K.rle_diff_encode(_t(chunks), _t(lens), _t(carries),
                                   use_diff, CAP)
        out[use_diff] = dict(jax=(np.asarray(js), np.asarray(jl)),
                             port=(ts.numpy(), tl.numpy()))
    out.update(chunks=chunks, lens=lens, carries=carries)
    return out


@pytest.mark.parametrize("use_diff", [False, True])
def test_rle_diff_encode_matches_pallas(enc, use_diff):
    (js, jl), (ts, tl) = enc[use_diff]["jax"], enc[use_diff]["port"]
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(ts, js)


def test_rle_encode_plain_matches_emission_rule():
    # the reference rule through the JAX XLA formulation, row by row
    from huffman_codec_tpu.ops.rle import rle_encode as jax_rle_encode

    chunks, lens, _ = _rows()
    ts, tl = trle.rle_encode(_t(chunks), _t(lens), CAP)
    for i in (0, 2, 3, 5, 6, 7):
        js, jl = jax_rle_encode(jnp.asarray(chunks[i]), jnp.int32(lens[i]),
                                out_len=CAP)
        assert int(tl[i]) == int(jl)
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js))


@pytest.fixture(scope="module")
def streams(enc):
    s, ln = enc[True]["jax"]
    return s, ln.astype(np.int32)


def test_histogram256_matches_pallas(streams):
    s, ln = streams
    got = K.histogram256(_t(s), _t(ln)).numpy()
    want = np.asarray(jpk.histogram256(jnp.asarray(s), jnp.asarray(ln),
                                       interpret=True))
    np.testing.assert_array_equal(got, want)


def _tie_counts():
    """Count tables full of ties, plus the degenerate ones."""
    rows = [np.ones(256), np.r_[np.full(128, 5), np.zeros(128)],
            RNG.integers(1, 4, 256), np.r_[np.full(200, 7), np.full(56, 14)],
            2 ** (np.arange(256) % 20), np.r_[[9], np.zeros(255)],
            np.r_[[3, 3], np.zeros(254)], np.zeros(256),
            RNG.integers(0, 1 << 22, 256), np.r_[np.arange(1, 33),
                                                 np.zeros(224)]]
    return np.stack(rows).astype(np.int32)


@pytest.fixture(scope="module")
def codes(streams):
    """Code lengths and codes from both packages, on tie-heavy tables and
    on the real streams' histograms."""
    s, ln = streams
    hist = np.asarray(jcan.histogram(jnp.asarray(s), jnp.asarray(ln)))
    counts = np.concatenate([_tie_counts(), hist])
    jl = jcan.build_lengths_pm(jnp.asarray(counts))
    jc = jcan.assign_codes(jl)
    _, _, jsyms = jcan.canonical_tables(jl)
    tl = tcan.build_lengths_pm(_t(counts))
    tc = tcan.assign_codes(tl)
    _, _, tsyms = tcan.canonical_tables(tl)
    return dict(counts=counts, n_tie=len(_tie_counts()),
                jax=(np.asarray(jl), np.asarray(jc), np.asarray(jsyms)),
                port=(tl.numpy(), tc.numpy(), tsyms.numpy()))


@pytest.mark.parametrize("part", ["lengths", "codes", "canon_syms"])
def test_canonical_code_matches_jax(codes, part):
    i = ["lengths", "codes", "canon_syms"].index(part)
    np.testing.assert_array_equal(codes["port"][i].astype(np.int64),
                                  codes["jax"][i].astype(np.int64))


@pytest.fixture(scope="module")
def packed(streams, codes):
    s, ln = streams
    lens, cd, _ = codes["port"]
    lens, cd = lens[codes["n_tie"]:], cd[codes["n_tie"]:]
    tables = (cd | (lens << 26)).astype(np.int32)
    jw, jb = jpk.lane_pack(jnp.asarray(s), jnp.asarray(ln),
                           jnp.asarray(tables.astype(np.uint32)), LANE,
                           interpret=True)
    tw, tb = K.lane_pack(_t(s), _t(ln), _t(tables), LANE)
    return dict(lens=lens.astype(np.uint8), jax=(np.asarray(jw),
                                                 np.asarray(jb)),
                port=(tw.numpy().view(np.uint32), tb.numpy()))


def test_lane_pack_matches_pallas(packed):
    (jw, jb), (tw, tb) = packed["jax"], packed["port"]
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tw, jw)


def _dense(words, lw):
    """Lane buffers -> the wire's dense words (chunk, lane, word order)."""
    col = np.arange(words.shape[2])
    return words[col[None, None, :] < lw[:, :, None]]


@pytest.fixture(scope="module")
def repadded(packed):
    """The packed lanes through the wire (dense words) and back to the
    decoder's fixed stride, by the port's repad."""
    words, bits = packed["port"]
    lw = ((bits + 31) >> 5).astype(np.int32)
    wb = max(8, -(-int(lw.max()) // 16) * 16)
    got = K.repad_words(_t(_dense(words, lw).view(np.int32)), _t(lw), wb)
    return dict(got=got.numpy(), wb=wb)


def test_repad_words_matches_pallas_on_valid_slots():
    # a small stride keeps the interpret-mode butterflies cheap; random
    # lane sizes include empty lanes and a chunk of empty tail lanes
    rng = np.random.default_rng(31)
    C, wb = 8, 16
    lw = rng.integers(0, wb + 1, (C, NL)).astype(np.int32)
    lw[2, 5:] = 0
    wc = lw.sum(1)
    flat = rng.integers(0, 2**32, int(wc.sum()), dtype=np.uint64).astype(
        np.uint32)
    got = K.repad_words(_t(flat.view(np.int32)), _t(lw), wb).numpy()
    # the TPU kernel's staging: each chunk's words at a 128-word row
    rows = (wc + 127) // 128
    aoff = np.r_[0, np.cumsum(rows)[:-1]].astype(np.int32)
    nb = 128
    while nb < int(aoff[-1] + rows[-1]) + 8:
        nb <<= 1
    stage = np.zeros(nb * 128, np.uint32)
    starts = np.r_[0, np.cumsum(wc)]
    for c in range(C):
        stage[aoff[c] * 128: aoff[c] * 128 + wc[c]] = flat[starts[c]:
                                                           starts[c + 1]]
    want = np.asarray(jpk.repad_words(
        jnp.asarray(stage.reshape(nb, 128)), jnp.asarray(aoff),
        jnp.asarray(wc.astype(np.int32)), jnp.asarray(lw), NL, wb,
        interpret=True))
    valid = (np.arange(wb)[None, None, :] < lw[:, :, None]).reshape(C, -1)
    np.testing.assert_array_equal(got.view(np.uint32)[valid], want[valid])
    assert (got[~valid] == 0).all()


def test_lane_decode_matches_pallas(repadded, packed, streams):
    s, ln = streams
    wb = repadded["wb"]
    buf = repadded["got"].reshape(-1, NL, wb)
    lens = packed["lens"]
    max_len = next(b for b in (8, 12, 16, 24, 31) if b >= int(lens.max()))
    got = K.lane_decode(_t(buf), _t(lens), _t(ln), LANE, max_len).numpy()
    want = np.asarray(jpk.lane_decode(
        jnp.asarray(buf.view(np.uint32)), jnp.asarray(lens), jnp.asarray(ln),
        lane=LANE, max_len=max_len, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, s)  # and it inverts the pack


@pytest.fixture(scope="module")
def classified(enc):
    out = {}
    for use_diff in (False, True):
        s, ln = enc[use_diff]["jax"]
        ln = ln.astype(np.int32)
        j = jax.vmap(lambda a, b: jax_rle_classify(a, b))(jnp.asarray(s),
                                                          jnp.asarray(ln))
        out[use_diff] = (s, ln, np.asarray(j),
                         trle.rle_classify(_t(s), _t(ln)).numpy())
    return out


@pytest.mark.parametrize("use_diff", [False, True])
def test_rle_classify_matches_jax(classified, use_diff):
    _, _, j, t = classified[use_diff]
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("use_diff", [False, True])
def test_rle_expand_matches_pallas(classified, enc, use_diff):
    s, ln, ic, _ = classified[use_diff]
    car = enc["carries"]
    got = K.rle_expand(_t(s), _t(ic), _t(ln), _t(car), CS, use_diff).numpy()
    want = np.asarray(jpk.rle_expand(
        jnp.asarray(s), jnp.asarray(ic), jnp.asarray(ln), jnp.asarray(car),
        CS, use_diff, interpret=True))
    np.testing.assert_array_equal(got, want)
    lens = enc["lens"]
    for i in range(len(lens)):  # and it inverts the encode
        np.testing.assert_array_equal(got[i, :lens[i]],
                                      enc["chunks"][i, :lens[i]])


def test_rle_decode_inverts_encode(enc):
    s, ln = enc[False]["port"]
    out, total = trle.rle_decode(_t(s), _t(ln), CS)
    for i, n in enumerate(enc["lens"]):
        assert int(total[i]) == n
        np.testing.assert_array_equal(out[i, :n].numpy(),
                                      enc["chunks"][i, :n])


def test_diff_matches_jax():
    from huffman_codec_tpu.ops.diff import diff_apply, diff_revert
    from huffman_codec_tpu_torch.ops import diff as tdiff

    x = RNG.integers(0, 256, 1000, dtype=np.uint8)
    for carry in (0, 200):
        y = tdiff.diff_apply(_t(x), carry).numpy()
        np.testing.assert_array_equal(y, np.asarray(diff_apply(
            jnp.asarray(x), carry)))
        np.testing.assert_array_equal(
            tdiff.diff_revert(_t(y), carry).numpy(),
            np.asarray(diff_revert(jnp.asarray(y), carry)))


# ---------------------------------------------------------------------------
# no silent fallback: only CPU tensors reach a plain version
# ---------------------------------------------------------------------------


def test_wrappers_refuse_other_devices():
    meta = dict(device="meta")
    calls = [
        lambda: K.rle_diff_encode(torch.empty((2, 64), dtype=torch.uint8, **meta),
                                  torch.empty(2, dtype=torch.int32, **meta),
                                  torch.empty(2, dtype=torch.uint8, **meta),
                                  False, 128),
        lambda: K.histogram256(torch.empty((2, 64), dtype=torch.uint8, **meta),
                               torch.empty(2, dtype=torch.int32, **meta)),
        lambda: K.repad_words(torch.empty(8, dtype=torch.int32, **meta),
                              torch.empty((2, 4), dtype=torch.int32, **meta), 8),
    ]
    K.reset_launches()
    for call in calls:
        with pytest.raises(ValueError):
            call()
    assert not any(K.launch_counts().values())


def test_cpu_plain_path_counts_no_launches(streams):
    s, ln = streams
    K.reset_launches()
    K.histogram256(_t(s), _t(ln))
    assert K.launch_counts()["histogram256"] == 0
