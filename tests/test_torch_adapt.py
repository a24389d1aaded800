"""The port's adaptive block RLE against the JAX package's, on the CPU:
the plain version of the RLE kernel's tile mode against the Pallas kernel
in interpret mode, the search's helpers and scores, the tile encode and
decode, the grouped manifest's walk, and whole containers in both layouts
byte-equal with ``TPUCodec``, each package decoding the other's.

Integer codec: every comparison is exact bytes and integers. Inputs come
from numpy with fixed seeds. The matrices are small (64 wide, up to 72
rows) and the JAX geometries few and all in this module, because every
(shape, block size, config) compiles its own XLA stages.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from huffman_codec_tpu.models import chunked as jch  # noqa: E402
from huffman_codec_tpu.ops import adapt as jad  # noqa: E402
from huffman_codec_tpu.ops import pallas_kernels as jpk  # noqa: E402
from huffman_codec_tpu.ops import rle as jrle  # noqa: E402
from huffman_codec_tpu_torch import CodecConfig, TorchCodec, config_from_fields  # noqa: E402
from huffman_codec_tpu_torch.formats import FLAG_AGROUP, V3_MAGIC  # noqa: E402
from huffman_codec_tpu_torch.ops import adapt as tad  # noqa: E402
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.ops import rle as trle  # noqa: E402

W = 64


def _gradient(rows, seed):
    """Smooth W-wide gradients with noise and one long run."""
    rng = np.random.default_rng(seed)
    i = np.arange(rows * W)
    x = ((((i // W) * 3 + (i % W) * 2) // 5 + rng.integers(-1, 2, i.size))
         & 255).astype(np.uint8)
    x[100:900] = 5
    return x


def _runs(rows, seed):
    """Run-heavy with few zero bytes: vertical stripes of 1..9, so most
    positions that end a run emit a literal and a count byte together."""
    rng = np.random.default_rng(seed)
    x = np.repeat(rng.integers(1, 10, (rows // 4, W // 4)), 4, axis=0)
    x = np.repeat(x, 4, axis=1).astype(np.uint8)
    x[rng.integers(0, rows, 40), rng.integers(0, W, 40)] = 200
    return x.reshape(-1)


MATS = {
    "clamped": (_gradient(72, 1), 72),  # 72 rows: clamped from bs 16 on
    "aligned_runs": (_runs(64, 2), 64),
}


def _port(jcfg):
    return TorchCodec(config_from_fields(dataclasses.asdict(jcfg)),
                      device="cpu")


# -- (a) the tile mode of the RLE kernel -------------------------------------


def _tile_rows(C, n):
    rng = np.random.default_rng(40 + C)
    rows = np.stack([np.concatenate([
        rng.integers(0, 3, n // 2).astype(np.uint8),
        np.full(n // 2, 7 + c, np.uint8)])  # one run across many tiles
        for c in range(C)])
    rows[-1, 10:10 + 258] = 9  # a run of exactly 258 ...
    rows[-1, 300:300 + 259] = 4  # ... and of 259
    return rows


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("tile", [64, 256])
def test_tile_mode_plain_matches_pallas_interpret(tile, C):
    n = 1024
    cap = -(-jrle.rle_max_encoded_len(n) // 128) * 128
    rows = _tile_rows(C, n)
    want_s, want_n = jpk.rle_diff_encode_fused(
        jnp.asarray(rows), jnp.full((C,), n, jnp.int32),
        jnp.zeros((C,), jnp.uint8), False, cap, interpret=True, tile=tile)
    lens = torch.full((C,), n, dtype=torch.int32)
    zero = torch.zeros(C, dtype=torch.uint8)
    got_s, got_n = K.rle_diff_encode(torch.from_numpy(rows), lens, zero,
                                     False, cap, tile=tile)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    # and against every tile encoded alone, concatenated in order
    for c in range(C):
        parts = []
        for t0 in range(0, n, tile):
            s, ln = trle.rle_encode(
                torch.from_numpy(rows[c:c + 1, t0:t0 + tile]),
                torch.tensor([tile]), trle.rle_max_encoded_len(tile))
            parts.append(s[0, : int(ln[0])].numpy())
        exp = np.concatenate(parts)
        assert int(got_n[c]) == exp.size
        np.testing.assert_array_equal(got_s[c, : exp.size].numpy(), exp)
        assert not got_s[c, exp.size:].any()


def test_tile_mode_rejects_what_the_pallas_wrapper_rejects():
    rows = torch.zeros((1, 1024), dtype=torch.uint8)
    lens = torch.tensor([1024], dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.uint8)
    for tile, diff, msg in ((96, False, "power of two dividing n"),
                            (2048, False, "power of two dividing n"),
                            (64, True, "requires use_diff=False")):
        with pytest.raises(ValueError, match=msg):
            K.rle_diff_encode(rows, lens, zero, diff, 1408, tile=tile)
        with pytest.raises(ValueError, match=msg):
            jpk.rle_diff_encode_fused(
                jnp.zeros((1, 1024), jnp.uint8), jnp.asarray(lens.numpy()),
                jnp.zeros((1,), jnp.uint8), diff, 1408, interpret=True,
                tile=tile)


def test_tile_mode_partial_row():
    """A valid prefix that ends inside a tile: the tiles after it are
    empty and the last valid byte is a literal of its own."""
    rows = torch.from_numpy(_tile_rows(1, 1024))
    for length in (1, 63, 64, 65, 700):
        lens = torch.tensor([length], dtype=torch.int32)
        got_s, got_n = K.rle_diff_encode(
            rows, lens, torch.zeros(1, dtype=torch.uint8), False, 1408,
            tile=64)
        want_s, want_n = jpk.rle_diff_encode_fused(
            jnp.asarray(rows.numpy()), jnp.asarray(lens.numpy()),
            jnp.zeros((1,), jnp.uint8), False, 1408, interpret=True, tile=64)
        assert int(got_n[0]) == int(want_n[0])
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_rle_encoded_size_matches_jax():
    x = _tile_rows(3, 1024)
    lens = np.array([1024, 500, 1], np.int32)
    got = trle.rle_encoded_size(torch.from_numpy(x), torch.from_numpy(lens))
    want = [int(jrle.rle_encoded_size(jnp.asarray(r), int(n)))
            for r, n in zip(x, lens)]
    assert got.tolist() == want


# -- (b) the search ----------------------------------------------------------


def test_constants_match_jax():
    for name in ("INIT_RLE_BLOCK_SIZE", "MAX_RLE_DOUBLING_STEPS",
                 "ADAPT_HEADER_BYTES", "GROUP_K"):
        assert getattr(tad, name) == getattr(jad, name)


@pytest.mark.parametrize("w", [8, 9, 64, 500, 512, 4096])
def test_candidate_sizes_match_jax(w):
    for h in (8, 15, 16, 72, 128, 1024, 5000):
        assert tad.candidate_sizes(w, h) == jad.candidate_sizes(w, h)
    for bad in ((7, 100), (100, 7)):
        with pytest.raises(ValueError, match="too small 2D data dimensions"):
            tad.candidate_sizes(*bad)
        with pytest.raises(ValueError, match="too small 2D data dimensions"):
            jad.candidate_sizes(*bad)


@pytest.mark.parametrize("bs", [8, 16, 32, 64, 128, 256, 512, 1024])
def test_manifest_helpers_match_jax(bs):
    assert tad.tile_len_width(bs) == jad.tile_len_width(bs)
    assert tad.tile_len_width(bs) == (2 if bs <= 128 else 4)
    for nt in (1, 64, 65, 72, 4096, 100000):
        for est in (0, 100, 4096, 9215, 9216, 16384, 1 << 20):
            assert (tad.grouped_manifest(nt, bs, est)
                    == jad.grouped_manifest(nt, bs, est))


@pytest.mark.parametrize("h,bs", [(72, 16), (69, 8), (64, 32), (5, 8)])
def test_tile_geometry_matches_jax(h, bs):
    for got, want in zip(tad._tile_maps(W, h, bs), jad._tile_maps(W, h, bs)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tad._tile_geom_arrays(W, h, bs),
                                  jad._tile_geom_arrays(W, h, bs))


@pytest.mark.parametrize("name", list(MATS))
def test_scores_and_choice_match_jax(name):
    x, h = MATS[name]
    cands = jad.candidate_sizes(W, h)
    want = [int(jad._adapt_score_v3(jnp.asarray(x), W, h, b)) for b in cands]
    got = [int(tad._adapt_score_v3(torch.from_numpy(x), W, h, b))
           for b in cands]
    assert got == want
    best = tad.adapt_search_best_v3(torch.from_numpy(x), W, h)
    assert best == cands[int(np.argmin(want))]
    assert best == jad.adapt_search_best_v3(jnp.asarray(x), W, h)


def test_score_counts_a_literal_with_its_count_byte_once():
    """The arithmetic the score shares with the JAX package: a position
    that emits a literal and a count byte puts only the literal into the
    histogram, so its count byte is missing there and bucket 0 keeps one
    count too many for each such position."""
    x, h = MATS["aligned_runs"]
    hor, ver, lens = tad._gather_tiles(torch.from_numpy(x), W, h, 8)
    el, ec, _ = trle._emissions(hor, lens)
    size, vals = tad._scan_emissions(hor, lens)
    both = int((el & ec).sum())
    assert both > 50
    counts = tad._emission_histogram(vals, hor.numel() - int(size.sum()))
    assert int(counts.sum()) == int(size.sum())
    assert int(counts[0]) == both + int((vals[el | ec] == 0).sum())


# -- (c) tile encode, decode and the grouped manifest's walk ----------------


@pytest.fixture(scope="module")
def fixed():
    """JAX's adaptive payloads of the clamped matrix: bs 8 without the
    header (72 tiles: two manifest groups), bs 16 with it."""
    x, h = MATS["clamped"]
    out = {}
    for bs, hdr in ((8, False), (16, True)):
        s, total, dirs, tl = jad.adapt_encode_fixed(
            jnp.asarray(x), W, h, bs, with_header=hdr)
        out[bs] = dict(stream=np.asarray(s), total=int(total),
                       dirs=np.asarray(dirs), tile_lens=np.asarray(tl),
                       with_header=hdr)
    return out


@pytest.mark.parametrize("bs", [8, 16])
def test_adapt_encode_fixed_matches_jax(fixed, bs):
    x, h = MATS["clamped"]
    f = fixed[bs]
    s, total, dirs, tl = tad.adapt_encode_fixed(
        torch.from_numpy(x), W, h, bs, with_header=f["with_header"])
    assert int(total) == f["total"]
    np.testing.assert_array_equal(dirs.numpy(), f["dirs"])
    np.testing.assert_array_equal(tl.numpy(), f["tile_lens"])
    np.testing.assert_array_equal(s.numpy(), f["stream"])


@pytest.mark.parametrize("bs", [8, 16])
def test_adapt_decode_tiled_matches_jax(fixed, bs):
    x, h = MATS["clamped"]
    f = fixed[bs]
    skip = tad.ADAPT_HEADER_BYTES + (len(f["dirs"]) + 7) // 8 \
        if f["with_header"] else 0
    body = f["stream"][skip:]
    want = np.asarray(jad.adapt_decode_tiled(
        jnp.asarray(body), jnp.asarray(f["tile_lens"]),
        jnp.asarray(f["dirs"]), W, h, bs))
    got = tad.adapt_decode_tiled(
        torch.from_numpy(body.copy()),
        torch.from_numpy(f["tile_lens"].copy()),
        torch.from_numpy(f["dirs"].copy()), W, h, bs).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)


def test_adapt_group_tile_lens_matches_truth_and_jax(fixed):
    _, h = MATS["clamped"]
    f = fixed[8]
    tl = f["tile_lens"]
    offs = np.concatenate([[0], np.cumsum(tl)])[: len(tl): tad.GROUP_K]
    offs = offs.astype(np.int32)
    cap = tad.GROUP_K * trle.rle_max_encoded_len(64)
    want = np.asarray(jad.adapt_group_tile_lens(
        jnp.asarray(f["stream"]), jnp.asarray(offs), jnp.int32(f["total"]),
        W, h, 8, cap))
    got = tad.adapt_group_tile_lens(
        torch.from_numpy(f["stream"].copy()), torch.from_numpy(offs),
        f["total"], W, h, 8, cap).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[: len(tl)], tl)
    assert not got[len(tl):].any()


# -- (d) containers ------------------------------------------------------------

# 69 rows in bands of 16: four full bands and a 5-row tail, shorter than
# every block size; 64 rows: four full bands, no tail
SHARDED = {
    "diff_tail": (True, _gradient(69, 3).tobytes()),
    "nodiff": (False, _runs(64, 4).tobytes()),
}


def _sharded_cfg(use_diff):
    return jch.CodecConfig(use_diff=use_diff, use_adapt=True, width=W,
                           chunk_size=16 * W, lane=64, layout="sharded")


@pytest.fixture(scope="module")
def sharded_blobs():
    return {k: jch.TPUCodec(_sharded_cfg(d)).encode(data)
            for k, (d, data) in SHARDED.items()}


@pytest.mark.parametrize("kind", list(SHARDED))
def test_sharded_adaptive_container_matches_jax(sharded_blobs, kind):
    use_diff, data = SHARDED[kind]
    jcfg = _sharded_cfg(use_diff)
    port = _port(jcfg)
    blob = port.encode(data)
    assert blob == sharded_blobs[kind]
    hdr = port._parse(blob)
    assert hdr["n_chunks"] == -(-len(data) // (16 * W))
    assert port.decode(sharded_blobs[kind]) == data
    assert jch.TPUCodec(jcfg).decode(blob) == data
    # the adaptive band stage takes no steps: step_chunks changes nothing
    stepped = _port(dataclasses.replace(jcfg, step_chunks=3))
    assert stepped.encode(data) == blob
    assert stepped.decode(blob) == data


@pytest.mark.parametrize("kind", list(SHARDED))
def test_sharded_adaptive_decode_range_matches_jax(sharded_blobs, kind):
    use_diff, data = SHARDED[kind]
    jcfg = _sharded_cfg(use_diff)
    blob = sharded_blobs[kind]
    cs = 16 * W
    spans = [(0, 1), (cs - 7, 20), (2 * cs + 5, cs + 100),
             (len(data) - 30, 30), (0, len(data)), (5, 0)]
    port, ref = _port(jcfg), jch.TPUCodec(jcfg)
    for start, length in spans:
        want = data[start:start + length]
        assert port.decode_range(blob, start, length) == want
    assert ref.decode_range(blob, cs - 7, 20) == data[cs - 7: cs + 13]
    with pytest.raises(ValueError, match="range out of bounds"):
        port.decode_range(blob, len(data) - 3, 4)


GLOBAL = {d: _gradient(72, 5 + d).tobytes() for d in (False, True)}


def _global_cfg(use_diff):
    return jch.CodecConfig(use_diff=use_diff, use_adapt=True, width=W)


@pytest.mark.parametrize("whole", [True, False], ids=["whole", "chunked"])
@pytest.mark.parametrize("bs,grouped", [(8, True), (16, False)])
def test_global_adaptive_candidates_match_jax(bs, grouped, whole):
    """bs 8 cuts the 64 x 72 matrix into 72 tiles, whose u16 lengths
    outweigh a 64th of the payload: the grouped manifest; bs 16 makes 20
    tiles and keeps their lengths."""
    jcfg = _global_cfg(True)
    data = GLOBAL[True]
    want = jch.TPUCodec(jcfg)._encode_global(data, bs, whole)
    port = _port(jcfg)
    blob = port._encode_global(data, bs, whole)
    assert blob == want
    hdr = port._parse(blob)
    assert bool(hdr["flags"] & FLAG_AGROUP) == grouped
    assert hdr["bs"] == bs and (hdr["w"], hdr["h"]) == (W, 72)
    assert port.decode(want) == data
    assert jch.TPUCodec(jcfg).decode(blob) == data


@pytest.mark.parametrize("use_diff", [False, True])
def test_global_adaptive_encode_matches_jax(use_diff):
    """``encode()``: each package's own search, both candidates and the
    v1 race, which a small input's v1 blob wins."""
    jcfg = _global_cfg(use_diff)
    data = GLOBAL[use_diff]
    want = jch.TPUCodec(jcfg).encode(data)
    port = _port(jcfg)
    blob = port.encode(data)
    assert blob == want
    assert blob[:6] != V3_MAGIC  # the v1 format won the race
    assert port.decode(blob) == data
    assert jch.TPUCodec(jcfg).decode(blob) == data


def test_adaptive_input_checks_match_jax():
    cases = [
        (dict(width=0), b"x" * 64, "invalid matrix width"),
        (dict(width=W), b"x" * (W * 9 + 1), "invalid size of input 2D data"),
        (dict(width=W), b"x" * (W * 7), "too small 2D data dimensions"),
        (dict(width=W, chunk_size=16 * W, lane=64, layout="sharded"),
         b"x" * (W * 5), "too small 2D data dimensions"),
    ]
    for kw, data, msg in cases:
        for make in (lambda: jch.TPUCodec(jch.CodecConfig(use_adapt=True,
                                                          **kw)),
                     lambda: TorchCodec(CodecConfig(use_adapt=True, **kw),
                                        device="cpu")):
            with pytest.raises(ValueError, match=msg):
                make().encode(data)
    ctor = [
        (dict(width=100, chunk_size=4096), "divisible by the matrix width"),
        (dict(width=1024, chunk_size=4096), "bands of >= 8 rows"),
    ]
    for kw, msg in ctor:
        with pytest.raises(ValueError, match=msg):
            jch.TPUCodec(jch.CodecConfig(use_adapt=True, layout="sharded",
                                         **kw))
        with pytest.raises(ValueError, match=msg):
            TorchCodec(CodecConfig(use_adapt=True, layout="sharded", **kw),
                       device="cpu")


def test_empty_adaptive_container_matches_jax():
    for jcfg in (_global_cfg(True), _sharded_cfg(False)):
        blob = _port(jcfg).encode(b"")
        assert blob == jch.TPUCodec(jcfg).encode(b"")
        assert _port(jcfg).decode(blob) == b""


def test_decode_steps_refuses_adaptive_containers(sharded_blobs):
    port = _port(_sharded_cfg(False))
    with pytest.raises(ValueError, match="stream mode"):
        port.decode_steps(sharded_blobs["nodiff"])
