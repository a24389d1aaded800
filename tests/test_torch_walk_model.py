"""A CPU model of the group walk kernel (``csrc/group_tile_lens.cu``),
held to the plain version (``kernels.group_tile_lens_plain``).

The kernel cannot run without a card. This model runs its design step for
step in Python, lane by lane: the window staged from 16-byte lines with
reads clamped to the stream (bytes past the group's end left as garbage),
each lane's four FSM chains and its map of the 8 abstract entry states
in byte and nibble form, the warp scan composing the maps by byte
permutes, the entry state each lane takes, the running outputs and their
warp prefix sum, the ballot that cuts a tile, the test whether the next
tile may stay in the pass, and the sizes and outputs moved 32 tiles at a
time, each output written once. It is run at several bytes a lane and
window sizes, so that tile borders fall on lane, pass and window borders,
on ``edge_cases.walk_edge_streams`` and on seeded random streams, in both
instances (with and without the decoded sizes). One grouped case goes
against the JAX package's ``adapt_group_tile_lens``.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from huffman_codec_tpu.ops import adapt as jad  # noqa: E402
from huffman_codec_tpu_torch.edge_cases import (  # noqa: E402
    _walk_stream, walk_edge_streams, walk_serial)
from huffman_codec_tpu_torch.ops import adapt as tad  # noqa: E402
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.ops import rle as trle  # noqa: E402

LANES = 32
AGREE = 4  # the kernel's kAgree
UNSET = -7  # an output not yet written
# (bytes a lane, window bytes): the kernel's (16, 4096), and windows
# that a pass only just fits, so passes cross window borders often
GEOMETRIES = [(16, 4096), (16, 528), (4, 144), (8, 272)]


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's __byte_perm with selectors below 8 (no sign mode)."""
    b = [(x >> 8 * i) & 255 for i in range(4)] + \
        [(y >> 8 * i) & 255 for i in range(4)]
    return sum(b[(s >> 4 * k) & 7] << 8 * k for k in range(4))


def nibbles(lo: int, hi: int) -> int:
    return byte_perm(lo | lo >> 4, hi | hi >> 4, 0x6420)


def fsm_step(st, c, j):
    count, match, cnt = st
    if count == 3:
        return 0, match, cnt | 1 << j
    return (count + 1 if match == c else 1), c, cnt


def abstract_state(count, match, b0, b1):
    return count * 2 + (match == b0) if count < 3 else 6 + (match == b1)


def shfl_up(vals, d):
    return [vals[i - d] if i >= d else vals[i] for i in range(LANES)]


def walk_group(stream, off, glen, sizes, K, items, win_bytes, rng, lens,
               dec):
    """One warp's walk of one group, as the kernel runs it; writes lens
    and dec (None: the instance without decoded sizes) at [0, K)."""
    n = len(stream)
    P = LANES * items

    def store(k, ln, dc):  # each output once
        assert lens[k] == UNSET, f"tile {k} written twice"
        lens[k] = ln
        if dec is not None:
            dec[k] = dc

    tb = 0
    len_r, dec_r = [0] * LANES, [0] * LANES
    t = q = before = produced = wlo = 0
    count, match = 0, -1
    win = None
    while q < glen and t < K:
        if win is None or q + P > wlo + win_bytes:
            a0 = (off + q) & ~15
            wlo = a0 - off
            lines = min(win_bytes // 16, (off + glen - a0 + 15) // 16)
            win = rng.integers(0, 256, win_bytes + 16).tolist()  # garbage
            for i in range(16 * lines):
                win[i] = stream[min(max(a0 + i, 0), n - 1)]
        x = [win[q - wlo + ln * items:q - wlo + (ln + 1) * items]
             for ln in range(LANES)]
        flat = win[q - wlo:q - wlo + P]
        nvalid = [min(max(glen - q - ln * items, 0), items)
                  for ln in range(LANES)]
        # 1. the four chains of every lane, its map in byte form
        lo, hi, chains, nxt = [], [], [], []
        for ln in range(LANES):
            xs = x[ln]
            nx = x[min(ln + 1, LANES - 1)]  # shfl_down: lane 31 its own
            ch = [(1, xs[0], 0), (2, xs[0], 0), (3, xs[0], 0),
                  (1, xs[1], 1)]
            for j in range(1, items):
                ch = [fsm_step(st, xs[j], j) if k < 3 or j >= 2 else st
                      for k, st in enumerate(ch)]
            ea, eb, ec, ed = (abstract_state(c, m, nx[0], nx[1])
                              for c, m, _ in ch)
            lo.append(ea | ea << 8 | ea << 16 | eb << 24)
            hi.append(ea | ec << 8 | ed << 16 | ed << 24)
            chains.append(ch)
            nxt.append(nx)

        # 2. the warp scan of the maps, each lane's entry state and chain
        d = 1
        while d < LANES:
            a = shfl_up([nibbles(lo[i], hi[i]) for i in range(LANES)], d)
            for i in range(d, LANES):
                lo[i], hi[i] = (byte_perm(lo[i], hi[i], a[i] & 0xffff),
                                byte_perm(lo[i], hi[i], a[i] >> 16))
            d *= 2
        s0 = abstract_state(count, match, x[0][0], x[0][1])
        excl = shfl_up([nibbles(lo[i], hi[i]) for i in range(LANES)], 1)
        E = [s0 if ln == 0 else (excl[ln] >> 4 * s0) & 7
             for ln in range(LANES)]
        cnt, final = [], []
        for ln in range(LANES):
            fc, fm, k = chains[ln][1 if E[ln] == 3 else 2 if E[ln] == 5
                                   else 3 if E[ln] >= 6 else 0]
            cnt.append(k)
            final.append((fc, fm))
        # the running outputs and their prefix sum; each byte's running
        # output and flag in the warp's shared arrays
        sums, run, fresh, compat = [], [], [], []
        for ln in range(LANES):
            xs, c, acc = x[ln], cnt[ln], 0
            cp = (0x17 >> E[ln]) & 1
            cm = []
            for j in range(items):
                is_cnt = (c >> j) & 1
                acc += (xs[j] if is_cnt else 1) if j < nvalid[ln] else 0
                cm.append(acc)
                if j and not is_cnt and ((c >> (j - 1)) & 1
                                         or xs[j - 1] != xs[j]):
                    cp |= 1 << j
            sums.append(acc)
            compat.append(cp)
            run.append(cm)
            fresh += [(cp >> j) & 1 for j in range(items)]
        incl = list(sums)
        d = 1
        while d < LANES:
            v = shfl_up(incl, d)
            incl = [incl[i] + (v[i] if i >= d else 0) for i in range(LANES)]
            d *= 2
        run = [incl[ln] - sums[ln] + r for ln in range(LANES)
               for r in run[ln]]
        fresh.append(rng.integers(0, 2))  # past the pass: never read
        # 3. the tiles that end inside the pass, each by two ballots
        start, base, reset = 0, -produced, False
        while t < K:
            target = base + sizes[t]
            m = [incl[ln] >= target and nvalid[ln] > max(start - ln * items,
                                                          0)
                 for ln in range(LANES)]
            if not any(m):
                break
            f = m.index(True)
            at = [f * items + (ln & (items - 1)) for ln in range(LANES)]
            m2 = [ln < items and at[ln] >= start and run[at[ln]] >= target
                  for ln in range(LANES)]
            j = m2.index(True)
            e, e_out, stays = f * items + j, run[at[j]], fresh[at[j] + 1]
            len_r[t - tb] = before + e - start + 1
            dec_r[t - tb] = e_out - base
            before, start, base = 0, e + 1, e_out
            t += 1
            if t - tb == LANES:
                for k in range(LANES):
                    if tb + k < K:
                        store(tb + k, len_r[k], dec_r[k])
                tb += LANES
                len_r, dec_r = [0] * LANES, [0] * LANES
            if start == P:
                reset = True
                break
            if stays:
                continue
            # the warp walks at most AGREE bytes from the tile's start in
            # the reset state, up to the byte after which both walks hold
            # (1, byte); later running outputs differ by delta, which the
            # base takes up, and the shifted ones before it stay below the
            # reset walk's output before it
            rc, rm, agree, racc, pre = 0, -1, None, 0, 0
            for p in range(start, min(start + AGREE, P)):
                c = flat[p]
                is_cnt = rc == 3
                pre = racc
                racc += (c if is_cnt else 1) if q + p < glen else 0
                rc = 0 if is_cnt else (rc + 1 if rm == c else 1)
                rm = rm if is_cnt else c
                if rc == 1 and fresh[p]:
                    agree = p
                    break
            if agree is None or pre >= (sizes[t] if t < K else 0):
                reset = True
                break
            base -= racc - (run[agree] - base)
        if reset:  # the next pass from the reset state
            q += start
            count, match, produced = 0, -1, 0
        else:
            before += min(glen - q, P) - start
            produced = incl[LANES - 1] - base
            count, match = final[LANES - 1]
            q += P
    if t < K:
        len_r[t - tb], dec_r[t - tb] = before, produced
    for k in range(LANES):
        if tb + k < K:
            store(tb + k, len_r[k], dec_r[k])
    for k in range(tb + LANES, K):
        store(k, 0, 0)


def walk_model(stream, group_offs, sizes, total, group_cap, items,
               win_bytes, with_decoded, seed=0):
    stream = np.asarray(stream).tolist()
    offs = np.asarray(group_offs).astype(np.int64).tolist()
    sizes = np.asarray(sizes).tolist()
    ng = len(offs)
    K = len(sizes) // ng
    rng = np.random.default_rng(seed)
    lens = [UNSET] * (ng * K)
    dec = [UNSET] * (ng * K) if with_decoded else None
    for g in range(ng):
        end = offs[g + 1] if g + 1 < ng else total
        glen = max(0, min(end - offs[g], group_cap))
        lg = [UNSET] * K
        dg = [UNSET] * K if with_decoded else None
        walk_group(stream, offs[g], glen, sizes[g * K:(g + 1) * K], K,
                   items, win_bytes, rng, lg, dg)
        lens[g * K:(g + 1) * K] = lg
        if with_decoded:
            dec[g * K:(g + 1) * K] = dg
    out = np.array(lens, np.int32)
    return (out, np.array(dec, np.int32)) if with_decoded else out


@functools.lru_cache(maxsize=None)
def edge_inputs(seed: int) -> dict:
    return walk_edge_streams(seed)


@functools.lru_cache(maxsize=None)
def plain(seed: int, name: str):
    """The plain version's (lens, decoded) on one input, once a module."""
    stream, offs, sizes, total, cap = edge_inputs(seed)[name]
    got = K.group_tile_lens_plain(torch.from_numpy(stream),
                                  torch.from_numpy(offs),
                                  torch.from_numpy(sizes), total, cap,
                                  with_decoded=True)
    return tuple(v.numpy() for v in got)


def random_case(seed: int):
    """A seeded valid stream of 120 tiles of 1-60 bytes (runs of 3-5
    equal bytes, count bytes 0 and 255) with ~20 random bytes spliced in,
    as one group: tiles overshoot, end short and leave bytes over."""
    rng = np.random.default_rng(seed)
    raws = []
    for _ in range(120):
        n = int(rng.integers(1, 61))
        parts, k = [], 0
        while k < n:
            run = int(rng.choice([1, 1, 2, 3, 4, 5, 258, 259]))
            parts.append(np.full(run, rng.choice([0, 3, 255]), np.uint8))
            k += run
        raws.append(np.concatenate(parts)[:n])
    stream, _, sizes = _walk_stream(raws)
    at = rng.integers(0, stream.size, 20)
    stream[at] = rng.choice([0, 3, 255], 20)
    return stream, np.zeros(1, np.int32), sizes, stream.size, stream.size


def check(inputs, want, geometries=GEOMETRIES):
    for items, win in geometries:
        for with_decoded in (False, True):
            got = walk_model(*inputs, items, win, with_decoded)
            if with_decoded:
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
            else:
                np.testing.assert_array_equal(got, want[0])


@pytest.mark.parametrize("name", list(edge_inputs(0)))
def test_walk_model_matches_plain_on_edge_streams(name):
    # the long streams at the kernel's geometry and one small window
    geo = GEOMETRIES[:2] if name in ("borders", "long") else GEOMETRIES
    check(edge_inputs(0)[name], plain(0, name), geo)


@pytest.mark.parametrize("name", list(edge_inputs(0)))
def test_walk_serial_matches_plain_on_edge_streams(name):
    got = walk_serial(*edge_inputs(0)[name])
    np.testing.assert_array_equal(got[0], plain(0, name)[0])
    np.testing.assert_array_equal(got[1], plain(0, name)[1])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_walk_model_matches_plain_on_random_streams(seed):
    inputs = random_case(seed)
    t = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
         for a in inputs]
    want = tuple(v.numpy() for v in K.group_tile_lens_plain(
        *t, with_decoded=True))
    np.testing.assert_array_equal(walk_serial(*inputs)[0], want[0])
    check(inputs, want, [(16, 4096), (4, 144)])


def test_walk_model_grouped_matches_jax():
    # a 64 x 72 image at block size 8: 72 tiles in two groups of 64
    rng = np.random.default_rng(21)
    img = np.minimum(np.arange(64 * 72) // 7 % 5 + rng.integers(0, 2, 64 * 72),
                     255).astype(np.uint8)
    stream, total, _, tl = tad.adapt_encode_fixed(torch.from_numpy(img), 64,
                                                  72, 8, with_header=False)
    stream, tl = stream.numpy(), tl.numpy()
    total = int(total)
    offs = np.concatenate([[0], np.cumsum(tl)])[: len(tl): tad.GROUP_K]
    offs = offs.astype(np.int32)
    cap = tad.GROUP_K * trle.rle_max_encoded_len(64)
    want = np.asarray(jad.adapt_group_tile_lens(
        jnp.asarray(stream), jnp.asarray(offs), jnp.int32(total), 64, 72, 8,
        cap))
    sizes = np.zeros(2 * tad.GROUP_K, np.int32)
    sizes[:72] = 64
    for items, win in ((16, 4096), (4, 144)):
        got = walk_model(stream, offs, sizes, total, cap, items, win, False)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want[:72], tl)
