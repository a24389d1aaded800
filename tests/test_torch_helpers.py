"""The port's last helpers against the JAX package's, on the CPU: v2
containers, the host runtime's byte RLE, the 1-D forms of the RLE ops,
the exact and Kraft code lengths and the one-chunk FGK forms.
Also the oracle that ``chip_smoke.py`` holds kernels 1 and 6 to on the
card: the host runtime's ``rle_encode`` of each chunk diffed with numpy,
seeded with the carry the port's sharded stage uses. Inputs are made
with numpy from a seed; every comparison is exact.
"""

import dataclasses
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from huffman_codec_tpu import formats as jfmt  # noqa: E402
from huffman_codec_tpu import ops as jops  # noqa: E402
from huffman_codec_tpu.native import runtime as jrt  # noqa: E402
from huffman_codec_tpu.ops import canonical as jcan  # noqa: E402
from huffman_codec_tpu.ops import fgk as jfgk  # noqa: E402
from huffman_codec_tpu.ops import pack as jpack  # noqa: E402
from huffman_codec_tpu.pyref import rle as jpyrle  # noqa: E402

from huffman_codec_tpu_torch import formats as tfmt  # noqa: E402
from huffman_codec_tpu_torch import native as tnative  # noqa: E402
from huffman_codec_tpu_torch import ops as tops  # noqa: E402
from huffman_codec_tpu_torch.models.chunked import (  # noqa: E402
    encode_sharded_stage)
from huffman_codec_tpu_torch.models.entropy import CANONICAL  # noqa: E402
from huffman_codec_tpu_torch.ops import canonical as tcan  # noqa: E402
from huffman_codec_tpu_torch.ops import fgk as tfgk  # noqa: E402
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.ops import rle as trle  # noqa: E402
from huffman_codec_tpu_torch.ops.pack import pack_codes  # noqa: E402
from huffman_codec_tpu_torch.pyref import rle as tpyrle  # noqa: E402

RNG = np.random.default_rng(2024)


def _gradient(n: int, seed: int) -> np.ndarray:
    """A smooth ramp with noise and some long runs: compressible bytes."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    x = ((i // 61) + (i % 23) // 3 + rng.integers(0, 3, n)) & 255
    x[n // 4: n // 4 + 600] = 9
    return x.astype(np.uint8)


def _runs(lengths, tail: bytes = b"") -> bytes:
    """Runs of the given lengths, each of a new byte, then ``tail``."""
    return b"".join(bytes([(7 * k + 1) & 255]) * n
                    for k, n in enumerate(lengths)) + tail


# the MNP-5 boundaries: runs of 254-258 bytes (258 = the count byte 255,
# which restarts the matcher), runs past it, a trailing run (its last
# byte is a fresh literal, no count byte after three), short inputs
RLE_CASES = {
    "empty": b"",
    "one": b"\x05",
    "runs_254_258": _runs([254, 255, 256, 257, 258, 259, 516, 517]),
    "trailing_run": _runs([3, 9]) + b"\x44" * 300,
    "three": b"\x01\x01\x01",
    "four": b"\x01\x01\x01\x01",
    "random": RNG.integers(0, 4, 3000, dtype=np.uint8).tobytes(),
}


# -- v2 containers ----------------------------------------------------------

def _headers():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7):
        bits = tuple(int(b) for b in rng.integers(0, 1 << 40, n))
        yield dict(flags=int(rng.choice([0, 0x80, 0x40, 0xC0])),
                   orig_size=int(rng.integers(0, 1 << 40)),
                   symbol_count=int(rng.integers(0, 1 << 40)),
                   chunk_size=int(rng.integers(1, 1 << 31)),
                   chunk_bits=bits), \
            rng.integers(0, 256, int(rng.integers(0, 40)),
                         dtype=np.uint8).tobytes()


@pytest.mark.parametrize("k", range(3))
def test_v2_container_bytes_and_fields_equal_jax(k):
    fields, payload = list(_headers())[k]
    jblob = jfmt.make_v2_container(jfmt.V2Header(**fields), payload)
    tblob = tfmt.make_v2_container(tfmt.V2Header(**fields), payload)
    assert tblob == jblob
    assert tfmt.V2Header(**fields).n_chunks == len(fields["chunk_bits"])
    # each package parses the other's blob into the same fields
    th, tp = tfmt.parse_v2_container(jblob)
    jh, jp = jfmt.parse_v2_container(tblob)
    assert dataclasses.astuple(th) == dataclasses.astuple(jh)
    assert tp == jp == payload
    assert th.n_chunks == jh.n_chunks


@pytest.mark.parametrize("use_diff", [False, True])
def test_v2_parse_native_blobs(use_diff):
    data = _gradient(70_000, 3).tobytes()
    for blob in (tnative.v2_compress(data, use_diff=use_diff,
                                     chunk_size=16384),
                 jrt.v2_compress(data, use_diff=use_diff, chunk_size=16384)):
        th, tp = tfmt.parse_v2_container(blob)
        jh, jp = jfmt.parse_v2_container(blob)
        assert dataclasses.astuple(th) == dataclasses.astuple(jh)
        assert tp == jp
        assert th.orig_size == len(data)
        assert th.n_chunks == -(-th.symbol_count // th.chunk_size)
        assert sum(-(-b // 8) for b in th.chunk_bits) == len(tp)
        assert tfmt.make_v2_container(th, tp) == blob
        assert tnative.v2_decompress(blob) == data


def _raises(fn, blob):
    try:
        fn(blob)
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e), str(e)
    return None


def test_v2_parse_errors_equal_jax():
    good = tfmt.make_v2_container(
        tfmt.V2Header(0x80, 100, 90, 64, (300, 200)), b"x" * 63)
    bad = {
        "v1": b"\x10" + b"\x00" * 8,
        "empty": b"",
        "wrong_version": good[:6] + b"\x02" + good[7:],
        "magic_only": good[:6],
        "short_header": good[:20],
        "short_manifest": good[:40],
    }
    for name, blob in bad.items():
        want = _raises(jfmt.parse_v2_container, blob)
        assert want is not None, name
        assert _raises(tfmt.parse_v2_container, blob) == want, name
    assert _raises(tfmt.parse_v2_container, good[:32 + 16]) is None
    assert _raises(tfmt.parse_v2_container, bad["v1"])[0] is ValueError
    assert _raises(tfmt.parse_v2_container, bad["short_header"])[0] \
        is struct.error


# -- the host runtime's byte RLE --------------------------------------------

@pytest.mark.parametrize("name", sorted(RLE_CASES))
def test_native_rle_equals_jax_and_pyref(name):
    data = RLE_CASES[name]
    enc = tnative.rle_encode(data)
    assert enc == jrt.rle_encode(data) == bytes(jpyrle.rle_encode(data)) \
        == bytes(tpyrle.rle_encode(data))
    assert tnative.rle_decode(enc) == jrt.rle_decode(enc) == data
    # a stream cut anywhere (also between the three literals of a run and
    # its count byte) decodes as the serial decoder and JAX's runtime do
    for cut in sorted({1, len(enc) // 2, len(enc) - 1} - {0}):
        if cut < len(enc):
            got = tnative.rle_decode(enc[:cut])
            assert got == jrt.rle_decode(enc[:cut]) == bytes(
                jpyrle.rle_decode(enc[:cut])[0])


def test_native_available_and_exports():
    assert tnative.available() is True
    assert tnative.NativeError is tnative.runtime.NativeError
    with pytest.raises(tnative.NativeError) as got:
        tnative.v1_decompress(b"\x01")
    with pytest.raises(jrt.NativeError) as want:
        jrt.v1_decompress(b"\x01")
    assert got.value.code == want.value.code


# -- the card's oracle for kernels 1 and 6 -----------------------------------

def _oracle_streams(x: np.ndarray, cs: int, n: int, use_diff: bool):
    """The host runtime's MNP-5 stream of each chunk of the first ``n``
    bytes of ``x``, diffed with numpy from the byte before the chunk (0
    for the first): the rule ``chip_smoke.py`` holds kernel 1 to."""
    out = []
    for c in range(-(-n // cs)):
        chunk = x[c * cs: min(n, (c + 1) * cs)]
        if use_diff:
            carry = x[c * cs - 1] if c else 0
            chunk = np.diff(chunk, prepend=np.uint8(carry)).astype(np.uint8)
        out.append(tnative.rle_encode(chunk.tobytes()))
    return out


@pytest.mark.parametrize("use_diff", [False, True])
def test_plain_kernel1_and_6_equal_native_oracle(use_diff):
    cs, step, lane = 2048, 3, 128
    n = cs * 7 + 555  # three steps, a partial last chunk
    x = _gradient(n, 17)
    x[3000:3400] = 200  # a run across no boundary; runs of 254-258 below
    x[cs * 2 - 130: cs * 2 + 128] = 33  # a run across a chunk boundary
    want = _oracle_streams(x, cs, n, use_diff)
    cap = CANONICAL.cap(cs, lane)
    buf = np.zeros(cs * step * 3, np.uint8)
    buf[:n] = x
    for k in range(3):
        seg = torch.from_numpy(buf[k * step * cs:(k + 1) * step * cs].copy())
        length = min(n - k * step * cs, step * cs)
        carry0 = int(x[k * step * cs - 1]) if k else 0
        *_, rl, car = encode_sharded_stage(seg, length, carry0, use_diff,
                                           cs, step, lane)
        ins = torch.tensor([max(0, min(cs, length - c * cs))
                            for c in range(step)], dtype=torch.int32)
        st, ln = K.rle_diff_encode(seg.view(step, cs), ins, car, use_diff,
                                   cap)
        assert torch.equal(ln, rl)
        for c in range(step):
            g = k * step + c
            if g * cs >= n:
                assert int(rl[c]) == 0
                continue
            # the stage's carry is the byte before the chunk
            assert int(car[c]) == (int(x[g * cs - 1]) if g else 0)
            s = st[c, :int(ln[c])].numpy().tobytes()
            assert s == want[g], (k, c)
            # kernel 6's oracle: the runtime's decode, diff-reverted
            dec = np.frombuffer(tnative.rle_decode(s), np.uint8)
            if use_diff:
                dec = ((np.cumsum(dec, dtype=np.int64) + int(car[c]))
                       & 255).astype(np.uint8)
            out = K.rle_expand(st[c:c + 1], ln[c:c + 1], car[c:c + 1], cs,
                               use_diff)
            m = int(ins[c])
            assert out[0, :m].numpy().tobytes() == dec.tobytes() \
                == x[g * cs: g * cs + m].tobytes()


# -- the 1-D RLE ops ---------------------------------------------------------

RLE_OP_INPUT = np.frombuffer(
    RLE_CASES["runs_254_258"] + RLE_CASES["trailing_run"][:700]
    + RLE_CASES["random"][:600], np.uint8)


def test_rle_ops_1d_equal_jax():
    x = RLE_OP_INPUT
    n = x.shape[0]
    xt = torch.from_numpy(x.copy())
    # defaults: the whole row, out_len = rle_max_encoded_len(n)
    js, jt = jops.rle_encode(jnp.asarray(x))
    ts, tt = tops.rle_encode(xt)
    assert ts.shape == (tops.rle_max_encoded_len(n),) and tt.dim() == 0
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert int(tt) == int(jt)
    # a length and an out_len
    js2, jt2 = jops.rle_encode(jnp.asarray(x), 1000, out_len=900)
    ts2, tt2 = tops.rle_encode(xt, torch.tensor(1000), out_len=900)
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(js2))
    assert int(tt2) == int(jt2)
    assert int(tops.rle_encoded_size(xt, 1000)) == int(
        jops.rle_encoded_size(jnp.asarray(x), 1000)) == int(jt2)
    # decode with the defaults (length None, block 512)
    m = int(tt)
    out_len = n + 16
    jd, jm = jops.rle_decode(js, m, out_len=out_len)
    td, tm = tops.rle_decode(ts, m, out_len=out_len)
    assert td.shape == (out_len,) and tm.dim() == 0
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert int(tm) == int(jm) == n
    np.testing.assert_array_equal(td[:n].numpy(), x)
    jd2, jm2 = jops.rle_decode(js[:m], out_len=out_len)
    td2, tm2 = tops.rle_decode(ts[:m], out_len=out_len)
    np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))
    assert int(tm2) == int(jm2)


def test_rle_ops_small_and_empty_equal_jax():
    for data in (b"", b"\x05"):
        x = np.frombuffer(data, np.uint8)
        js, jt = jops.rle_encode(jnp.asarray(x))
        ts, tt = tops.rle_encode(torch.from_numpy(x.copy()))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert int(tt) == int(jt) == len(data)


def test_rle_decode_errors_equal_jax():
    x = torch.zeros(8, dtype=torch.uint8)
    for kw in (dict(out_len=0), dict(out_len=-1), dict(out_len=8, block=1)):
        with pytest.raises(ValueError) as want:
            jops.rle_decode(jnp.zeros(8, jnp.uint8), **kw)
        with pytest.raises(ValueError) as got:
            tops.rle_decode(x, **kw)
        assert str(got.value) == str(want.value)


def test_rle_ops_batched_forms_unchanged():
    """The (C, n) forms the codec calls give each row's 1-D result, and
    the classification does not depend on its block."""
    rows = np.stack([RLE_OP_INPUT[:1500], RLE_OP_INPUT[600:2100],
                     np.full(1500, 3, np.uint8)])
    lens = torch.tensor([1500, 1111, 777])
    xt = torch.from_numpy(rows.copy())
    cap = trle.rle_max_encoded_len(1500)
    st, tl = tops.rle_encode(xt, lens, cap)
    assert st.shape == (3, cap) and tl.dtype == torch.int32
    sizes = tops.rle_encoded_size(xt, lens)
    assert sizes.shape == (3,)
    for c in range(3):
        s1, t1 = tops.rle_encode(xt[c], lens[c], cap)
        assert torch.equal(st[c], s1) and int(tl[c]) == int(t1) \
            == int(sizes[c])
        assert st[c, :int(t1)].numpy().tobytes() == bytes(
            tpyrle.rle_encode(rows[c, :int(lens[c])].tobytes()))
    flags = [trle.rle_classify(st, tl, block) for block in (2, 32, 512)]
    assert all(torch.equal(f, flags[0]) for f in flags)
    dec, dl = tops.rle_decode(st, tl, 1500, block=trle.CLASSIFY_BLOCK)
    for c in range(3):
        m = int(lens[c])
        assert int(dl[c]) == m
        assert torch.equal(dec[c, :m], xt[c, :m])


# -- code lengths ------------------------------------------------------------

def _count_rows() -> np.ndarray:
    rng = np.random.default_rng(31)
    fib = [1, 1]
    while len(fib) < 26:
        fib.append(fib[-1] + fib[-2])
    edge = np.zeros((5, 256), np.int64)
    edge[1, 200] = 1000  # one symbol
    edge[2, [3, 250]] = [5, 9]  # two symbols
    edge[3] = 4096  # 256 equal counts
    edge[4, 17:17 + len(fib)] = fib  # Fibonacci: the deepest tree
    seeded = np.stack([
        rng.integers(0, 1000, 256),
        rng.integers(0, 60, 256) * (rng.random(256) < 0.4),
        rng.geometric(0.03, 256),
        np.where(rng.random(256) < 0.1, rng.integers(1, 8, 256), 0),
    ])
    return np.concatenate([edge, seeded]).astype(np.int32)  # row 0: zeros


@pytest.mark.parametrize("name", ["build_lengths_exact",
                                  "build_lengths_kraft"])
def test_code_lengths_equal_jax(name):
    counts = _count_rows()
    want = np.asarray(getattr(jcan, name)(jnp.asarray(counts)))
    got = getattr(tcan, name)(torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), want)
    # a prefix code: Kraft's sum is at most 1 on every row
    g = got.numpy()
    kraft = np.where(g > 0, 2.0 ** -g.astype(np.float64), 0).sum(axis=1)
    assert (kraft <= 1.0).all()


def test_exact_and_package_merge_costs_equal():
    counts = torch.from_numpy(_count_rows())
    exact = tcan.build_lengths_exact(counts)
    pm = tcan.build_lengths(counts)
    assert tcan.build_lengths is tcan.build_lengths_pm
    assert torch.equal((exact * counts).sum(1), (pm * counts).sum(1))


# -- the one-chunk FGK forms -------------------------------------------------

def test_fgk_chunk_forms_equal_jax():
    x = _gradient(2048, 8)
    x[100:500] = 4
    n_words = tfgk.n_words_for(2048)
    length = 2000
    jw, jb = jfgk.fgk_encode_chunk(jnp.asarray(x), jnp.int32(length),
                                   n_words)
    tw, tb = tfgk.fgk_encode_chunk(torch.from_numpy(x.copy()), length,
                                   n_words)
    assert tw.shape == (n_words,) and tb.dim() == 0
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).view(np.int32))
    assert int(tb) == int(jb)
    jd = jfgk.fgk_decode_chunk(jw, jnp.int32(length), out_len=2048)
    td = tfgk.fgk_decode_chunk(tw, length, out_len=2048)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(td[:length].numpy(), x[:length])
    assert not td[length:].any()
    for bad in (0, -3):
        with pytest.raises(ValueError):
            tfgk.fgk_decode_chunk(tw, length, out_len=bad)


def test_pack_codes_max_len_equal_jax():
    """``max_len`` <= 32 cuts codes into two words and reads ``lo`` only,
    as the JAX package's ``pack_codes`` does."""
    rng = np.random.default_rng(4)
    n = 300
    lens = rng.integers(1, 33, n).astype(np.int32)
    lens[-20:] = 0
    lo = (rng.integers(0, 1 << 32, n, dtype=np.uint64)
          & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)))
    lo = np.where(lens > 0, lo, 0).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    nw = int(lens.sum()) // 32 + 2
    for max_len in (32, 64):
        h = hi if max_len == 32 else np.zeros_like(hi)
        jw, jt = jpack.pack_codes(jnp.asarray(lo), jnp.asarray(h),
                                  jnp.asarray(lens), nw, max_len=max_len)
        tw, tt = pack_codes(torch.from_numpy(lo.astype(np.int64)),
                            torch.from_numpy(h.astype(np.int64)),
                            torch.from_numpy(lens), nw, max_len=max_len)
        np.testing.assert_array_equal(tw.numpy(),
                                      np.asarray(jw).view(np.int32))
        assert int(tt) == int(jt)
