"""The encode kernels' plain versions on the encode edge batches of
``huffman_codec_tpu_torch/edge_cases.py``, against the JAX package: the
RLE encoder (kernel 1 and its tile mode) against the serial reference
encoder and the Pallas kernel in interpret mode, the lane pack (kernel 3)
against ``lane_pack_xla`` and the Pallas kernel in interpret mode.

Integer codec: every comparison is exact (tolerance 0). The JAX shapes are
few and all in this module, since XLA:CPU crashes after many executables
in one process (tests/conftest.py).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from huffman_codec_tpu.ops import pallas_kernels as jpk  # noqa: E402
from huffman_codec_tpu.pyref.rle import rle_encode as serial_encode  # noqa: E402
from huffman_codec_tpu_torch.edge_cases import (  # noqa: E402
    pack_edge_rows, rle_encode_edge_rows)
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402

N = 16384
CAP = N + N // 3 + 124  # the encoder's worst case, to a multiple of 128
ROWS = rle_encode_edge_rows(N, 51)


def _t(a):
    return torch.from_numpy(np.array(a))


def _serial(chunks, lens, carries, use_diff, cap, tile=0):
    """Row by row through the serial reference encoder (the diff applied
    with numpy first), each tile alone in tile mode; zero past the end."""
    out = np.zeros((len(lens), cap), np.uint8)
    out_lens = np.zeros(len(lens), np.int32)
    for r, m in enumerate(lens):
        x = chunks[r, :m].astype(np.int64)
        if use_diff:
            x = (x - np.r_[carries[r], x[:-1]]) & 255
        step = tile or max(m, 1)
        s = b"".join(bytes(serial_encode(bytes(x[t0:t0 + step].astype(
            np.uint8)))) for t0 in range(0, m, step))
        out[r, :len(s)] = np.frombuffer(s, np.uint8)
        out_lens[r] = len(s)
    return out, out_lens


@pytest.mark.parametrize("use_diff,tile", [(False, 0), (True, 0),
                                           (False, 64), (False, 4096),
                                           (False, 16384)])
def test_rle_encode_edge_rows_match_serial_encoder(use_diff, tile):
    chunks, lens, carries = ROWS
    if tile:
        carries = np.zeros_like(carries)
    got, got_lens = K.rle_diff_encode(_t(chunks), _t(lens), _t(carries),
                                      use_diff, CAP, tile=tile)
    want, want_lens = _serial(chunks, lens, carries, use_diff, CAP, tile)
    np.testing.assert_array_equal(got_lens.numpy(), want_lens)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def rows_4096():
    """The edge rows cut to the Pallas kernel's tested width: 4096 bytes,
    lengths clipped to it (0-17, 4094, 4095 and 4096 all stay)."""
    chunks, lens, carries = ROWS
    return (np.ascontiguousarray(chunks[:, :4096]),
            np.minimum(lens, 4096).astype(np.int32), carries)


@pytest.mark.parametrize("use_diff,tile", [(False, 0), (True, 0),
                                           (False, 64)])
def test_rle_encode_edge_rows_match_pallas(rows_4096, use_diff, tile):
    chunks, lens, carries = rows_4096
    if tile:
        carries = np.zeros_like(carries)
    cap = 5504  # 4096 + 4096 // 3 + 4, to a multiple of 128
    js, jl = jpk.rle_diff_encode_fused(
        jnp.asarray(chunks), jnp.asarray(lens), jnp.asarray(carries),
        use_diff, cap, interpret=True, tile=tile)
    ts, tl = K.rle_diff_encode(_t(chunks), _t(lens), _t(carries), use_diff,
                               cap, tile=tile)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# lanes of the sharded step and the bands, the global chunked candidate,
# and the whole-file candidate's fat lanes
@pytest.mark.parametrize("lane,nl", [(512, 8), (2048, 2), (32768, 1)])
def test_lane_pack_edge_rows_match_xla(lane, nl):
    sy, ln, tables, _ = pack_edge_rows(lane, nl, 52 + lane)
    tw, tb = K.lane_pack(_t(sy), _t(ln), _t(tables), lane)
    jw, jb = jpk.lane_pack_xla(jnp.asarray(sy), jnp.asarray(ln),
                               jnp.asarray(tables.view(np.uint32)), lane)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw))
    if lane == 512:  # the Pallas kernel admits lane % 128 == 0, nl % 8 == 0
        pw, pb = jpk.lane_pack(jnp.asarray(sy), jnp.asarray(ln),
                               jnp.asarray(tables.view(np.uint32)), lane,
                               interpret=True)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(pb))
        np.testing.assert_array_equal(tw.numpy().view(np.uint32),
                                      np.asarray(pw))


def test_pack_edge_rows_reach_the_shared_code_field():
    # the depth-31 table's codes of 28-31 bits reach into the length field
    # of ``code | len << 26``: both packages read len = entry >> 26 and
    # code = entry & (2^26 - 1), so such a lane's bit count is the sum of
    # the packed fields, not of the true code lengths
    from huffman_codec_tpu_torch.ops.canonical import assign_codes

    sy, ln, tables, lt = pack_edge_rows(512, 8, 53)
    codes = assign_codes(_t(lt).to(torch.int64)).numpy()
    assert ((codes >> 26) & ~lt.astype(np.int64) & 31).any()
    _, bits = K.lane_pack(_t(sy), _t(ln), _t(tables), 512)
    valid = np.arange(sy.shape[1])[None, :] < ln[:, None]

    def lane_sums(per_sym):
        per = np.take_along_axis(per_sym, sy.astype(np.int64), 1)
        return np.where(valid, per, 0).reshape(len(ln), 8, 512).sum(axis=2)

    packed = lane_sums(tables.astype(np.int64) >> 26)
    np.testing.assert_array_equal(bits.numpy(), packed)
    assert (packed != lane_sums(lt.astype(np.int64))).any()
