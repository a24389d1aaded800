"""MNP-5 byte RLE as batched PyTorch ops over (C, n) chunk rows.

The reference's three format rules (a run of N >= 3 equal bytes is three
literals plus one count byte ``min(N, 258) - 3``; count byte 255 restarts
the matcher; the last input byte is always a fresh literal) collapse into
a closed-form emission rule per position. Split the row into maximal
equal-byte segments, force a break before the last valid byte, and let
``q = (i - segment_start) % 258``:

* position i emits its literal  iff q < 3;
* position i emits a count byte iff q == 257, or it ends its segment with
  q >= 2; the count value is q - 2 in both cases.

The decoder is the reference's two-field FSM (match, count <= 3). It is
run over fixed blocks of every row at once from all 8 abstract entry
states, the real entry states are resolved by composing the per-block
state maps with a doubling prefix, and a last pass classifies each byte.
The loops are over positions inside a block and over doubling rounds;
every op is vectorised over all blocks of all rows.
"""

from __future__ import annotations

import torch

RESET_CHUNK = 258  # 255 (max count byte) + 3 literals
# the port's classification block: 32 serial positions and a doubling
# prefix over the blocks beat JAX's 512 positions in torch ops
CLASSIFY_BLOCK = 32


def rle_max_encoded_len(n: int) -> int:
    """Worst case: every 3-byte run costs a count byte (4 out per 3 in)."""
    return n + n // 3 + 4


def _emissions(x: torch.Tensor, length: torch.Tensor):
    """Per-position (emit_literal, emit_count, q) of (C, n) rows whose
    valid prefixes are ``length`` (C,) long."""
    C, n = x.shape
    idx = torch.arange(n, device=x.device)[None, :]
    ln = length.to(torch.int64)[:, None]
    valid = idx < ln
    last = idx == ln - 1
    prev = torch.roll(x, 1, dims=1)
    seg_start = (idx == 0) | (x != prev) | last
    start = torch.cummax(torch.where(seg_start, idx, 0), dim=1).values
    q = (idx - start) % RESET_CHUNK
    ones = torch.ones((C, 1), dtype=torch.bool, device=x.device)
    seg_end = torch.cat([seg_start[:, 1:], ones], dim=1) | last
    emit_lit = valid & (q < 3)
    emit_cnt = valid & ((q == RESET_CHUNK - 1) | (seg_end & (q >= 2)))
    return emit_lit, emit_cnt, q


def _rows(x: torch.Tensor, length):
    """(x as (C, n) rows, the lengths as (C,) int64, whether x was one
    1-D row); ``length`` None means whole rows."""
    one = x.dim() == 1
    rows = x[None, :] if one else x
    if length is None:
        length = rows.shape[1]
    ln = torch.as_tensor(length, device=x.device).to(torch.int64)
    return rows, ln.reshape(1) if one else ln.expand(rows.shape[0]), one


def rle_encoded_size(x: torch.Tensor, length) -> torch.Tensor:
    """Encoded byte count of each (C, n) row's valid prefix, (C,) int64
    (0-d for one 1-D row): the emission rule with the writes left out, for
    the adaptive search and the scan-direction pick."""
    rows, ln, one = _rows(x, length)
    emit_lit, emit_cnt, _ = _emissions(rows, ln)
    size = emit_lit.sum(dim=1) + emit_cnt.sum(dim=1)
    return size[0] if one else size


def rle_encode(x: torch.Tensor, length=None, out_len: int | None = None):
    """MNP-5 encode of each (C, n) uint8 row's valid prefix (``length``,
    (C,) or one value; None: whole rows), or of one 1-D row. Returns
    (streams (C, out_len) uint8, zero past each row's end, and the encoded
    lengths (C,) int32); for a 1-D row the stream is (out_len,) and the
    length 0-d. ``out_len`` None means ``rle_max_encoded_len(n)``."""
    rows, ln, one = _rows(x, length)
    C, n = rows.shape
    if out_len is None:
        out_len = rle_max_encoded_len(n)
    emit_lit, emit_cnt, q = _emissions(rows, ln)
    per = emit_lit.to(torch.int64) + emit_cnt.to(torch.int64)
    off = torch.cumsum(per, dim=1) - per
    total = per.sum(dim=1)
    out = torch.zeros(C * out_len, dtype=torch.uint8, device=x.device)
    row = torch.arange(C, device=x.device)[:, None] * out_len
    out[(row + off)[emit_lit]] = rows[emit_lit]
    cnt_at = row + off + emit_lit.to(torch.int64)
    out[cnt_at[emit_cnt]] = (q - 2)[emit_cnt].to(torch.uint8)
    out, total = out.view(C, out_len), total.to(torch.int32)
    return (out[0], total[0]) if one else (out, total)


def rle_concat(rows: torch.Tensor, lens: torch.Tensor, out_len: int):
    """Concatenate the valid prefixes of (B, k, w) uint8 rows, ``lens``
    (B, k) bytes each, in order, into (B, out_len) uint8 zero past each
    end; bytes that would land past ``out_len`` are dropped. Returns the
    buffers and the totals (B,) int32."""
    B, k, w = rows.shape
    dev = rows.device
    ln = lens.to(torch.int64)
    off = torch.cumsum(ln, dim=1) - ln
    j = torch.arange(w, device=dev)
    at = off[:, :, None] + j
    kept = (j < ln[:, :, None]) & (at < out_len)
    at = at + torch.arange(B, device=dev)[:, None, None] * out_len
    out = torch.zeros(B * out_len, dtype=torch.uint8, device=dev)
    out[at[kept]] = rows[kept]
    return out.view(B, out_len), ln.sum(dim=1).to(torch.int32)


def _entry_state(entry: torch.Tensor, b0: torch.Tensor, b1: torch.Tensor):
    """Abstract entry state (0..7) -> concrete (count0, match0) given the
    block's first two bytes; match0 = -1 differs from every byte. States
    0..5 are count * 2 + (match == b0); 6 and 7 have count 3 (b0 is a
    count byte) and compare the match with b1."""
    count0 = torch.where(entry < 6, entry // 2, 3)
    eq = torch.where(entry < 6, entry % 2, entry - 6)
    cmp_byte = torch.where(entry < 6, b0, b1)
    match0 = torch.where(eq == 1, cmp_byte, -1)
    count0, match0 = torch.broadcast_tensors(count0, match0)
    return count0, match0


def _fsm_step(match, count, c):
    """One byte of the reference decoder FSM; returns (match, count,
    is_count_byte)."""
    is_cnt = count == 3
    new_match = torch.where(is_cnt, match, c)
    eq = (match == c) & ~is_cnt
    new_count = torch.where(is_cnt, 0, torch.where(eq, count + 1, 1))
    return new_match, new_count, is_cnt


def rle_classify(data: torch.Tensor, length: torch.Tensor,
                 block: int = CLASSIFY_BLOCK) -> torch.Tensor:
    """(C, n) bool: True where data[c, i] is a count byte of row c's MNP-5
    stream (i < length[c]). The result does not depend on ``block``."""
    if block < 2:
        raise ValueError("block must be >= 2")
    C, n = data.shape
    dev = data.device
    nb = -(-n // block)
    padded = torch.zeros((C, nb * block), dtype=torch.int32, device=dev)
    padded[:, :n] = data.to(torch.int32)
    blocks = padded.view(C, nb, block)
    cols = blocks.unbind(dim=2)  # block positions, each (C, nb)
    b0, b1 = cols[0], cols[1]

    # pass 1: all 8 abstract entry states of every block at once
    states = torch.arange(8, device=dev).view(8, 1, 1)
    count, match = _entry_state(states, b0[None], b1[None])
    for c in cols:
        match, count, _ = _fsm_step(match, count, c[None])
    nxt0 = torch.roll(b0, -1, dims=1)[None]
    nxt1 = torch.roll(b1, -1, dims=1)[None]
    trans = torch.where(count < 3, count * 2 + (match == nxt0).to(count.dtype),
                        6 + (match == nxt1).to(count.dtype))
    maps = trans.permute(1, 2, 0).to(torch.int64)  # (C, nb, 8): F_b

    # pass 2: P_b = F_b o ... o F_0 by doubling; block b enters in
    # P_{b-1}(0), the first block of each row in state 0
    d = 1
    while d < nb:
        comp = torch.gather(maps[:, d:], 2, maps[:, :-d])
        maps = torch.cat([maps[:, :d], comp], dim=1)
        d <<= 1
    entry = torch.cat([torch.zeros((C, 1), dtype=torch.int64, device=dev),
                       maps[:, :-1, 0]], dim=1)

    # pass 3: rerun from the real entry states and classify every byte
    count, match = _entry_state(entry, b0, b1)
    flags = []
    for c in cols:
        match, count, is_cnt = _fsm_step(match, count, c)
        flags.append(is_cnt)
    is_cnt = torch.stack(flags, dim=2).view(C, nb * block)[:, :n]
    idx = torch.arange(n, device=dev)[None, :]
    return is_cnt & (idx < length.to(torch.int64)[:, None])


def rle_expand_runs(data: torch.Tensor, is_cnt: torch.Tensor,
                    length: torch.Tensor, out_len: int):
    """Expand (C, n) MNP-5 rows given their count-byte flags: a count byte
    v becomes v repeats of the byte before it. Returns ((C, out_len) uint8,
    zero past each row's end, and the decoded lengths (C,) int64)."""
    C, n = data.shape
    dev = data.device
    x = data.to(torch.int64)
    valid = torch.arange(n, device=dev)[None, :] < length.to(torch.int64)[:, None]
    flag = is_cnt & valid
    expand = torch.where(valid, torch.where(flag, x, 1), 0)
    incl = torch.cumsum(expand, dim=1)
    total = incl[:, -1] if n else torch.zeros(C, dtype=torch.int64, device=dev)
    src = torch.where(flag, torch.roll(x, 1, dims=1), x)
    j = torch.arange(out_len, device=dev)[None, :].expand(C, out_len)
    at = torch.searchsorted(incl.contiguous(), j.contiguous(), right=True)
    out = torch.gather(src, 1, at.clamp(max=max(n - 1, 0)))
    out = torch.where(j < total[:, None], out, 0)
    return out.to(torch.uint8), total


def rle_decode(data: torch.Tensor, length=None, out_len: int = 0,
               block: int = 512):
    """Plain MNP-5 decode of (C, n) rows (``length`` (C,) or one value;
    None: whole rows), or of one 1-D row: classification in blocks of
    ``block`` bytes (the result does not depend on it), then expansion.
    Returns ((C, out_len) uint8, zero past each row's end, and the decoded
    lengths (C,)); for a 1-D row (out_len,) and a 0-d length."""
    if block < 2:
        raise ValueError("block must be >= 2")
    if out_len <= 0:
        raise ValueError("rle_decode needs a static out_len bound")
    rows, ln, one = _rows(data, length)
    out, total = rle_expand_runs(rows, rle_classify(rows, ln, block), ln,
                                 out_len)
    return (out[0], total[0]) if one else (out, total)
