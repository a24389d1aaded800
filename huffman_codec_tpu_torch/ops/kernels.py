"""The six hand-written CUDA kernels of the sharded canonical round trip.

Each kernel has three parts here:

* a wrapper that launches the kernel for CUDA tensors and adds one to its
  ``launches`` count per launch. Given CPU tensors it runs the plain
  version instead (that is the only case it does); any other device, a
  wrong dtype, shape or layout raises;
* the plain PyTorch version of the same function, vectorised so that it
  also runs at full size on the card, where ``chip_smoke.py`` holds the
  kernel against it;
* the launch count.

The kernels' sources are ``csrc/<name>.cu``; each says which TPU kernel
it replaces, what bounds it on the H100 and what its design does about
that. Words of the canonical bitstream are u32 on the wire; tensors carry
them as int32 holding the same bits.
"""

from __future__ import annotations

import torch

from huffman_codec_tpu_torch.ops import _build
from huffman_codec_tpu_torch.ops import rle as _rle
from huffman_codec_tpu_torch.ops.diff import diff_apply, diff_revert

N_SYM = 256
MASK26 = (1 << 26) - 1


def lane_words_cap(lane: int) -> int:
    """Output words per lane: codes are <= 31 bits, rounded to a
    128-word multiple (the v3 wire's worst-case lane stride)."""
    return -(-(lane * 31 // 32 + 1) // 128) * 128


def _to_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors holding the same bits."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------


def _check_cuda(name: str, *specs):
    """specs: (tensor, dtype, ndim). All on one CUDA device, contiguous."""
    dev = specs[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU (plain "
                         f"version) or a CUDA device, got {dev}")
    for t, dtype, ndim in specs:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name}: expected a {ndim}-d {dtype} tensor, "
                             f"got {t.dim()}-d {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")
    return dev


def _launch(src: str, symbol: str, ptrs, ints, dev):
    fn = _build.bind(src, symbol, len(ptrs), len(ints))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*[t.data_ptr() for t in ptrs], *[int(i) for i in ints], stream)
    if err:
        raise RuntimeError(f"{symbol}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# 1. fused diff + MNP-5 RLE encode
# ---------------------------------------------------------------------------


def rle_diff_encode_plain(chunks, lengths, carries, use_diff: bool, cap: int):
    work = diff_apply(chunks, carries) if use_diff else chunks
    return _rle.rle_encode(work, lengths, cap)


def rle_diff_encode(chunks: torch.Tensor, lengths: torch.Tensor,
                    carries: torch.Tensor, use_diff: bool, cap: int):
    """Per-chunk diff (seeded by ``carries``) then MNP-5 encode.

    chunks (C, n) uint8, lengths (C,) int32 valid bytes, carries (C,)
    uint8. Returns (streams (C, cap) uint8, zero past each end; encoded
    lengths (C,) int32). CUDA needs n % 16 == 0."""
    if chunks.device.type == "cpu":
        return rle_diff_encode_plain(chunks, lengths, carries, use_diff, cap)
    dev = _check_cuda("rle_diff_encode", (chunks, torch.uint8, 2),
                      (lengths, torch.int32, 1), (carries, torch.uint8, 1))
    C, n = chunks.shape
    if n % 16:
        raise ValueError("rle_diff_encode: chunk length must divide by 16")
    streams = torch.empty((C, cap), dtype=torch.uint8, device=dev)
    out_lens = torch.empty((C,), dtype=torch.int32, device=dev)
    if C:
        _launch("rle_encode", "rle_encode_launch",
                (chunks, lengths, carries, streams, out_lens),
                (C, n, cap, int(use_diff)), dev)
        rle_diff_encode.launches += 1
    return streams, out_lens


rle_diff_encode.launches = 0


# ---------------------------------------------------------------------------
# 2. byte histogram of each chunk's valid prefix
# ---------------------------------------------------------------------------


def histogram256_plain(data, lengths):
    C, L = data.shape
    pos = torch.arange(L, device=data.device)[None, :]
    valid = pos < lengths.to(torch.int64)[:, None]
    idx = torch.where(valid, data.to(torch.int64), N_SYM)  # N_SYM: dropped
    idx = idx + torch.arange(C, device=data.device)[:, None] * (N_SYM + 1)
    counts = torch.bincount(idx.reshape(-1), minlength=C * (N_SYM + 1))
    return counts.view(C, N_SYM + 1)[:, :N_SYM].to(torch.int32)


def histogram256(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(C, 256) int32 byte counts of each (C, L) uint8 row's first
    ``lengths[c]`` bytes. CUDA needs L % 16 == 0."""
    if data.device.type == "cpu":
        return histogram256_plain(data, lengths)
    dev = _check_cuda("histogram256", (data, torch.uint8, 2),
                      (lengths, torch.int32, 1))
    C, L = data.shape
    if L % 16:
        raise ValueError("histogram256: row length must divide by 16")
    out = torch.empty((C, N_SYM), dtype=torch.int32, device=dev)
    if C:
        _launch("histogram", "histogram_launch", (data, lengths, out),
                (C, L), dev)
        histogram256.launches += 1
    return out


histogram256.launches = 0


# ---------------------------------------------------------------------------
# 3. canonical lane pack
# ---------------------------------------------------------------------------


def lane_pack_plain(data, lengths, tables, lane: int):
    C, L = data.shape
    nl, W = L // lane, lane_words_cap(lane)
    dev = data.device
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < lengths.to(torch.int64)[:, None]
    per = torch.gather(tables.to(torch.int64) & 0xFFFFFFFF, 1,
                       data.to(torch.int64))
    per = torch.where(valid, per, 0).view(C, nl, lane)
    code, ln = per & MASK26, per >> 26
    incl = torch.cumsum(ln, dim=2)
    off = incl - ln
    bits = incl[:, :, -1]
    # each code as a 64-bit window starting at word off >> 5, MSB first
    sh = torch.where(ln > 0, 64 - (off & 31) - ln, 0)
    win = code << sh
    w0 = off >> 5
    row = (torch.arange(C * nl, device=dev) * (W + 1)).view(C, nl, 1)
    acc = torch.zeros(C * nl * (W + 1), dtype=torch.int64, device=dev)
    # contributions to one word have disjoint bits, so add == or
    acc.scatter_add_(0, (row + w0).reshape(-1),
                     ((win >> 32) & 0xFFFFFFFF).reshape(-1))
    acc.scatter_add_(0, (row + w0 + 1).reshape(-1),
                     (win & 0xFFFFFFFF).reshape(-1))
    words = _to_i32_bits(acc).view(C, nl, W + 1)[:, :, :W].clone()
    words[:, :, W - 1] = 0  # the TPU wrapper's bit-count column
    return words, bits.to(torch.int32)


def lane_pack(data: torch.Tensor, lengths: torch.Tensor,
              tables: torch.Tensor, lane: int):
    """Canonical encode of (C, L) uint8 rows into word-aligned lanes.

    tables (C, 256) int32: ``code | len << 26`` per symbol. Lane k of a
    chunk holds symbols [k*lane, (k+1)*lane) packed MSB-first. Returns
    (words (C, L/lane, lane_words_cap(lane)) int32 zero-padded, bits
    (C, L/lane) int32). CUDA needs lane % 16 == 0."""
    if data.device.type == "cpu":
        return lane_pack_plain(data, lengths, tables, lane)
    dev = _check_cuda("lane_pack", (data, torch.uint8, 2),
                      (lengths, torch.int32, 1), (tables, torch.int32, 2))
    C, L = data.shape
    if L % lane or lane % 16:
        raise ValueError("lane_pack: L must divide by lane, lane by 16")
    nl, W = L // lane, lane_words_cap(lane)
    words = torch.empty((C, nl, W), dtype=torch.int32, device=dev)
    bits = torch.empty((C, nl), dtype=torch.int32, device=dev)
    if C:
        _launch("lane_pack", "lane_pack_launch",
                (data, lengths, tables, words, bits), (C, L, lane, W), dev)
        lane_pack.launches += 1
    return words, bits


lane_pack.launches = 0


# ---------------------------------------------------------------------------
# 4. repad: dense wire words -> fixed-stride lane layout
# ---------------------------------------------------------------------------


def repad_words_plain(flat, lane_words, wb: int):
    C, nl = lane_words.shape
    dev = flat.device
    lw = lane_words.to(torch.int64).reshape(-1)
    start = torch.cumsum(lw, 0) - lw
    total = int(lw.sum())
    lid = torch.repeat_interleave(torch.arange(C * nl, device=dev), lw)
    i = torch.arange(total, device=dev)
    j = i - torch.repeat_interleave(start, lw)
    keep = (j < wb) & (i < flat.numel())
    out = torch.zeros(C * nl * wb, dtype=torch.int32, device=dev)
    out[(lid * wb + j)[keep]] = flat[i[keep]]
    return out.view(C, nl * wb)


def repad_words(flat: torch.Tensor, lane_words: torch.Tensor,
                wb: int) -> torch.Tensor:
    """Dense wire words of a step's chunks (flat (N,) int32, chunk after
    chunk, lane after lane) -> (C, nl * wb) int32 with lane k of chunk c at
    columns [k*wb, k*wb + lane_words[c, k]); every other slot is 0."""
    if flat.device.type == "cpu":
        return repad_words_plain(flat, lane_words, wb)
    dev = _check_cuda("repad_words", (flat, torch.int32, 1),
                      (lane_words, torch.int32, 2))
    C, nl = lane_words.shape
    out = torch.empty((C, nl * wb), dtype=torch.int32, device=dev)
    if C:
        _launch("repad", "repad_launch", (flat, lane_words, out),
                (C, nl, wb, flat.numel()), dev)
        repad_words.launches += 1
    return out


repad_words.launches = 0


# ---------------------------------------------------------------------------
# 5. canonical lane decode
# ---------------------------------------------------------------------------


def decode_tables(lens_tables: torch.Tensor, max_len: int):
    """Per-chunk (bound, base, canon_syms) of a canonical code: a codeword
    of length l has prefix value v < bound[l], and its symbol is
    canon_syms[base[l] + v]. bound/base are (C, max_len) for l = 1..max_len."""
    from huffman_codec_tpu_torch.ops.canonical import canonical_tables

    first_code, start_index, canon_syms = canonical_tables(
        lens_tables.to(torch.int64))
    bl_count = torch.diff(start_index, dim=1)
    bound = first_code[:, 1:max_len + 1] + bl_count[:, 1:max_len + 1]
    base = start_index[:, 1:max_len + 1] - first_code[:, 1:max_len + 1]
    return bound, base, canon_syms


def lane_decode_plain(buf, lens_tables, lengths, lane: int, max_len: int):
    C, nl, wb = buf.shape
    dev = buf.device
    bound, base, canon = decode_tables(lens_tables, max_len)
    n = C * nl
    rep = torch.arange(C, device=dev).repeat_interleave(nl)
    bound, base, canon = bound[rep], base[rep], canon[rep]
    words = buf.reshape(n, wb).to(torch.int64) & 0xFFFFFFFF
    ns = (lengths.to(torch.int64)[:, None]
          - torch.arange(nl, device=dev)[None, :] * lane).clamp(0, lane)
    ns = ns.reshape(n)
    lvec = torch.arange(1, max_len + 1, device=dev)[None, :]
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    out = torch.zeros((n, lane), dtype=torch.uint8, device=dev)

    def word(i):
        got = torch.gather(words, 1, i.clamp(max=wb - 1)[:, None])[:, 0]
        return torch.where(i < wb, got, 0)

    for k in range(lane):
        i, r = pos >> 5, pos & 31
        win = (((word(i) << 32) | word(i + 1)) >> (32 - r)) & 0xFFFFFFFF
        v = win[:, None] >> (32 - lvec)
        sel = v < bound
        has = sel.any(dim=1)
        first = sel.to(torch.int32).argmax(dim=1, keepdim=True)
        ln = torch.where(has, first[:, 0] + 1, 0)
        idx = torch.where(has, torch.gather(base + v, 1, first)[:, 0], 0)
        sym = torch.gather(canon, 1, idx.clamp(0, N_SYM - 1)[:, None])[:, 0]
        active = k < ns
        out[:, k] = torch.where(active, sym, 0).to(torch.uint8)
        pos = pos + torch.where(active, ln, 0)
    return out.view(C, nl * lane)


def lane_decode(buf: torch.Tensor, lens_tables: torch.Tensor,
                lengths: torch.Tensor, lane: int, max_len: int = 31):
    """Canonical decode of padded lanes (C, nl, wb) int32 with (C, 256)
    uint8 code lengths; lane k decodes clip(lengths[c] - k*lane, 0, lane)
    symbols. Returns (C, nl * lane) uint8, zero past each lane's symbols.
    CUDA needs lane % 4 == 0 and 1 <= max_len <= 31."""
    if buf.device.type == "cpu":
        return lane_decode_plain(buf, lens_tables, lengths, lane, max_len)
    dev = _check_cuda("lane_decode", (buf, torch.int32, 3),
                      (lens_tables, torch.uint8, 2), (lengths, torch.int32, 1))
    C, nl, wb = buf.shape
    if lane % 4 or not 1 <= max_len <= 31:
        raise ValueError("lane_decode: lane must divide by 4, 1 <= max_len "
                         "<= 31")
    out = torch.empty((C, nl * lane), dtype=torch.uint8, device=dev)
    if C:
        _launch("lane_decode", "lane_decode_launch",
                (buf, lens_tables, lengths, out), (C, nl, wb, lane, max_len),
                dev)
        lane_decode.launches += 1
    return out


lane_decode.launches = 0


# ---------------------------------------------------------------------------
# 6. MNP-5 expansion + diff revert
# ---------------------------------------------------------------------------


def rle_expand_plain(streams, is_cnt, lengths, carries, out_len: int,
                     use_diff: bool):
    out, total = _rle.rle_expand_runs(streams, is_cnt, lengths, out_len)
    if use_diff:
        j = torch.arange(out_len, device=streams.device)[None, :]
        out = torch.where(j < total[:, None], diff_revert(out, carries), 0)
    return out.to(torch.uint8)


def rle_expand(streams: torch.Tensor, is_cnt: torch.Tensor,
               lengths: torch.Tensor, carries: torch.Tensor, out_len: int,
               use_diff: bool) -> torch.Tensor:
    """MNP-5 expansion of (C, n) uint8 streams given their count-byte
    flags (C, n) bool (ops/rle.rle_classify), with the per-chunk diff
    revert seeded by ``carries`` when ``use_diff``. Returns (C, out_len)
    uint8, zero past each chunk's decoded length."""
    if streams.device.type == "cpu":
        return rle_expand_plain(streams, is_cnt, lengths, carries, out_len,
                                use_diff)
    dev = _check_cuda("rle_expand", (streams, torch.uint8, 2),
                      (is_cnt, torch.bool, 2), (lengths, torch.int32, 1),
                      (carries, torch.uint8, 1))
    C, n = streams.shape
    if is_cnt.shape != streams.shape:
        raise ValueError("rle_expand: is_cnt must match the streams' shape")
    out = torch.empty((C, out_len), dtype=torch.uint8, device=dev)
    if C:
        _launch("rle_expand", "rle_expand_launch",
                (streams, is_cnt, lengths, carries, out),
                (C, n, out_len, int(use_diff)), dev)
        rle_expand.launches += 1
    return out


rle_expand.launches = 0


KERNELS = (rle_diff_encode, histogram256, lane_pack, repad_words,
           lane_decode, rle_expand)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
