"""Per-chunk two-pass canonical Huffman over (C, L) chunk rows.

Encode: byte histogram (kernel), exact length-limited code lengths by
package-merge, canonical codes, then the lane pack (kernel). Decode: one
of the two lane decode kernels over the fixed-stride lane layout (one
thread per lane, or one block per lane for few fat lanes). The code lengths
must equal the JAX package's bit for bit, since they go on the wire and
decide every codeword; ``build_lengths_pm`` therefore keeps its exact
tie rules (stable leaf order, leaf before package at equal weight).
"""

from __future__ import annotations

import torch

from huffman_codec_tpu_torch.ops import kernels

N_SYM = 256
MAX_LEN = 31  # left-justified 32-bit window decode
BIG = 0x3FFFFFFF


def histogram(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(C, 256) int32 counts of each row's valid prefix."""
    return kernels.histogram256(data, lengths.to(torch.int32))


def build_lengths_pm(counts: torch.Tensor) -> torch.Tensor:
    """Optimal prefix-code lengths (C, 256) int64, limited to MAX_LEN, by
    package-merge (coin collector).

    Level MAX_LEN holds the leaves sorted stably by count (absent symbols
    weigh BIG). Each of MAX_LEN - 1 rounds pairs adjacent items into
    packages and merges them with the leaves; an item is packed as
    ``weight << 1 | is_package`` so a leaf sorts before a package of the
    same weight, and equal packed items are interchangeable, so a plain
    sort is the merge. The first 2(n-1) items of the top level are
    selected; selected items form a prefix of every level, so walking the
    levels back down needs only the count of packages in that prefix. A
    leaf's length is the number of levels that select it. A chunk with a
    single symbol gets length 1."""
    C = counts.shape[0]
    dev = counts.device
    counts = counts.to(torch.int64)
    n = (counts > 0).sum(dim=1)
    key = torch.where(counts > 0, counts, BIG)
    leaves, order = torch.sort(key, dim=1, stable=True)
    leaf_items = leaves << 1
    pad = torch.full((C, N_SYM), (BIG << 1) | 1, dtype=torch.int64, device=dev)
    lst = torch.cat([leaf_items, pad], dim=1)
    ispkg = [lst & 1]
    for _ in range(MAX_LEN - 1):
        w = lst >> 1
        pk = (torch.clamp(w[:, 0::2] + w[:, 1::2], max=BIG) << 1) | 1
        lst = torch.sort(torch.cat([leaf_items, pk], dim=1), dim=1).values
        ispkg.append(lst & 1)
    pos2 = torch.arange(2 * N_SYM, device=dev)[None, :]
    rank = torch.arange(N_SYM, device=dev)[None, :]
    lens_sorted = torch.zeros((C, N_SYM), dtype=torch.int64, device=dev)
    m = torch.clamp(2 * (n - 1), min=0)  # items selected at level 1
    for lev in range(MAX_LEN - 1, -1, -1):  # level 1 down to level MAX_LEN
        p = (ispkg[lev] * (pos2 < m[:, None])).sum(dim=1)
        lens_sorted += (rank < (m - p)[:, None]).to(torch.int64)
        m = 2 * p
    lens_sorted = torch.where((n[:, None] == 1) & (rank == 0), 1, lens_sorted)
    return torch.zeros_like(lens_sorted).scatter_(1, order, lens_sorted)


def build_lengths_kraft(counts: torch.Tensor) -> torch.Tensor:
    """Near-optimal prefix-code lengths (C, 256) int64 without a merge:
    integer Shannon lengths, then two greedy passes that spend the Kraft
    slack on the most frequent symbols. No floats.

    1. l0 = ceil(log2(total / c)), the first l with c * 2^l >= total,
       clipped to [1, MAX_LEN]; Kraft holds by construction.
    2. Each pass: in count-descending order (ties by symbol) the lengths
       are non-decreasing, so the symbols of one length are a run of
       ranks. Working in units of 2^-31, the slack is filled length by
       length from the biggest coin (length 2, worth 2^29) down, taking
       at most ``slack >> (31 - l)`` symbols of length l; the first that
       many of each run lose one bit.

    On near-equal counts this can land about 11% over the optimal cost;
    the JAX package keeps it as a cheap approximate code."""
    C = counts.shape[0]
    dev = counts.device
    c = counts.to(torch.int64)
    present = c > 0
    total = c.sum(dim=1, keepdim=True)
    lv = torch.arange(32, device=dev)
    thr = (total + (1 << lv) - 1) >> lv  # (C, 32): ceil(total / 2^l)
    l0 = 32 - (c[:, :, None] >= thr[:, None, :]).sum(dim=2)
    lens = torch.where(present, l0.clamp(1, MAX_LEN), 0)
    order = torch.sort(-c, dim=1, stable=True).indices  # count descending
    l_s = torch.gather(lens, 1, order)
    p_s = torch.gather(present, 1, order)
    pos = torch.arange(N_SYM, device=dev)[None, :]
    for _ in range(2):
        used = torch.where(p_s, 1 << (31 - l_s), 0).sum(dim=1)
        slack = (1 << 31) - used
        k_l = ((l_s[:, :, None] == lv) & p_s[:, :, None]).sum(dim=1)
        start = torch.cumsum(k_l, dim=1) - k_l  # first rank of each length
        take = torch.zeros((C, 32), dtype=torch.int64, device=dev)
        for ln in range(2, 32):
            shift = 31 - ln
            t = torch.minimum(k_l[:, ln], slack >> shift)
            slack = slack - (t << shift)
            take[:, ln] = t
        rank = pos - torch.gather(start, 1, l_s)
        promote = p_s & (l_s > 1) & (rank < torch.gather(take, 1, l_s))
        l_s = l_s - promote.to(torch.int64)
    return torch.zeros_like(lens).scatter_(1, order, l_s)


def build_lengths_exact(counts: torch.Tensor) -> torch.Tensor:
    """Optimal prefix-code lengths (C, 256) int64 by the two-queue Huffman
    merge, with the JAX package's tie order, so the lengths (not only the
    cost) equal its ``build_lengths_exact``: leaves sorted stably by count
    (absent symbols last), and at equal weight the leaf queue's front is
    taken before the internal queue's. 255 merge steps and 255 depth steps,
    each a few gathers over the C rows. A chunk with a single symbol gets
    length 1."""
    C = counts.shape[0]
    dev = counts.device
    c = counts.to(torch.int64)
    n_sym = (c > 0).sum(dim=1)
    leaf_w, order = torch.sort(torch.where(c > 0, c, BIG), dim=1, stable=True)
    iw = torch.full((C, N_SYM), BIG, dtype=torch.int64, device=dev)
    # the merge step that made each node's parent; column N_SYM takes the
    # writes of the rows a step leaves alone
    lpar = torch.zeros((C, N_SYM + 1), dtype=torch.int64, device=dev)
    ipar = torch.zeros((C, N_SYM + 1), dtype=torch.int64, device=dev)
    li = torch.zeros(C, dtype=torch.int64, device=dev)
    ri = torch.zeros_like(li)

    def front(w, i, end):
        v = torch.gather(w, 1, i.clamp(max=N_SYM - 1)[:, None])[:, 0]
        return torch.where(i >= end, BIG, v)

    def pick(li, ri):
        lw, rw = front(leaf_w, li, n_sym), front(iw, ri, N_SYM)
        leaf = lw <= rw
        return (li + leaf, ri + ~leaf, torch.where(leaf, lw, rw), leaf)

    for t in range(N_SYM - 1):
        active = t < n_sym - 1
        li2, ri2, aw, aleaf = pick(li, ri)
        li3, ri3, bw, bleaf = pick(li2, ri2)
        iw[:, t] = torch.where(active, aw + bw, BIG)
        for q, j, is_leaf in ((lpar, li, aleaf), (lpar, li2, bleaf),
                              (ipar, ri, ~aleaf), (ipar, ri2, ~bleaf)):
            at = torch.where(active & is_leaf, j, N_SYM)
            q.scatter_(1, at[:, None], t)
        li, ri = li3, ri3

    # an internal node's depth is its parent's plus one; the root, made by
    # step n_sym - 2, is at depth 0
    depth = torch.zeros((C, N_SYM), dtype=torch.int64, device=dev)
    for t in range(N_SYM - 2, -1, -1):
        d = torch.gather(depth, 1, ipar[:, t:t + 1])[:, 0] + 1
        d = torch.where(n_sym - 2 == t, 0, d)
        depth[:, t] = torch.where(t < n_sym - 1, d, 0)
    rank = torch.arange(N_SYM, device=dev)[None, :]
    leaf_depth = torch.gather(depth, 1, lpar[:, :N_SYM]) + 1
    leaf_depth = torch.where(rank < n_sym[:, None], leaf_depth, 0)
    leaf_depth = torch.where((n_sym[:, None] == 1) & (rank == 0), 1,
                             leaf_depth)
    return torch.zeros_like(leaf_depth).scatter_(1, order, leaf_depth)


# the lengths the codec uses: package-merge, optimal cost and the wire's
# lengths; ``build_lengths_exact`` is the two-queue oracle beside it and
# ``build_lengths_kraft`` the cheap approximate one
build_lengths = build_lengths_pm


def _canon_ranks(lens: torch.Tensor):
    """Canonical order is ascending (length, symbol) with absent symbols
    (length 0) last. Returns (first_code (C, 33), start_index (C, 33),
    rank (C, 256)); first_code follows RFC 1951:
    first_code[l] = (first_code[l-1] + bl_count[l-1]) << 1."""
    C = lens.shape[0]
    dev = lens.device
    cls = torch.where(lens > 0, lens, MAX_LEN + 1).to(torch.int64)
    bl_count = torch.zeros((C, MAX_LEN + 2), dtype=torch.int64, device=dev)
    bl_count.scatter_add_(1, cls, torch.ones_like(cls))
    first_code = torch.zeros_like(bl_count)
    code = torch.zeros(C, dtype=torch.int64, device=dev)
    for ln in range(1, MAX_LEN + 2):
        code = (code + bl_count[:, ln - 1]) << 1
        first_code[:, ln] = code
    start_index = torch.cumsum(bl_count, dim=1) - bl_count
    canon = torch.sort(cls, dim=1, stable=True).indices
    rank = torch.empty_like(canon).scatter_(
        1, canon, torch.arange(N_SYM, device=dev).expand(C, N_SYM).contiguous())
    return first_code, start_index, rank, canon


def canonical_tables(lens: torch.Tensor):
    """(first_code (C, 33), start_index (C, 33), canon_syms (C, 256))."""
    first_code, start_index, _, canon = _canon_ranks(lens)
    return first_code, start_index, canon


def assign_codes(lens: torch.Tensor) -> torch.Tensor:
    """Right-aligned canonical codes (C, 256) int64:
    code(s) = first_code[l_s] + rank(s) - start_index[l_s]."""
    first_code, start_index, rank, _ = _canon_ranks(lens)
    cls = torch.where(lens > 0, lens, MAX_LEN + 1).to(torch.int64)
    fc = torch.gather(first_code, 1, cls)
    si = torch.gather(start_index, 1, cls)
    return torch.where(lens > 0, fc + rank - si, 0)


def canonical_encode_batch(data: torch.Tensor, lengths: torch.Tensor,
                           lane: int = 512):
    """Encode (C, L) uint8 rows into word-aligned lane buffers.

    Returns (lane_buf (C, n_lanes, W) int32 (u32 bits), lane_words
    (C, n_lanes) int32, lens_tables (C, 256) uint8)."""
    C, L = data.shape
    if L % lane:
        raise ValueError("chunk length must divide by the lane size")
    lengths = lengths.to(torch.int32)
    counts = histogram(data, lengths)
    lens = build_lengths_pm(counts)
    codes = assign_codes(lens)
    tables = (codes | (lens << 26)).to(torch.int32)  # < 2^31: len <= 31
    buf, bits = kernels.lane_pack(data, lengths, tables, lane)
    lane_words = (bits + 31) >> 5
    return buf, lane_words, lens.to(torch.uint8)


def canonical_decode_batch(words: torch.Tensor, lens_tables: torch.Tensor,
                           lane_words: torch.Tensor, lengths: torch.Tensor,
                           lane: int = 512, out_len: int = 0,
                           max_len: int = MAX_LEN) -> torch.Tensor:
    """Decode padded lane words (C, n_lanes * Wl) int32 back to
    (C, out_len) uint8 symbols; lane k holds symbols [k*lane, (k+1)*lane)
    of its chunk, clipped by the chunk's symbol count ``lengths``.

    Fat lanes (``lane > 4096``: the whole-file container, a few lanes of
    up to 32768 symbols) go to the block-per-lane kernel, every other
    geometry to the thread-per-lane kernel; both compute one function."""
    C, W = words.shape
    n_lanes = lane_words.shape[1]
    if out_len <= 0:
        raise ValueError("canonical_decode_batch needs out_len > 0")
    fat = lane > 4096 and lane % 128 == 0
    decode = kernels.lane_decode_lanemajor if fat else kernels.lane_decode
    out = decode(words.view(C, n_lanes, W // n_lanes), lens_tables,
                 lengths.to(torch.int32), lane=lane, max_len=max_len)
    return out[:, :out_len]
