"""Canonical Huffman coding of chunked symbol streams in plain PyTorch,
written from the format's rules and not from the program.

A chunk's code lengths are judged, not rebuilt: every symbol present has a
length and no absent one does, the lengths fill the code space exactly
(Kraft sum 1; 1/2 for a chunk of one symbol, whose length is 1), and the
chunk's coded bits equal the optimal Huffman cost of its histogram
(``optimal_cost``, a heap merge). Optimal codes tie in many ways and the
wire fixes one of them; the check holds the cost, which every optimal
code shares. No chunk here is long enough for an optimal code to pass 31
bits (that needs a Fibonacci-sized count, over 3.5 million symbols), so
the wire's length limit never binds.

Codes are canonical (RFC 1951): ascending (length, symbol), the first
code of each length ``(first[l - 1] + count[l - 1]) << 1``. A lane of
``lane`` symbols is its codes laid end to end, MSB first, in big-endian
32-bit words, zero padded; the payload is every used lane's words, lane
after lane and chunk after chunk.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

MAX_LEN = 31


def histograms(sym: torch.Tensor, chunk_of: torch.Tensor,
               n_chunks: int) -> torch.Tensor:
    """(n_chunks, 256) int64 counts of each chunk's symbols."""
    h = torch.zeros(n_chunks * 256, dtype=torch.int64, device=sym.device)
    h.scatter_add_(0, chunk_of * 256 + sym.to(torch.int64),
                   torch.ones_like(chunk_of))
    return h.view(n_chunks, 256)


def optimal_cost(counts: np.ndarray) -> int:
    """Bits of an optimal prefix code for one histogram (the sum of the
    merged weights of a Huffman merge); a lone symbol costs a bit each."""
    w = [int(c) for c in counts if c > 0]
    if len(w) < 2:
        return sum(w)
    heapq.heapify(w)
    cost = 0
    while len(w) > 1:
        s = heapq.heappop(w) + heapq.heappop(w)
        cost += s
        heapq.heappush(w, s)
    return cost


def bad_tables(lens: torch.Tensor, hist: torch.Tensor) -> int:
    """Chunks whose code lengths (n_chunks, 256) are not an optimal
    complete prefix code of their histograms."""
    lens = lens.to(torch.int64)
    present = hist > 0
    n = present.sum(dim=1)
    wrong = ((lens > 0) != present).any(dim=1) | (lens > MAX_LEN).any(dim=1)
    kraft = torch.where(present, 1 << (MAX_LEN - lens.clamp(1, MAX_LEN)),
                        0).sum(dim=1)
    want = torch.where(n == 1, 1 << (MAX_LEN - 1), 1 << MAX_LEN)
    wrong |= (kraft != want) & (n > 0)
    cost = (hist * lens).sum(dim=1).cpu().numpy()
    h = hist.cpu().numpy()
    wrong_cost = [cost[c] != optimal_cost(h[c]) for c in range(h.shape[0])]
    return int((wrong.cpu().numpy() | np.asarray(wrong_cost, bool)).sum())


def codes_every_symbol(lens: torch.Tensor, hist: torch.Tensor) -> bool:
    """Whether every symbol present has a length of 1 to 31 bits, so that
    the lanes can be built at all (a container made for other data may
    give one none)."""
    ok = (lens >= 1) & (lens <= MAX_LEN)
    return bool(((hist == 0) | ok).all())


def canonical_codes(lens: torch.Tensor) -> torch.Tensor:
    """(n_chunks, 256) int64 canonical codes of the lengths (0 where the
    length is 0)."""
    C = lens.shape[0]
    dev = lens.device
    lens = lens.to(torch.int64)
    bl = torch.zeros((C, MAX_LEN + 2), dtype=torch.int64, device=dev)
    bl.scatter_add_(1, lens, torch.ones_like(lens))
    bl[:, 0] = 0
    first = torch.zeros_like(bl)
    for ln in range(1, MAX_LEN + 1):
        first[:, ln] = (first[:, ln - 1] + bl[:, ln - 1]) << 1
    key = torch.where(lens > 0, lens * 256 + torch.arange(256, device=dev),
                      1 << 20)
    order = torch.argsort(key, dim=1)
    lo = torch.gather(lens, 1, order)
    # rank of a symbol among those of its length
    start = torch.cumsum(bl, dim=1) - bl
    pos = torch.arange(256, device=dev).expand(C, 256)
    rank = pos - torch.gather(start, 1, lo)
    codes_sorted = torch.gather(first, 1, lo) + rank
    codes_sorted = torch.where(lo > 0, codes_sorted, 0)
    return torch.zeros_like(lens).scatter_(1, order, codes_sorted)


def lanes(sym: torch.Tensor, chunk_of: torch.Tensor, pos: torch.Tensor,
          counts: torch.Tensor, lens: torch.Tensor, lane: int):
    """The lanes of chunked symbol streams coded with ``lens``.

    ``sym`` (N,) the symbols of every chunk one after the other,
    ``chunk_of`` / ``pos`` each symbol's chunk and place in it, ``counts``
    (C,) each chunk's symbols, ``lens`` (C, 256) the code lengths. Returns
    (each used lane's words (used lanes,) int64, chunk-major; the payload
    words (total words,) int64 holding u32 bits)."""
    dev = sym.device
    codes = canonical_codes(lens)
    s = sym.to(torch.int64)
    ln = lens.to(torch.int64)[chunk_of, s]
    cd = codes[chunk_of, s]
    used = -(-counts // lane)
    lane_base = torch.cumsum(used, 0) - used
    g = lane_base[chunk_of] + pos // lane  # the symbol's lane, globally
    n_lanes = int(used.sum())
    bits = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    bits.scatter_add_(0, g, ln)
    words = (bits + 31) // 32
    word_base = torch.cumsum(words, 0) - words
    excl = torch.cumsum(ln, 0) - ln
    bit_base = torch.cumsum(bits, 0) - bits  # lane starts in ``excl``
    p = word_base[g] * 32 + (excl - bit_base[g])
    w, r = p // 32, p % 32
    sh = 32 - r - ln
    out = torch.zeros(int(words.sum()) + 1, dtype=torch.int64, device=dev)
    one = sh >= 0
    out.scatter_add_(0, w, torch.where(one, cd << sh.clamp(min=0),
                                       cd >> (-sh).clamp(min=0)))
    spill = (cd << (32 + sh).clamp(min=0, max=63)) & 0xFFFFFFFF
    out.scatter_add_(0, w + 1, torch.where(one, 0, spill))
    return words, out[:-1]


def to_wire(words: torch.Tensor) -> bytes:
    """u32 words (int64) -> big-endian bytes."""
    return words.cpu().numpy().astype(">u4").tobytes()
