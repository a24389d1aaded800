"""Edge-case inputs for the decode kernels, made with numpy from a seed.

The CPU tests (against the JAX package), the GPU tests and
``chip_smoke.py`` (kernel against plain version) all draw their edge
batches from here, and pack the lane rows through ``pack_lane_rows``, so
the three hold the kernels to the same cases.
"""

from __future__ import annotations

import numpy as np
import torch

from huffman_codec_tpu_torch.models.chunked import _strip_payload
from huffman_codec_tpu_torch.ops import kernels as K
from huffman_codec_tpu_torch.ops.canonical import assign_codes

N_SYM = 256


def _count_at(row: np.ndarray, at: int, value: int) -> None:
    """Write three equal literals and a count byte ``value`` so that the
    count byte lands at ``at`` when the run starts in a fresh state; the
    literal differs from the byte before it."""
    lit = (int(row[at - 4]) + 1) % N_SYM
    row[at - 3: at] = lit
    row[at] = value
    if at + 1 < row.size and row[at + 1] == lit:
        row[at + 1] = (lit + 1) % N_SYM


def rle_edge_rows(n: int, seed: int):
    """Run-heavy MNP-5 stream rows of width ``n`` (n >= 8192) for the
    decoder: (streams (R, n) uint8, lengths (R,) int32, carries (R,)
    uint8). Any bytes are a valid stream, so the rows are built as streams:

    * count bytes at both sides of the 16-byte segments of the kernel's
      threads and of its 4096-byte tiles, on a noise background, and
      shifted by one in a second row;
    * ``a a a 255`` repeated: every count byte 255, a run of 258 that
      restarts the matcher each time, expanding far past any out_len;
    * a three-letter alphabet: count bytes at random places, runs that
      carry the FSM across every border;
    * one literal repeated (count byte after every third literal);
    * noise, a partial row, and rows of length 0, 1 and 2."""
    if n < 8192:
        raise ValueError("rle_edge_rows needs n >= 8192")
    rng = np.random.default_rng(seed)
    rows, lens = [], []
    for shift in (0, 1):
        r = rng.integers(0, N_SYM, n, dtype=np.int64).astype(np.uint8)
        for at in (15, 31, 47, 4095, 4101, 4111, 8190):
            _count_at(r, at + shift, int(rng.integers(0, N_SYM)))
        rows.append(r)
        lens.append(n)
    rows.append(np.resize(np.array([7, 7, 7, 255], np.uint8), n))
    lens.append(n)
    rows.append(rng.integers(0, 3, n, dtype=np.int64).astype(np.uint8))
    lens.append(n)
    rows.append(np.full(n, 42, np.uint8))
    lens.append(n - 5)
    rows.append(rng.integers(0, N_SYM, n, dtype=np.int64).astype(np.uint8))
    lens.append(4097)
    for m in (0, 1, 2):
        rows.append(np.full(n, 9, np.uint8))
        lens.append(m)
    carries = rng.integers(0, N_SYM, len(rows), dtype=np.int64)
    return (np.stack(rows), np.array(lens, np.int32),
            carries.astype(np.uint8))


def lane_edge_rows(lane: int, nl: int, seed: int, depth: int = 26):
    """Symbol rows for the lane decoder, ``nl`` lanes of ``lane`` symbols
    each: (symbols (R, nl * lane) uint8, lengths (R,) int32, code lengths
    (R, 256) uint8, every table a prefix code).

    * a code of lengths 1, 2, ..., depth, depth (2 <= depth <= 26: the
      packed tables hold codes of at most 26 bits, and 26 falls in the
      max_len 31 bucket), with every symbol drawn at its code's
      probability and the two deepest symbols forced in, so codes longer
      than any prefix table occur;
    * the same table with a partial last lane;
    * a flat 8-bit code with half the lanes holding no symbol;
    * a row of no symbols, and a one-symbol table."""
    rng = np.random.default_rng(seed)
    L = nl * lane
    deep = np.zeros(N_SYM, np.uint8)
    syms = rng.permutation(N_SYM)[:depth + 1]
    deep[syms] = np.r_[np.arange(1, depth + 1), depth]
    p = 2.0 ** -deep[syms].astype(np.float64)
    p /= p.sum()
    rows, lens, tables = [], [], []
    for m in (L, L - lane + max(1, lane // 3)):
        r = rng.choice(syms, size=L, p=p).astype(np.uint8)
        r[rng.integers(0, m, 8)] = syms[-1]
        r[rng.integers(0, m, 8)] = syms[-2]
        rows.append(r)
        lens.append(m)
        tables.append(deep)
    rows.append(rng.integers(0, N_SYM, L, dtype=np.int64).astype(np.uint8))
    lens.append(L // 2 - 3)
    tables.append(np.full(N_SYM, 8, np.uint8))
    rows.append(np.zeros(L, np.uint8))
    lens.append(0)
    tables.append(np.full(N_SYM, 8, np.uint8))
    one = np.zeros(N_SYM, np.uint8)
    one[65] = 1
    rows.append(np.full(L, 65, np.uint8))
    lens.append(L)
    tables.append(one)
    return np.stack(rows), np.array(lens, np.int32), np.stack(tables)


def pack_lane_rows(sy: torch.Tensor, ln: torch.Tensor, lt: torch.Tensor,
                   lane: int, wb_pad: int | None = None) -> torch.Tensor:
    """Encode ``lane_edge_rows``'s symbols for the lane decoder: the
    canonical code of the lengths ``lt`` packed into lanes (kernel 3), each
    lane cut to its words and laid out again at ``wb`` words a lane
    (kernel 4), on the tensors' device (the plain versions on the CPU).
    ``wb`` is the codec's stride (a multiple of 16, at least 8), or the
    longest lane plus ``wb_pad`` words when that is given. Returns
    (R, nl, wb) int32."""
    lt64 = lt.to(torch.int64)
    tables = (assign_codes(lt64) | (lt64 << 26)).to(torch.int32)
    buf, bits = K.lane_pack(sy, ln, tables, lane)
    lw = ((bits + 31) >> 5).to(torch.int32)
    if wb_pad is None:
        wb = max(8, -(-int(lw.max()) // 16) * 16)
    else:
        wb = int(lw.max()) + wb_pad
    flat = _strip_payload(buf, lw).contiguous()
    return K.repad_words(flat, lw, wb).view(len(ln), -1, wb)
