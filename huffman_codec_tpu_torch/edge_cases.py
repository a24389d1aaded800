"""Edge-case inputs for the encode and decode kernels and the group walk,
made with numpy from a seed.

The CPU tests (against the JAX package), the GPU tests and
``chip_smoke.py`` (kernel against plain version) all draw their edge
batches from here, and pack the lane rows through ``pack_lane_rows``, so
the three hold the kernels to the same cases; so too the broken v1
adaptive blobs the decoders must refuse.
"""

from __future__ import annotations

import numpy as np
import torch

from huffman_codec_tpu_torch.formats import make_huff_header, pack_bits_msb
from huffman_codec_tpu_torch.models.entropy import _strip_payload
from huffman_codec_tpu_torch.ops import kernels as K
from huffman_codec_tpu_torch.ops.canonical import assign_codes
from huffman_codec_tpu_torch.pyref.fgk import fgk_encode

N_SYM = 256


def match_plain_rows():
    """The small batch every kernel of the main path is first held to:
    (chunks (6, 4096) uint8, lengths (6,) int32, carries (6,) uint8) of
    random bytes, a gradient, runs of 259 and 516 and the rest of the row,
    one symbol, two symbols over a partial length, and an empty row."""
    n = 4096
    rng = np.random.default_rng(8)
    i = np.arange(n)
    rows = [rng.integers(0, 256, n), ((i // 64) * 3 + i % 64) & 255,
            np.r_[np.full(259, 7), np.full(516, 9), np.full(n - 775, 1)],
            np.full(n, 65), rng.integers(0, 2, n), np.zeros(n)]
    return (np.stack(rows).astype(np.uint8),
            np.array([n, n, n, n, 1000, 0], np.int32),
            np.array([0, 1, 255, 65, 3, 0], np.uint8))


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


def rle_encode_edge_rows(n: int, seed: int):
    """Rows for the RLE encoder (kernel 1 and its tile mode) of width
    ``n`` (n >= 16384, a multiple of 4096, so that rows cross several of
    the kernel's 8192-byte tiles and their 16-byte groups): (chunks (R, n)
    uint8, lengths (R,) int32, carries (R,) uint8).

    * lengths 0, 1, 2, 3, 15, 16, 17, 4094, 4095, 4096, 4097, 8191, 8192,
      8193 and n on a four-letter alphabet (short runs everywhere);
    * runs of 257, 258, 259, 516 and 5000 equal bytes straddling
      4096-byte borders, on noise;
    * one byte over the whole row, and a ramp (a run of one value once
      diffed);
    * a run ending at ``length - 2`` and one ending at ``length - 1``;
    * carries 0, 255 and equal to the row's first byte among random
      ones."""
    if n < 16384 or n % 4096:
        raise ValueError("rle_encode_edge_rows needs n >= 16384, a multiple "
                         "of 4096")
    rng = np.random.default_rng(seed)
    rows, lens = [], []
    for m in (0, 1, 2, 3, 15, 16, 17, 4094, 4095, 4096, 4097, 8191, 8192,
              8193, n):
        rows.append(rng.integers(0, 4, n, dtype=np.int64).astype(np.uint8))
        lens.append(m)
    for run, border in ((257, 4096), (258, 8192), (259, 12288), (516, 4096),
                        (5000, 8192)):
        for shift in (run // 2, 1):  # across the border; ending just past it
            r = rng.integers(0, N_SYM, n, dtype=np.int64).astype(np.uint8)
            r[border - run + shift: border + shift] = 17
            rows.append(r)
            lens.append(n)
    rows.append(np.full(n, 5, np.uint8))
    lens.append(n)
    rows.append((np.arange(n) * 3 % N_SYM).astype(np.uint8))
    lens.append(n)
    for end in (2, 1):  # the run's last byte at length - end
        m = n - 1000
        r = rng.integers(0, N_SYM, n, dtype=np.int64).astype(np.uint8)
        r[m - end - 299: m - end + 1] = 9
        rows.append(r)
        lens.append(m)
    carries = rng.integers(0, N_SYM, len(rows), dtype=np.int64)
    carries[:3] = (0, 255, rows[2][0])
    carries[-4:-2] = (rows[-4][0], 255)
    return (np.stack(rows), np.array(lens, np.int32),
            carries.astype(np.uint8))


def pack_edge_rows(lane: int, nl: int, seed: int):
    """Symbol rows for the lane pack (kernel 3), ``nl`` lanes of ``lane``
    symbols: (symbols (R, nl * lane) uint8, lengths (R,) int32, tables
    (R, 256) int32 holding ``code | len << 26`` as the codec builds them,
    and the code lengths (R, 256) uint8 they were built from).

    * a code of depth 26 (lengths 1, 2, ..., 26, 26) at its symbols'
      probabilities with the six deepest symbols forced in, full and with a
      partial last lane whose length does not divide by 16;
    * the same for a code of depth 31, whose codes of 27-31 bits overlap
      the length field (both packages read ``code = entry & (2^26 - 1)``
      and ``len = entry >> 26``, and the port keeps that), and a row of
      its two deepest symbols only (31 bits a symbol, the most a lane can
      hold);
    * a flat 8-bit code with a length ending mid-lane and half the lanes
      empty; an empty row; one symbol of a one-symbol table, and a full
      row of it; one symbol in the last lane."""
    rng = np.random.default_rng(seed)
    L = nl * lane
    rows, lens, tables = [], [], []

    def deep_code(depth):
        t = np.zeros(N_SYM, np.uint8)
        syms = rng.permutation(N_SYM)[:depth + 1]
        t[syms] = np.r_[np.arange(1, depth + 1), depth]
        p = 2.0 ** -t[syms].astype(np.float64)
        return t, syms, p / p.sum()

    for depth in (26, 31):
        t, syms, p = deep_code(depth)
        for m in (L, L - lane + lane // 3 + 5):
            r = rng.choice(syms, size=L, p=p).astype(np.uint8)
            for s in syms[-6:]:  # the six deepest codes, 21-26 or 27-31 bits
                r[rng.integers(0, m, 8)] = s
            rows.append(r)
            lens.append(m)
            tables.append(t)
    rows.append(rng.choice(syms[-2:], size=L).astype(np.uint8))
    lens.append(L)
    tables.append(t)
    flat = np.full(N_SYM, 8, np.uint8)
    rows.append(rng.integers(0, N_SYM, L, dtype=np.int64).astype(np.uint8))
    lens.append(L // 2 - 3)
    tables.append(flat)
    rows.append(np.zeros(L, np.uint8))
    lens.append(0)
    tables.append(flat)
    one = np.zeros(N_SYM, np.uint8)
    one[65] = 1
    for m in (1, L):
        rows.append(np.full(L, 65, np.uint8))
        lens.append(m)
        tables.append(one)
    rows.append(rng.integers(0, N_SYM, L, dtype=np.int64).astype(np.uint8))
    lens.append(L - lane + 1)
    tables.append(flat)
    lt = torch.from_numpy(np.stack(tables)).to(torch.int64)
    packed = (assign_codes(lt) | (lt << 26)).to(torch.int32).numpy()
    return np.stack(rows), np.array(lens, np.int32), packed, np.stack(tables)


def fat_lane_rows(lane: int, seed: int, dev="cpu"):
    """One-lane chunks for the fat-lane decoder (kernel 7) on ``dev``:
    (buf (R, 1, wb) int32, code lengths (R, 256) uint8, symbol counts (R,)
    int32, max_len buckets (R,), names). Rows of one stride: a lane's words
    past its own read as 0 to the decoder, so the zero padding changes no
    symbol. Every row but the last holds ``lane`` symbols.

    * ``random-8bit``: random bytes under a flat 8-bit code;
    * ``fixed-7bit``: 128 symbols under a flat 7-bit code, whose chains
      never resynchronise at sub-sequence starts that 7 does not divide;
    * ``no-code``: a one-symbol table (every window that starts with bit 1
      holds no code) over zero bits for 5/8 of the lane and then random
      bits: the chain stops there and every later symbol is canon_syms[0];
    * ``no-code-2``: the same with two symbols of 1 and 2 bits (``0`` and
      ``10``; a window starting ``11`` holds no code), so the symbols
      before the stop are mixed and canon_syms[0] differs from the second;
    * ``deep-31``: a code of lengths 1 .. 31, 31 with symbols drawn from
      its 12 deepest codes (20-31 bits; those of 27-31 bits share the
      packed 26-bit field as the codec packs them), so codes straddle the
      sub-sequence borders;
    * ``deep-random``: random words under the same code, a chain of short
      codes that runs past the lane's last word;
    * ``gradient``: a smooth gradient under its own code, a partial lane."""
    from huffman_codec_tpu_torch.ops.canonical import build_lengths_pm

    rng = np.random.default_rng(seed)
    # (name, symbols to pack or None, count, code lengths, words or None)
    rows = []

    def flat_code(nsym, bits):
        t = np.zeros(N_SYM, np.uint8)
        t[:nsym] = bits
        return t

    def words_of(bits):  # MSB-first 32-bit words of a 0/1 array
        bits = np.r_[bits, np.zeros(-len(bits) % 32, np.uint8)]
        return np.packbits(bits.astype(np.uint8)).view(">u4").astype(
            np.uint64)

    rows.append(("random-8bit", rng.integers(0, N_SYM, lane), lane,
                 flat_code(N_SYM, 8), None))
    rows.append(("fixed-7bit", rng.integers(0, 128, lane), lane,
                 flat_code(128, 7), None))

    stop = lane * 5 // 8  # symbols before the window with no code
    one = np.zeros(N_SYM, np.uint8)
    one[65] = 1
    tail = rng.integers(0, 2, lane, dtype=np.uint8)
    rows.append(("no-code", None, lane, one,
                 words_of(np.r_[np.zeros(stop, np.uint8), 1, tail])))
    two = np.zeros(N_SYM, np.uint8)
    two[[3, 9]] = (1, 2)  # 3 -> 0, 9 -> 10
    ab = rng.integers(0, 2, stop)
    code = np.concatenate([[0] if v == 0 else [1, 0] for v in ab])
    rows.append(("no-code-2", None, lane, two,
                 words_of(np.r_[code, 1, 1, tail])))
    deep = np.zeros(N_SYM, np.uint8)
    syms = rng.permutation(N_SYM)[:32]
    deep[syms] = np.r_[np.arange(1, 32), 31]
    rows.append(("deep-31", rng.choice(syms[-12:], size=lane), lane, deep,
                 None))
    rows.append(("deep-random", None, lane, deep,
                 rng.integers(0, 1 << 32, lane // 32, dtype=np.uint64)))
    i = np.arange(lane)
    grad = ((i // 512) * 3 + (i % 512) * 2) // 5 + rng.integers(-2, 3, lane)
    grad = (grad & 255).astype(np.uint8)
    counts = torch.from_numpy(np.bincount(grad, minlength=N_SYM)[None, :])
    gl = build_lengths_pm(counts)[0].numpy().astype(np.uint8)
    rows.append(("gradient", grad, lane - lane // 3 - 5, gl, None))

    bufs = []
    for name, sy, m, lt, words in rows:
        if words is None:
            pb = pack_lane_rows(
                torch.from_numpy(np.asarray(sy, np.uint8)[None, :]).to(dev),
                torch.tensor([m], dtype=torch.int32, device=dev),
                torch.from_numpy(lt[None, :]).to(dev), lane)
            bufs.append(pb.reshape(-1))
        else:
            bufs.append(torch.from_numpy(
                words.astype(np.uint32).view(np.int32)).to(dev))
    wb = max(b.numel() for b in bufs)
    buf = torch.zeros((len(rows), 1, wb), dtype=torch.int32, device=dev)
    for r, b in enumerate(bufs):
        buf[r, 0, : b.numel()] = b
    tables = np.stack([r[3] for r in rows])
    buckets = [next(b for b in (8, 12, 16, 24, 31) if b >= int(t.max()))
               for t in tables]
    return (buf, torch.from_numpy(tables).to(dev),
            torch.tensor([r[2] for r in rows], dtype=torch.int32, device=dev),
            buckets, [r[0] for r in rows])


# CodecConfig fields of the configs whose shapes do not divide by 16
# (chunks of 1000 bytes, lanes of 100 and 8 symbols): every kernel of
# their paths launches at such a shape on a card
ODD_CONFIGS = {
    "sharded-1000-100": dict(layout="sharded", chunk_size=1000, lane=100),
    "sharded-lane-8": dict(layout="sharded", chunk_size=4096, lane=8),
    "global-1000-100": dict(chunk_size=1000, lane=100),
    "global-1000-100-chunked": dict(chunk_size=1000, lane=100,
                                    whole_file=False),
}


def odd_config_input(name: str, n: int = 5000) -> bytes:
    """The input of an ``ODD_CONFIGS`` entry: run-heavy bytes (runs of 40
    over four values) for lane 8, else a 100-wide gradient with +-2 noise
    (seed 2000)."""
    rng = np.random.default_rng(2000)
    i = np.arange(n)
    if name == "sharded-lane-8":
        return np.repeat(rng.integers(0, 4, n // 40 + 1), 40)[:n].astype(
            np.uint8).tobytes()
    return ((((i // 100) * 3 + (i % 100) * 2) // 5
             + rng.integers(-2, 3, n)) & 255).astype(np.uint8).tobytes()


def _no_three_runs(counts: np.ndarray, rng) -> np.ndarray:
    """Symbol i repeated counts[i] times, in an order with no three equal
    bytes in a row (so MNP-5 leaves it as it is): the symbols sorted by
    count, the first half of the sequence at even positions and the second
    at odd ones; no symbol may hold more than half of it."""
    order = np.argsort(-counts, kind="stable")
    seq = np.repeat(order, counts[order])
    out = np.empty_like(seq)
    half = -(-seq.size // 2)
    out[0::2], out[1::2] = seq[:half], seq[half:]
    return out.astype(np.uint8)


def _fibonacci(k: int) -> np.ndarray:
    f = [1, 1]
    while len(f) < k:
        f.append(f[-1] + f[-2])
    return np.array(f[:k], np.int64)


def fgk_edge_rows(n: int, seed: int):
    """Rows for the FGK kernels, width ``n`` (n >= 2100): (chunks (R, n)
    uint8, lengths (R,) int32).

    * lengths 0, 1 and 2;
    * all 256 symbols in order then random bytes, and 255 .. 0 twice
      (a fresh symbol every step, the NYT node deep);
    * a run-heavy MNP-5 stream (runs of three literals and a count byte
      over a few values) and a row of one symbol;
    * lengths 31, 32, 33, 1023, 1024, 1025, 2047, 2048, 2049 and n on a
      skewed alphabet (off every word and the kernels' 1024-symbol
      stage);
    * counts in Fibonacci proportion, the deepest tree for the length
      (codes of about 16 bits), with no three equal bytes in a row.

    Codes past 32 bits need about 2^17 symbols: ``fgk_deep_row``."""
    if n < 2100:
        raise ValueError("fgk_edge_rows needs n >= 2100")
    rng = np.random.default_rng(seed)
    rows, lens = [], []

    def add(row, m):
        r = np.zeros(n, np.uint8)
        r[: len(row)] = row[:n]
        rows.append(r)
        lens.append(m)

    add(rng.integers(0, N_SYM, n, dtype=np.int64), 0)
    add(np.array([200]), 1)
    add(np.array([7, 9]), 2)
    add(np.r_[np.arange(N_SYM), rng.integers(0, N_SYM, n - N_SYM)], n)
    add(np.r_[np.arange(N_SYM)[::-1], np.arange(N_SYM)[::-1]], 2 * N_SYM)
    runs = []
    while len(runs) < n:  # three literals and a count byte, repeated
        v = int(rng.integers(0, 4))
        runs += [v, v, v, int(rng.integers(0, N_SYM))]
    add(np.array(runs), n)
    add(np.full(n, 42), n)
    skew = rng.geometric(0.3, n).clip(max=N_SYM) - 1
    for m in (31, 32, 33, 1023, 1024, 1025, 2047, 2048, 2049, n):
        add(skew[rng.permutation(n)], m)
    fib = _fibonacci(14)  # 986 symbols in all
    add(_no_three_runs(fib, rng), int(fib.sum()))
    return np.stack(rows), np.array(lens, np.int32)


def fgk_deep_row(seed: int) -> np.ndarray:
    """A stream whose fresh symbols take codes of more than 32 bits (the
    high word of the encoder's code): 25 symbols in Fibonacci counts
    (196,417 bytes) put the NYT node 25 levels deep, and five fresh symbols
    follow (25 + 8 raw bits each). No three equal bytes in a row, so MNP-5
    leaves it as it is and its v1 encoding is its FGK stream."""
    rng = np.random.default_rng(seed)
    body = _no_three_runs(_fibonacci(25), rng)
    return np.r_[body, np.arange(200, 205, dtype=np.uint8)]


def fgk_successor_streams(seed: int) -> dict:
    """Streams for the FGK kernels' successor (the first slot of k's run
    of weight in the sorted prefix [0..k]), by the case they reach: name
    -> list of uint8 arrays.

    * ``pair``: each new symbol repeated at once, in runs that shrink as
      the alphabet grows, so the repeated leaf's sibling is the NYT node
      and its successor its own parent (no swap, its weight passes the
      parent's for one level), with an earlier symbol now and then;
    * ``round_robin``: all 256 symbols once, then rounds over all of them
      or a subset, some symbols skipped: long runs of one weight;
    * ``fibonacci``: 25 symbols in Fibonacci counts (196,418 bytes, no
      three equal in a row) and five fresh symbols, whose codes, the NYT
      code and 8 raw bits, pass 32 bits."""
    rng = np.random.default_rng(seed)
    pair = []
    for n_sym in (16, 64, 200, 256):
        out = []
        for i, s in enumerate(rng.permutation(N_SYM)[:n_sym]):
            out += [s] * max(1, int(64 * 0.93 ** i))
            if i and rng.random() < 0.3:
                out.append(out[int(rng.integers(0, len(out) - 1))])
        pair.append(np.array(out, np.uint8))
    perm = rng.permutation(N_SYM).astype(np.uint8)
    rounds = [perm]
    for _ in range(6):
        rounds.append(perm[rng.random(N_SYM) > 0.1])
    subset = perm[:100]
    robin = [np.tile(perm, 8), np.concatenate(rounds),
             np.r_[perm[::-1], np.tile(subset, 10)].astype(np.uint8)]
    fib = np.r_[_no_three_runs(_fibonacci(25), rng),
                rng.permutation(np.arange(230, 256))[:5]].astype(np.uint8)
    return {"pair": pair, "round_robin": robin, "fibonacci": [fib]}


def adapt_v1_blob(payload: bytes) -> bytes:
    """Raw payload bytes FGK-coded into a v1 adaptive blob (flags:
    adaptive only), so that a payload can be broken inside the Huffman
    coding."""
    return make_huff_header(len(payload), False, True) + pack_bits_msb(
        fgk_encode(payload))


def broken_adapt_v1_blobs() -> dict:
    """The reference's exit code -> (a v1 adaptive blob, its message): one
    8 x 8 tile read horizontally whose stream decodes past the tile (13),
    ends inside it (14), or leaves bytes after it (15)."""
    tile = (8).to_bytes(8, "big") * 3 + b"\x80"
    return {
        13: (adapt_v1_blob(tile + b"AAA" + bytes([200])),
             "invalid adaptive block RLE file contents"),
        14: (adapt_v1_blob(tile + b"AB"),
             "unexpected end of adaptive block RLE data"),
        15: (adapt_v1_blob(tile + bytes(range(64)) + b"ZZ"),
             "leftover data of adaptive block RLE detected"),
    }


def _walk_tile_raw(rng, size: int) -> np.ndarray:
    """``size`` raw bytes of a tile from a four-symbol alphabet in runs
    of 1 to 5 (equal neighbours, and count bytes of 0 to 2, are common),
    with a run of 258 to 262 now and then (count bytes of 255 and after)."""
    out, n = [], 0
    while n < size:
        run = int(rng.integers(258, 263)) if rng.random() < 0.01 else \
            int(rng.integers(1, 6))
        out.append(np.full(run, rng.choice([0, 1, 2, 255]), np.uint8))
        n += run
    return np.concatenate(out)[:size] if out else np.zeros(0, np.uint8)


def _walk_stream(raws) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Tiles' raw bytes -> (stream, each tile's stream length, sizes): each
    tile MNP-5 coded from the reset state, as the adaptive encoder does."""
    from huffman_codec_tpu_torch.pyref.rle import rle_encode
    enc = [np.frombuffer(bytes(rle_encode(r.tobytes())), np.uint8)
           for r in raws]
    return (np.concatenate(enc), np.array([len(e) for e in enc], np.int64),
            np.array([len(r) for r in raws], np.int32))


def _walk_case(stream, tile_lens, sizes, K: int, cap: int | None = None,
               total: int | None = None):
    """One walk input: the tiles in groups of K (sizes 0 past the last
    tile), each group's offset the sum of the tile lengths before it."""
    nt = len(sizes)
    ng = max(1, -(-nt // K))
    offs = np.concatenate([[0], np.cumsum(tile_lens)])[: nt: K]
    szs = np.zeros(ng * K, np.int32)
    szs[:nt] = sizes
    total = len(stream) if total is None else total
    return (stream.astype(np.uint8), offs.astype(np.int32), szs, int(total),
            int(total if cap is None else cap))


def walk_edge_streams(seed: int) -> dict:
    """Inputs of the group walk (``kernels.group_tile_lens``), name ->
    (stream (n,) uint8, group_offs (ng,) int32, sizes (ng * K,) int32,
    total, group_cap). The walk kernel stages a group's bytes in windows of
    4096 and walks them in passes of 32 lanes x 16 bytes; the streams put
    tile borders at and beside those borders, and reach every edge of the
    walk's contract:

    * ``grouped``: ~200 small valid tiles in groups of 16, the last group
      part-filled (sizes 0 past the last tile), the manifest's group cap;
      ``one_group``: the same tiles as one group, as ``V1Codec`` walks;
    * ``borders``: tiles whose streams are 1, 15, 16, 17, 511, 512, 513,
      4095 and 4097 bytes long, so tile borders fall on and beside lane,
      pass and window borders, each also after a tile that ends on its
      third equal literal (the next tile's first byte is a literal, not a
      count byte) or on two equal literals before a tile that starts with
      the same byte (the reset matters);
    * ``long``: tiles of 5000 to 12000 bytes, through many windows;
    * ``counts``: count bytes 0 and 255, and a count byte that overshoots
      its tile (decoded > size) inside a valid-looking stream;
    * ``random_bytes``: any bytes are a stream: random bytes walked as 8 x 8
      tiles overshoot and end short;
    * ``ends_inside``: the group's bytes end inside a tile (its length the
      bytes so far, its decoded size what they produce, later tiles 0);
    * ``leftover``: K tiles done before the bytes end, and zero-size tiles
      past the last one, each completed by a single byte;
    * ``cap_short``: a group cap shorter than the groups;
    * ``unordered``: offsets that are not monotone (a negative group
      length), past the stream's end and negative (reads clamped to
      [0, n - 1]), and a total past the stream."""
    rng = np.random.default_rng(seed)
    cases = {}
    raws = [_walk_tile_raw(rng, int(rng.integers(1, 41))) for _ in range(200)]
    stream, tl, sizes = _walk_stream(raws)
    cases["grouped"] = _walk_case(stream, tl, sizes, 16,
                                  cap=16 * (40 + 40 // 3 + 4))
    cases["one_group"] = _walk_case(stream, tl, sizes, len(sizes))

    # tiles of exact stream lengths: no three equal neighbours, so the
    # stream is the raw bytes; tails that make the border an edge
    def plain_tile(n):
        r = rng.integers(3, 250, n).astype(np.uint8)
        for i in range(2, n):
            if r[i] == r[i - 1] == r[i - 2]:
                r[i] = r[i] + 1
        return r

    raws = []
    for n in (16, 15, 17, 1, 511, 512, 513, 4095, 4097, 16):
        raws.append(plain_tile(n))
        tail = plain_tile(int(rng.integers(4, 30)))
        tail[-3:] = 7  # ends on its third equal literal ...
        raws += [tail, np.r_[np.uint8(7), plain_tile(12)]]  # ... then a 7
        tail = plain_tile(int(rng.integers(4, 30)))
        tail[-2:] = 9  # ends on two equal literals ...
        raws += [tail, np.full(6, 9, np.uint8)]  # ... then a run of 9
    stream, tl, sizes = _walk_stream(raws)
    cases["borders"] = _walk_case(stream, tl, sizes, len(sizes))

    raws = []
    for n in (5000, 1, 12000, 2, 7001):
        raws.append(_walk_tile_raw(rng, n))
    stream, tl, sizes = _walk_stream(raws)
    cases["long"] = _walk_case(stream, tl, sizes, 2, cap=stream.size)

    raws = [np.r_[np.full(3, 5), np.uint8(6)].astype(np.uint8),  # count 0
            np.full(258, 4, np.uint8), np.full(259, 4, np.uint8),  # 255
            np.full(3, 8, np.uint8), np.full(5, 8, np.uint8)]
    stream, tl, sizes = _walk_stream(raws * 3)
    sizes[-4] -= 2  # a count byte that overshoots: decoded > size
    cases["counts"] = _walk_case(stream, tl, sizes, len(sizes))

    stream = rng.integers(0, 256, 3000).astype(np.uint8)
    stream[rng.integers(0, 3000, 300)] = 0
    cases["random_bytes"] = (stream, np.array([0, 700, 1800], np.int32),
                             np.full(3 * 40, 64, np.int32), 3000, 1500)

    raws = [_walk_tile_raw(rng, int(rng.integers(1, 200))) for _ in range(40)]
    stream, tl, sizes = _walk_stream(raws)
    cut = int(tl[:30].sum()) + int(tl[30]) // 2
    cases["ends_inside"] = _walk_case(stream, tl, sizes, len(sizes),
                                      total=cut)
    lo = _walk_case(stream, tl, sizes, 16)
    cases["leftover"] = (lo[0], lo[1][:1], lo[2][:16].copy(), lo[3], lo[4])
    szs = np.zeros(64, np.int32)
    szs[:20] = sizes[:20]  # then zero-size tiles: a byte each
    cases["leftover_zero_sizes"] = (stream, np.zeros(1, np.int32), szs,
                                    int(tl[:20].sum()) + 30,
                                    int(tl[:20].sum()) + 30)
    g = _walk_case(stream, tl, sizes, 8)
    cases["cap_short"] = (g[0], g[1], g[2], g[3], 100)
    n = stream.size
    cases["unordered"] = (stream, np.array([0, 900, 400, n - 50, n + 70, -30],
                                           np.int32),
                          np.full(6 * 12, 40, np.int32), n + 300, 2000)
    return cases


def walk_serial(stream, group_offs, sizes, total: int, group_cap: int):
    """The group walk's contract run group by group, one byte at a time,
    in plain Python: (lens, decoded) as int32 arrays. The walk kernel's
    stress pass holds it to the kernel (the plain PyTorch version, a torch
    step per byte, is too slow for many seeds); the CPU tests hold it to
    the plain version."""
    stream = np.asarray(stream).tolist()
    offs = np.asarray(group_offs).astype(np.int64).tolist()
    sizes = np.asarray(sizes).tolist()
    ng, n = len(offs), len(stream)
    K = len(sizes) // ng
    lens, dec = [0] * (ng * K), [0] * (ng * K)
    for g in range(ng):
        end = offs[g + 1] if g + 1 < ng else total
        glen = min(end - offs[g], group_cap)
        t = produced = count = nb = 0
        match = -1
        for pos in range(max(glen, 0)):
            if t == K:
                break
            b = stream[min(max(offs[g] + pos, 0), n - 1)]
            is_cnt = count == 3
            produced += b if is_cnt else 1
            nb += 1
            if produced >= sizes[g * K + t]:
                lens[g * K + t], dec[g * K + t] = nb, produced
                t += 1
                produced = nb = count = 0
                match = -1
            elif is_cnt:
                count = 0
            else:
                count = count + 1 if match == b else 1
                match = b
        if t < K:
            lens[g * K + t], dec[g * K + t] = nb, produced
    return np.array(lens, np.int32), np.array(dec, np.int32)
