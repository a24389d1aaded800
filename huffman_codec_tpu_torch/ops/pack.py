"""MSB-first bit streams as big-endian u32 words, in PyTorch.

Bit p of a stream is bit (31 - p % 32) of word p // 32, and the wire bytes
are the words big-endian (the v1 and v3 FGK payloads). Tensors carry the
words as int32 holding the same bits.

``pack_codes`` lays variable-length codes end to end: an exclusive prefix
sum of the lengths gives every code its bit offset, each code is cut into
the (at most three) words it touches, and the pieces are added into the
word tensor (their bits never overlap, so add is or).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def to_i32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors holding the same bits."""
    v = v & M32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _shift(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x (values < 2^32) shifted left by s (right for s < 0), cut to 32
    bits; a shift of 32 or more either way gives 0."""
    left = torch.where((s >= 0) & (s < 32), x << s.clamp(0, 31), 0)
    right = torch.where((s < 0) & (s > -32), x >> (-s).clamp(0, 31), 0)
    return (left | right) & M32


def pack_codes(lo: torch.Tensor, hi: torch.Tensor, lens: torch.Tensor,
               n_words: int, max_len: int = 64):
    """Codes laid end to end, MSB-first, into ``n_words`` words.

    lo, hi, lens (..., n): code i is the right-aligned value
    ``(hi << 32) | lo`` of ``lens[i]`` <= ``max_len`` <= 64 bits (u32
    halves in any integer dtype). ``max_len`` <= 32 cuts each code into
    at most two words and reads ``lo`` only, as the JAX package does.
    Returns (words (..., n_words) int32, zero past the last code; total
    bits (...,) int32). Pieces past ``n_words`` are dropped."""
    lead = lens.shape[:-1]
    n = lens.shape[-1]
    dev = lens.device
    ln = lens.to(torch.int64).reshape(-1, n)
    lo = lo.to(torch.int64).reshape(-1, n) & M32
    hi = hi.to(torch.int64).reshape(-1, n) & M32
    R = ln.shape[0]
    incl = torch.cumsum(ln, dim=1)
    off = incl - ln
    total = incl[:, -1] if n else torch.zeros(R, dtype=torch.int64, device=dev)
    # the code in a window of n_win words from word off >> 5, its MSB at
    # window bit off & 31: word j of the window is the 64-bit value
    # shifted left by s - 32 * (n_win - 1 - j), s = 32 * n_win - (off &
    # 31) - len
    n_win = 2 if max_len <= 32 else 3
    s = 32 * n_win - (off & 31) - ln
    w0 = off >> 5
    dump = n_words  # one spare column takes the dropped pieces
    acc = torch.zeros((R, n_words + 1), dtype=torch.int64, device=dev)
    for j in range(n_win):
        t = s - 32 * (n_win - 1 - j)
        piece = _shift(lo, t)
        if n_win == 3:
            piece = piece | _shift(hi, t + 32)
        piece = torch.where(ln > 0, piece, 0)
        idx = (w0 + j).clamp(max=dump)
        acc.scatter_add_(1, idx, piece)
    words = to_i32_bits(acc[:, :n_words])
    return (words.reshape(*lead, n_words),
            total.to(torch.int32).reshape(lead))


def get_bit(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Bit at stream position ``pos`` (...,) of each row of words
    (..., W) int32, as int64 0/1. A position past the row reads its last
    word, as a clamped gather does."""
    W = words.shape[-1]
    wi = (pos >> 5).clamp(max=W - 1)
    w = torch.gather(words, -1, wi[..., None])[..., 0].to(torch.int64)
    return (w >> (31 - (pos & 31))) & 1


def bytes_to_words(data: torch.Tensor, n_words: int) -> torch.Tensor:
    """Wire bytes (n,) uint8 -> (n_words,) int32 big-endian words, zero
    padded (or cut)."""
    buf = torch.zeros(n_words * 4, dtype=torch.uint8, device=data.device)
    m = min(data.shape[0], n_words * 4)
    buf[:m] = data[:m]
    b = buf.view(n_words, 4).to(torch.int64)
    return to_i32_bits((b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8)
                       | b[:, 3])


def words_to_bytes(words: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """Big-endian words (..., W) int32 -> the first ``n_bytes`` wire bytes
    of each row, uint8 (..., n_bytes)."""
    nw = -(-n_bytes // 4)
    w = words[..., :nw].to(torch.int64) & M32
    sh = torch.tensor([24, 16, 8, 0], device=words.device)
    b = ((w[..., None] >> sh) & 0xFF).to(torch.uint8)
    return b.reshape(*words.shape[:-1], 4 * nw)[..., :n_bytes]


def chunk_words(payload: torch.Tensor, offs: torch.Tensor,
                n_bytes: torch.Tensor, n_words: int) -> torch.Tensor:
    """Byte-aligned chunk streams -> one row of big-endian words a chunk.

    payload (N,) uint8 holds the streams one after the other; chunk c is
    ``n_bytes[c]`` bytes from ``offs[c]``. Returns (C, n_words) int32, zero
    past each chunk's bytes."""
    j = torch.arange(4 * n_words, device=payload.device)
    idx = (offs.to(torch.int64)[:, None] + j).clamp(
        0, max(payload.shape[0] - 1, 0))
    if payload.shape[0]:
        b = payload[idx].to(torch.int64)
    else:
        b = torch.zeros(idx.shape, dtype=torch.int64, device=payload.device)
    b = torch.where(j < n_bytes.to(torch.int64)[:, None], b, 0)
    b = b.view(-1, n_words, 4)
    return to_i32_bits((b[..., 0] << 24) | (b[..., 1] << 16)
                       | (b[..., 2] << 8) | b[..., 3])


def chunk_bytes(words: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The wire payload of (C, W) word rows holding ``bits[c]`` bits each:
    every row's first ``(bits + 7) // 8`` bytes, row after row, as one
    (N,) uint8 tensor on the rows' device."""
    C = words.shape[0]
    if C == 0:
        return torch.zeros(0, dtype=torch.uint8, device=words.device)
    nb = (bits.to(torch.int64) + 7) // 8
    nw = max(1, int(-(-int(nb.max()) // 4)))
    b = words_to_bytes(words[:, :nw], 4 * nw)
    keep = torch.arange(4 * nw, device=words.device)[None, :] < nb[:, None]
    return b[keep]
