"""FGK adaptive Huffman coding, the plain batched PyTorch version.

The tree is kept in the slot form of the JAX package and of the host
runtime: slot k holds node number 512 - k, the root is slot 0, new nodes
append, and a swap exchanges the contents of two slots while the
positions keep their parents. The reference's successor search (the
highest-numbered node of the same weight) is the rule "the lowest slot in
[0..k] whose freq equals freq[k]", and the swap happens unless that slot
is k itself or k's parent.

Every function runs C independent chunk streams at once over a (C, 514)
state (513 live slots and a spare one that takes the parent writes of
absent children), one symbol position at a time: a step is a few dozen
small tensor ops per tree level. It is what the CPU runs and what the
kernels of ``csrc/fgk.cu`` are held against; the codec sends CUDA tensors
to those kernels (``ops/kernels.fgk_encode``, ``fgk_decode``).

A code is at most 64 bits, carried as u32 halves (lo, hi) in int64
tensors; a fresh symbol's code is the NYT node's code followed by the
symbol's 8 bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from huffman_codec_tpu_torch.ops.pack import get_bit, pack_codes

MAX_SYMBOLS = 256
MAX_NODES = 2 * MAX_SYMBOLS + 1  # 513 live slots
DUMP = MAX_NODES  # slot 513: where the parent writes of absent children go
NIL = -1
M32 = 0xFFFFFFFF


def max_code_bits(chunk_len: int) -> int:
    """Bound on one code's bits in a chunk of ``chunk_len`` symbols: the
    deepest leaf of a tree of that weight (a Fibonacci bound) plus the 8
    raw bits of a fresh symbol."""
    a, b, d = 1, 2, 0
    while b <= chunk_len + 1 and d < 120:
        a, b = b, a + b
        d += 1
    return min(64, d + 2 + 8)


def n_words_for(length: int) -> int:
    """Words of one chunk's encoded stream for ``length`` symbols."""
    return -(-length * max_code_bits(length) // 32) + 2


# the fields of a slot, rows of the state tensor
PARENT, LEFT, RIGHT, FREQ, SYMBOL = range(5)


@dataclass
class FGKState:
    """C trees in slot form, int64 tensors."""

    node: torch.Tensor  # (C, 5, 514): PARENT, LEFT, RIGHT, FREQ, SYMBOL
    symslot: torch.Tensor  # (C, 256)
    nyt: torch.Tensor  # (C,)


def fgk_init(C: int, device="cpu") -> FGKState:
    """C trees of a single NYT node, which is the root."""
    node = torch.full((C, 5, MAX_NODES + 1), NIL, dtype=torch.int64,
                      device=device)
    node[:, FREQ] = 0
    node[:, SYMBOL] = 0
    return FGKState(
        node=node,
        symslot=torch.full((C, MAX_SYMBOLS), NIL, dtype=torch.int64,
                           device=device),
        nyt=torch.zeros(C, dtype=torch.int64, device=device))


def _nyt_split(st: FGKState, sym: torch.Tensor, rows: torch.Tensor):
    """First occurrence of ``sym`` in the chunks ``rows`` (a bool mask):
    the NYT node gets a new NYT (left) and the symbol's leaf (right), both
    of weight 0. Returns the leaf slots (C,)."""
    old = st.nyt
    leaf, new = old + 1, old + 2
    r = rows.nonzero()[:, 0]
    if r.numel():
        o, lf, nw, s = old[r], leaf[r], new[r], sym[r]
        nd = st.node
        nd[r, LEFT, o] = nw
        nd[r, RIGHT, o] = lf
        for k in (lf, nw):  # two empty leaves of weight 0 under the old NYT
            nd[r, :FREQ + 1, k] = torch.stack(
                [o, torch.full_like(o, NIL), torch.full_like(o, NIL),
                 torch.zeros_like(o)], dim=1)
        nd[r, SYMBOL, lf] = s
        st.symslot[r, s] = lf
        st.nyt = torch.where(rows, new, old)
    return leaf


def _swap_slots(st: FGKState, r: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> None:
    """Exchange the contents of slots a and b in chunks ``r`` (indices):
    the positions keep their parents, the moved children point back at
    their new slots, and a moved leaf's symbol points at its new slot.
    (Children of a and of b are distinct nodes and distinct from a and b,
    and at most one of two leaves is the NYT node, so each group of
    writes below lands on distinct slots, apart from the spare one.)"""
    nd = st.node
    va, vb = nd[r, LEFT:, a], nd[r, LEFT:, b]
    nd[r, LEFT:, a] = vb
    nd[r, LEFT:, b] = va
    ab = torch.stack([a, b], dim=1)  # (n, 2)
    kids = torch.stack([vb[:, :2], va[:, :2]], dim=1)  # (n, 2, 2)
    owner = ab[:, :, None].expand(-1, 2, 2)
    nd[r[:, None, None].expand(-1, 2, 2), PARENT,
       torch.where(kids >= 0, kids, DUMP)] = owner
    leaf = kids[:, :, 0] < 0
    syms = torch.stack([vb[:, SYMBOL - LEFT], va[:, SYMBOL - LEFT]], dim=1)
    rr = r[:, None].expand(-1, 2)
    st.symslot[rr[leaf], syms[leaf]] = ab[leaf]


def fgk_update(st: FGKState, sym: torch.Tensor, ok: torch.Tensor) -> None:
    """The tree update after ``sym`` (C,) in the chunks where ``ok``: a
    first occurrence splits the NYT node, then from the symbol's leaf up
    to the root each node is swapped with the lowest slot of its weight
    (unless that is itself or its parent) and its weight goes up by one;
    the root's weight goes up last. In place."""
    C = sym.shape[0]
    nd = st.node
    ar = torch.arange(C, device=sym.device)
    slots = torch.arange(MAX_NODES + 1, device=sym.device)[None, :]
    k0 = st.symslot[ar, sym]
    fresh = ok & (k0 < 0)
    leaf = _nyt_split(st, sym, fresh)
    k = torch.where(fresh, leaf, k0)
    act = ok.clone()
    while True:
        pk = nd[ar, PARENT, k.clamp(min=0)]
        act = act & (pk >= 0)
        r = act.nonzero()[:, 0]
        if not r.numel():
            break
        kr, pr = k[r], pk[r]
        f = nd[r, FREQ, kr]
        mask = (nd[r, FREQ] == f[:, None]) & (slots <= kr[:, None])
        succ = mask.to(torch.int32).argmax(dim=1)  # the first such slot
        swap = (succ != kr) & (succ != pr)
        if bool(swap.any()):
            _swap_slots(st, r[swap], kr[swap], succ[swap])
            kr = torch.where(swap, succ, kr)
        nd[r, FREQ, kr] += 1
        k[r] = nd[r, PARENT, kr]
    nd[ok, FREQ, 0] += 1


def _code_of(st: FGKState, start: torch.Tensor, ok: torch.Tensor):
    """The root-path code of slot ``start`` (C,) as (lo, hi, len): the edge
    at depth d above the leaf is bit d of the right-aligned value (1 for a
    right child). A tree over fewer than 2^31 symbols is less than 46
    levels deep, so the code fits an int64."""
    C = start.shape[0]
    nd = st.node
    ar = torch.arange(C, device=start.device)
    code = torch.zeros(C, dtype=torch.int64, device=start.device)
    d = torch.zeros_like(code)
    k = start.clone()
    act = ok.clone()
    while True:
        p = nd[ar, PARENT, k]
        act = act & (p >= 0)
        if not bool(act.any()):
            break
        bit = (nd[ar, LEFT, p.clamp(min=0)] != k) & act
        code = code | (bit.to(torch.int64) << d)
        d = d + act.to(torch.int64)
        k = torch.where(act, p, k)
    return code & M32, code >> 32, d


def fgk_encode_step(st: FGKState, sym: torch.Tensor, ok: torch.Tensor):
    """Encode ``sym`` (C,) where ``ok``, then update. Returns the codes
    (lo, hi, len), zero where not ``ok``."""
    C = sym.shape[0]
    ar = torch.arange(C, device=sym.device)
    k0 = st.symslot[ar, sym]
    fresh = k0 < 0
    lo, hi, ln = _code_of(st, torch.where(fresh, st.nyt, k0), ok)
    # a fresh symbol: the NYT code, then the symbol's 8 bits MSB-first
    hi = torch.where(fresh, ((hi << 8) | (lo >> 24)) & M32, hi)
    lo = torch.where(fresh, ((lo << 8) | sym) & M32, lo)
    ln = torch.where(fresh, ln + 8, ln)
    fgk_update(st, sym, ok)
    zero = torch.zeros_like(lo)
    return (torch.where(ok, lo, zero), torch.where(ok, hi, zero),
            torch.where(ok, ln, zero))


@torch.inference_mode()
def _encode_batch(symbols, lengths, n_words: int):
    C, L = symbols.shape
    dev = symbols.device
    ln = lengths.to(torch.int64).clamp(0, L)
    steps = int(ln.max()) if C else 0
    st = fgk_init(C, dev)
    los, his, lens = (torch.zeros((C, max(steps, 1)), dtype=torch.int64,
                                  device=dev) for _ in range(3))
    sy = symbols.to(torch.int64)
    for i in range(steps):
        los[:, i], his[:, i], lens[:, i] = fgk_encode_step(st, sy[:, i],
                                                           i < ln)
    return pack_codes(los, his, lens, n_words)


def fgk_encode_batch(symbols: torch.Tensor, lengths: torch.Tensor,
                     n_words: int):
    """(C, L) uint8 chunks, the first ``lengths[c]`` symbols of each
    encoded with a tree of its own -> (words (C, n_words) int32 MSB-first,
    zero past each stream's end; bits (C,) int32)."""
    # run without autograd's bookkeeping; the results leave as ordinary
    # tensors
    return tuple(t.clone() for t in _encode_batch(symbols, lengths, n_words))


def fgk_decode_batch(words: torch.Tensor, counts: torch.Tensor,
                     out_len: int) -> torch.Tensor:
    """(C, W) int32 word streams -> (C, out_len) uint8, the first
    ``counts[c]`` symbols of each decoded, zero past them. Reads past a
    row read its last word."""
    return _decode_batch(words, counts, out_len).clone()


@torch.inference_mode()
def _decode_batch(words, counts, out_len: int):
    C = words.shape[0]
    dev = words.device
    ar = torch.arange(C, device=dev)
    cnt = counts.to(torch.int64).clamp(0, out_len)
    steps = int(cnt.max()) if C else 0
    st = fgk_init(C, dev)
    pos = torch.zeros(C, dtype=torch.int64, device=dev)
    out = torch.zeros((C, out_len), dtype=torch.uint8, device=dev)
    for i in range(steps):
        ok = i < cnt
        # root-to-leaf walk
        k = torch.zeros(C, dtype=torch.int64, device=dev)
        while True:
            inner = ok & (st.node[ar, LEFT, k] >= 0)
            if not bool(inner.any()):
                break
            bit = get_bit(words, pos)
            nxt = st.node[ar, LEFT + bit, k]
            k = torch.where(inner, nxt, k)
            pos = pos + inner.to(torch.int64)
        at_nyt = ok & (k == st.nyt)
        raw = torch.zeros_like(pos)
        for j in range(8):
            raw = (raw << 1) | get_bit(words, pos + j)
        sym = torch.where(at_nyt, raw, st.node[ar, SYMBOL, k])
        pos = torch.where(at_nyt, pos + 8, pos)
        fgk_update(st, sym, ok)
        out[:, i] = torch.where(ok, sym, 0).to(torch.uint8)
    return out


def fgk_encode_chunk(symbols: torch.Tensor, length, n_words: int):
    """One chunk: the first ``length`` symbols of (L,) uint8 ``symbols``
    -> (words (n_words,) int32, the codes MSB-first; total bits 0-d
    int32). A CUDA tensor launches the ``fgk_encode`` kernel with one row,
    a CPU tensor runs the plain version."""
    from huffman_codec_tpu_torch.ops import kernels  # kernels imports us

    ln = torch.as_tensor(length, device=symbols.device)
    words, bits = kernels.fgk_encode(symbols.reshape(1, -1),
                                     ln.to(torch.int32).reshape(1), n_words)
    return words[0], bits[0]


def fgk_decode_chunk(words: torch.Tensor, count, out_len: int = 0):
    """One chunk: ``count`` symbols from (W,) int32 ``words`` -> (out_len,)
    uint8, zero past ``count``. A CUDA tensor launches the ``fgk_decode``
    kernel with one row, a CPU tensor runs the plain version."""
    if out_len <= 0:
        raise ValueError("fgk_decode_chunk needs a static out_len")
    from huffman_codec_tpu_torch.ops import kernels  # kernels imports us

    cnt = torch.as_tensor(count, device=words.device)
    return kernels.fgk_decode(words.reshape(1, -1),
                              cnt.to(torch.int32).reshape(1), out_len)[0]
