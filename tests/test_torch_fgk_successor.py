"""The FGK kernels' successor, modelled in Python, against the fast rule.

``csrc/fgk.cu`` runs one chunk's tree on one thread. Its successor of a
slot k of weight w is the first slot of the run of weight w that ends at
k in the sorted prefix [0..k]: k itself when ``freq[k-1] != w`` (the own
test, nearly every level), else a gallop back from k and a binary search
(``leader`` below). The encoder takes the code and the update in one climb
while no level swaps (a weight increment changes no edge), and the decoder
notes each level's own test on its root-to-leaf walk and applies the
increments of the levels below the deepest failed test without another
climb. A second successor, Knuth's block records (``succ="blocks"``: a
block id a slot, the leader a block, kept in O(1) a level), was timed
against it (``git show 128a866:kernel_variants/fgk_chain.cu``).

``ChainTree`` models both, record for record: every climb level checks
the successor against ``fast_find_succ_slot`` (the rule
``tests/test_torch_fgk_fast_rule.py`` holds to the reference's DFS), and
for block records that every block is a maximal run of one weight. At the
end of a stream the model's tree equals the JAX package's
``huffman_codec_tpu.pyref.fgk`` tree, its bits equal that package's
``fgk_encode`` and its decoder gives the stream back.
"""

import functools
import random
import types

import numpy as np
import pytest

from huffman_codec_tpu.pyref import fgk as jfgk
from huffman_codec_tpu_torch.edge_cases import fgk_successor_streams
from huffman_codec_tpu_torch.pyref.fgk import FGKTree

SLOTS = 514
LEAF = -(1 << 31)  # a leaf's content word: LEAF | symbol


def fast_rule(freq, w, k):
    return FGKTree.fast_find_succ_slot(types.SimpleNamespace(freq=freq), w, k)


class ChainTree:
    """One chunk's tree as the kernel keeps it: a position record a slot
    (parent, side), a content word a slot (left | right << 16, or LEAF |
    symbol), int32 weights; with ``succ="blocks"`` also a block id a slot
    and the leader a block."""

    def __init__(self, succ: str):
        self.blocks = succ == "blocks"
        self.freq = [0] * SLOTS
        self.parent = [-1] * SLOTS
        self.side = [0] * SLOTS
        self.ch = [LEAF] * SLOTS
        self.symslot = [-1] * 256
        self.nyt = 0
        self.kinds = {"own": 0, "pair": 0, "swap": 0}
        self.longest = 0  # the longest code the encoder gave, in bits
        if self.blocks:
            self.blk = [-1] * SLOTS
            self.lead = [0] * SLOTS
            self.free = list(range(SLOTS - 1, 0, -1))  # block 0: the root
            self.blk[0] = 0

    # -- the successor ------------------------------------------------------

    def w_at(self, i):
        return self.freq[i] if i >= 0 else -1  # the kernel's sentinel slot

    def gallop(self, k, w):
        """The first slot of the run of weight w ending at k, given
        freq[k-1] == w: probes k-2, k-4, k-8, ... then a binary search."""
        d = 2
        while self.w_at(max(k - d, -1)) == w:
            d *= 2
        lo, hi = max(k - d, -1), k - d // 2
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self.freq[mid] == w:
                hi = mid
            else:
                lo = mid
        return hi

    def own(self, k):
        if self.blocks:
            return self.lead[self.blk[k]] == k
        return self.w_at(k - 1) != self.freq[k]

    def leader(self, k):
        """The successor at a climb level, checked against the fast rule."""
        w = self.freq[k]
        if self.blocks:
            got = self.lead[self.blk[k]]
        else:
            got = k if self.own(k) else self.gallop(k, w)
        assert got == fast_rule(self.freq, w, k), (k, w, got)
        p = self.parent[k]
        self.kinds["own" if got == k else "pair" if got == p else
                   "swap"] += 1
        return got

    def check_blocks(self):
        """Every block is a maximal run of one weight, led by its first
        slot."""
        first = 0
        for s in range(self.nyt + 1):
            if s and self.freq[s] != self.freq[s - 1]:
                first = s
            assert self.lead[self.blk[s]] == first, s
            if s > first:
                assert self.blk[s] == self.blk[s - 1], s

    # -- the weight updates ---------------------------------------------------

    def bump(self, s, w):
        """The weight of s, its block's leader, goes from w to w + 1."""
        if self.blocks:
            b = self.blk[s]
            if s + 1 <= self.nyt and self.blk[s + 1] == b:
                self.lead[b] = s + 1
            else:
                self.free.append(b)
            if s and self.freq[s - 1] == w + 1:
                self.blk[s] = self.blk[s - 1]
            else:
                n = self.free.pop()
                self.lead[n] = s
                self.blk[s] = n
        self.freq[s] = w + 1

    def pair(self, k, p, w):
        """k's sibling is the NYT and k's successor its parent p = k - 1:
        no swap, k goes to w + 1. Block records take p's level with it
        (p is the leader of w in [0..p], so its level is no swap either);
        returns whether they did."""
        if not self.blocks:
            self.freq[k] = w + 1
            return False
        b = self.blk[k]
        assert p == k - 1 and self.nyt == k + 1 and self.lead[b] == p
        if w == 0:
            self.lead[b] = self.nyt  # the fresh leaf: the NYT stays in b
        else:
            assert self.blk[self.nyt] != b
            self.free.append(b)
        if p and self.freq[p - 1] == w + 1:
            self.blk[p] = self.blk[k] = self.blk[p - 1]
        else:
            n = self.free.pop()
            self.lead[n] = p
            self.blk[p] = self.blk[k] = n
        self.freq[p] = self.freq[k] = w + 1
        return True

    def swap(self, a, b):
        """Exchange the contents of slots a and b; the positions keep their
        parent and side, the moved children point back at their new slot."""
        self.ch[a], self.ch[b] = self.ch[b], self.ch[a]
        for s in (a, b):
            c = self.ch[s]
            if c >= 0:
                self.parent[c & 0xFFFF] = self.parent[c >> 16] = s
            else:
                self.symslot[c & 0xFF] = s

    def split(self, sym):
        """A first occurrence: the NYT slot o gets a new NYT (left, o + 2)
        and the symbol's leaf (right, o + 1), and the leaf's level (a pair:
        its successor is o) is done. Returns (o, whether o's level is done
        too)."""
        o = self.nyt
        self.ch[o] = (o + 2) | ((o + 1) << 16)
        self.parent[o + 1], self.side[o + 1] = o, 1
        self.parent[o + 2], self.side[o + 2] = o, 0
        self.ch[o + 1], self.ch[o + 2] = LEAF | sym, LEAF
        self.freq[o + 1] = self.freq[o + 2] = 0
        self.symslot[sym] = o + 1
        self.nyt = o + 2
        if self.blocks:
            self.blk[o + 1] = self.blk[o + 2] = self.blk[o]
        assert self.leader(o + 1) == o
        return o, self.pair(o + 1, o, 0)

    def climb(self, k):
        """The update from slot k to the root (the kernels' slow path)."""
        done = False
        while k:
            if done:  # a block-record pair step did this level
                done = False
                k = self.parent[k]
                continue
            w, p = self.freq[k], self.parent[k]
            L = self.leader(k)
            if L == p:
                done = self.pair(k, p, w)
            else:
                if L != k:
                    self.swap(k, L)
                    k = L
                self.bump(k, w)
            k = self.parent[k]
        if not done:  # else a pair step took the root's level
            self.bump(0, self.freq[0])

    # -- the encoder's and the decoder's symbol -------------------------------

    def encode(self, sym):
        """The code of sym (bits from the start slot up, as the kernel's
        64-bit code: bit d is the edge d levels above it; then 8 raw bits
        for a fresh symbol) and the update, in one climb while no level
        swaps. Returns a list of bits, MSB first."""
        k = self.symslot[sym]
        fresh = k < 0
        done = False
        if fresh:
            k, done = self.split(sym)
        code, d = 0, 0
        while k:
            p = self.parent[k]
            code |= self.side[k] << d
            d += 1
            if done:
                done = False
                k = p
                continue
            w = self.freq[k]
            L = self.leader(k)
            if L == k or L == p:
                if L == k:
                    self.bump(k, w)
                else:
                    done = self.pair(k, p, w)
                k = p
                continue
            q = p  # a swap: the code above k first, then the update
            while q:
                code |= self.side[q] << d
                d += 1
                q = self.parent[q]
            self.kinds["swap"] -= 1  # climb() counts this level again
            self.climb(k)
            break
        else:
            if not done:
                self.bump(0, self.freq[0])
        self.longest = max(self.longest, d + 8 * fresh)
        bits = [(code >> (d - 1 - i)) & 1 for i in range(d)]
        if fresh:
            bits += [(sym >> (7 - i)) & 1 for i in range(8)]
        return bits

    def decode(self, bits, pos):
        """One symbol from bits[pos:]: the root-to-leaf walk notes each
        level's slot, weight and own test; the levels below the deepest
        failed test take their increment from the notes, the rest is the
        slow path. Returns (symbol, new pos)."""
        k, path = 0, []
        while self.ch[k] >= 0:
            c = self.ch[k]
            k = c >> 16 if bits[pos] else c & 0xFFFF
            pos += 1
            path.append((k, self.freq[k], self.own(k)))
        fresh = k == self.nyt
        if fresh:
            sym = 0
            for _ in range(8):
                sym = (sym << 1) | bits[pos]
                pos += 1
        else:
            sym = self.ch[k] & 0xFF
        done = self.split(sym)[1] if fresh else False
        bad = max((j for j, (_, _, ok) in enumerate(path) if not ok),
                  default=-1)
        for j in range(len(path) - 1, bad, -1):
            s, w, _ = path[j]
            if done:
                done = False
                continue
            assert self.freq[s] == w and self.leader(s) == s
            self.bump(s, w)
        if bad >= 0:
            assert not done  # a fresh symbol's NYT slot passes its test
            self.climb(path[bad][0])
        elif not done:
            self.bump(0, self.freq[0])
        return sym, pos

    # -- the tree in the JAX package's form -----------------------------------

    def same_as(self, ref) -> None:
        n = self.nyt + 1
        assert ref.nyt == self.nyt
        assert list(ref.freq[:n]) == self.freq[:n]
        assert list(ref.parent[:n]) == self.parent[:n]
        for s in range(n):
            c = self.ch[s]
            if c >= 0:
                assert (ref.left[s], ref.right[s]) == (c & 0xFFFF, c >> 16)
            else:
                assert ref.left[s] == ref.right[s] == -1
                if s != self.nyt:
                    assert ref.symbol[s] == c & 0xFF
        for sym, s in enumerate(self.symslot):
            assert ref.symbol_slot[sym] == s


@functools.lru_cache(maxsize=32)
def jax_reference(data: bytes):
    """The JAX package's FGK bits of ``data`` (its ``fgk_encode`` loop)
    and its tree at the end; both successors are held to one run."""
    tree, bits = jfgk.FGKTree(), []
    for sym in data:
        bits += tree.encode(sym)
        tree.update(sym)
    return bits, tree


def run_model(data: bytes, succ: str, check_every: int = 97) -> dict:
    """Encode ``data`` with the model, hold its bits and tree to the JAX
    package's, decode the bits with a second model; returns the level
    kinds of the encoder."""
    enc, bits = ChainTree(succ), []
    for i, sym in enumerate(data):
        bits += enc.encode(sym)
        if enc.blocks and i % check_every == 0:
            enc.check_blocks()
    if enc.blocks:
        enc.check_blocks()
    ref_bits, ref = jax_reference(data)
    assert bits == ref_bits
    enc.same_as(ref)
    dec, pos, out = ChainTree(succ), 0, bytearray()
    for _ in range(len(data)):
        sym, pos = dec.decode(bits, pos)
        out.append(sym)
    assert bytes(out) == data and pos == len(bits)
    dec.same_as(ref)
    return {**enc.kinds, "longest": enc.longest}


FAST_RULE_STREAMS = [
    b"a",
    b"ab" * 50,
    b"abracadabra" * 20,
    bytes(range(256)),
    bytes(range(256)) * 3,
    b"\x00" * 500,
    bytes([i % 2 for i in range(400)]),
    bytes([i % 3 for i in range(400)]),
    b"".join(bytes([i]) * (2 ** min(i, 10)) for i in range(16)),
]


def _fast_rule_random():
    # the random and run streams of tests/test_torch_fgk_fast_rule.py
    rng = random.Random(1234)
    out = []
    for _ in range(4):
        alphabet = rng.choice([2, 3, 5, 16, 64, 256])
        out.append(bytes(rng.randrange(alphabet)
                         for _ in range(rng.randrange(50, 3000))))
    rng = random.Random(99)
    data = bytearray()
    while len(data) < 2000:
        data += bytes([rng.randrange(6)]) * rng.randrange(1, 300)
    return out + [bytes(data)]


@pytest.mark.parametrize("succ", ["gallop", "blocks"])
def test_successor_on_fast_rule_streams(succ):
    for data in FAST_RULE_STREAMS + _fast_rule_random():
        run_model(data, succ)


@pytest.mark.parametrize("succ", ["gallop", "blocks"])
@pytest.mark.parametrize("name", ["pair", "round_robin", "fibonacci"])
def test_successor_on_edge_streams(succ, name):
    streams = fgk_successor_streams(3)[name]
    kinds = {"own": 0, "pair": 0, "swap": 0, "longest": 0}
    for data in streams:
        for key, n in run_model(data.tobytes(), succ, check_every=4099) \
                .items():
            kinds[key] = max(kinds[key], n) if key == "longest" else \
                kinds[key] + n
    if name == "pair":
        # the no-swap-to-parent case well beyond the fresh leaves' own
        assert kinds["pair"] > sum(len(np.unique(s)) for s in streams)
    if name == "round_robin":
        assert kinds["swap"] > 1000  # runs of one weight, long ones too
    if name == "fibonacci":
        # fresh symbols coded past 32 bits: the NYT 25 levels deep
        assert kinds["longest"] > 32


def test_gallop_reaches_long_runs():
    """The gallop's binary search on runs of every length up to 256."""
    tree = ChainTree("gallop")
    for n in range(2, 257):
        tree.freq[:n + 1] = [9] + [5] * n
        for k in {2, n // 2 + 1, n}:
            assert tree.gallop(k, 5) == fast_rule(tree.freq, 5, k) == 1
