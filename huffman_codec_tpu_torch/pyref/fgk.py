"""FGK adaptive Huffman tree — exact behavioral model of huffman.cpp.

Design is array-based (slots ordered by decreasing nodeNum), NOT a pointer
tree: this is the same state layout the C++ runtime and the FGK kernels
use, so the three backends share one mental model.

Slot layout
-----------
Slot ``k`` holds the node with nodeNum ``512 - k`` (root = slot 0; the
reference seeds the lone NYT node with nodeNum 2*MAX_SYMBOLS = 512,
huffman.cpp:26-30). New nodes always take the two next-lower nodeNums
(huffman.cpp:101-104), so slots are appended contiguously. Swapping two
nodes in the reference exchanges their tree positions but swaps their
nodeNums back (huffman.cpp:188-191) — in slot space that means the two
slots exchange their *contents* (freq, symbol, children) while each keeps
its position-determined parent.

Key invariant (the FGK sibling property): frequencies are non-increasing
in slot order. The reference's recursive ``findSuccNode`` (huffman.cpp:157-184,
preferring the higher nodeNum when both subtrees have a candidate) is
therefore equivalent to "the lowest slot index whose freq equals the target"
— an O(log n) binary search / O(1) block pointer instead of an O(n) DFS.
"""

from __future__ import annotations

MAX_SYMBOLS = 256  # huffman.hpp:19
BITS_IN_SYMBOL = 8  # huffman.hpp:20
MAX_NODES = 2 * MAX_SYMBOLS + 1  # 256 leaves + 255 internal + NYT + root slack

NIL = -1


class FGKTree:
    """One adaptive FGK tree; encoder and decoder replay identical updates."""

    __slots__ = ("parent", "left", "right", "freq", "symbol", "n_slots",
                 "nyt", "symbol_slot")

    def __init__(self) -> None:
        self.parent = [NIL] * MAX_NODES
        self.left = [NIL] * MAX_NODES
        self.right = [NIL] * MAX_NODES
        self.freq = [0] * MAX_NODES
        self.symbol = [0] * MAX_NODES
        self.n_slots = 1  # lone NYT node == root (huffman.cpp:29-30)
        self.nyt = 0
        self.symbol_slot = [NIL] * MAX_SYMBOLS

    # -- queries ------------------------------------------------------------

    def is_leaf(self, k: int) -> bool:
        # FGK nodes have 0 or 2 children (huffman.cpp:15-19)
        return self.left[k] == NIL

    def _code_of(self, k: int) -> list[int]:
        """Root-path code, 0 = left edge, 1 = right edge (huffman.cpp:136-155)."""
        bits: list[int] = []
        while self.parent[k] != NIL:
            p = self.parent[k]
            bits.append(0 if self.left[p] == k else 1)
            k = p
        bits.reverse()
        return bits

    def encode(self, sym: int) -> list[int]:
        """Seen symbol -> its code; unseen -> NYT code ++ 8 raw MSB-first bits
        (huffman.cpp:37-58)."""
        k = self.symbol_slot[sym]
        if k == NIL:
            bits = self._code_of(self.nyt)
            bits.extend((sym >> i) & 1 for i in range(BITS_IN_SYMBOL - 1, -1, -1))
            return bits
        return self._code_of(k)

    def decode(self, bits, pos: int) -> tuple[int, int]:
        """Walk root->leaf from bits[pos:]; returns (symbol, new_pos).

        Raises IndexError on bit underrun (caller maps to the reference's
        exit 9, transform.cpp:393-398 / huffman.cpp:60-93).
        """
        k = 0
        while not self.is_leaf(k):
            b = bits[pos]
            pos += 1
            k = self.right[k] if b else self.left[k]
        if k == self.nyt:
            sym = 0
            for _ in range(BITS_IN_SYMBOL):
                sym = (sym << 1) | bits[pos]
                pos += 1
            return sym, pos
        return self.symbol[k], pos

    # -- update -------------------------------------------------------------

    def _find_succ_slot(self, f: int) -> int:
        """Exact model of the reference's pruned DFS (huffman.cpp:157-184):
        descend only internal nodes with freq > f; a node with freq == f is a
        candidate (and is not descended into); prefer the higher nodeNum ==
        the LOWER slot index when both subtrees yield one.

        Note this is deliberately NOT a binary search over freq[]: the
        parent-exclusion case of update() increments a child while its
        equal-freq parent stays put (huffman.cpp:117-123), transiently
        breaking the non-increasing order inside the updated node's subtree.
        The DFS is immune because such dirty nodes are never reachable (their
        subtree root has freq <= f). ``fast_find_succ_slot`` below is the
        equivalent rule the FGK kernels use; tests/test_torch_fgk_fast_rule.py
        holds the two against each other.
        """

        def dfs(k: int) -> int:
            if not self.is_leaf(k) and self.freq[k] > f:
                l = dfs(self.left[k])
                r = dfs(self.right[k])
                if l != NIL and r != NIL:
                    return min(l, r)  # lower slot == higher nodeNum
                return l if l != NIL else r
            if self.freq[k] == f:
                return k
            return NIL

        return dfs(0)

    def fast_find_succ_slot(self, f: int, k_slot: int) -> int:
        """The fast rule: the lowest slot with freq == f within the clean
        sorted prefix [0 .. k_slot], by binary search. The prefix is sorted
        because every node dirtied earlier in the current climb is a strict
        descendant of the climbing node and so lives at a higher slot. The
        kernels of csrc/fgk.cu find the same slot with a warp minimum."""
        lo, hi = 0, k_slot + 1
        while lo < hi:
            mid = (lo + hi) // 2
            if self.freq[mid] > f:
                lo = mid + 1
            else:
                hi = mid
        if lo <= k_slot and self.freq[lo] == f:
            return lo
        return NIL

    def _swap(self, a: int, b: int) -> None:
        """Exchange the subtree contents of slots a and b (huffman.cpp:186-217).

        Each slot keeps its parent (positions keep their place in the tree);
        children move with the contents, so their parent links are repointed.
        """
        for arr in (self.freq, self.symbol, self.left, self.right):
            arr[a], arr[b] = arr[b], arr[a]
        for k in (a, b):
            for c in (self.left[k], self.right[k]):
                if c != NIL:
                    self.parent[c] = k
        # leaf bookkeeping: symbol_slot must track moved leaves
        for k in (a, b):
            if self.is_leaf(k) and k != self.nyt:
                self.symbol_slot[self.symbol[k]] = k
        assert self.nyt not in (a, b), "NYT must never be swapped"

    def update(self, sym: int) -> None:
        """The FGK invariant maintainer (huffman.cpp:95-128)."""
        k = self.symbol_slot[sym]
        if k == NIL:
            # NYT split: new NYT = left child (nodeNum NYT-2 -> slot nyt+2),
            # symbol leaf = right child (nodeNum NYT-1 -> slot nyt+1),
            # both freq 0 (huffman.cpp:99-111).
            old = self.nyt
            leaf = old + 1
            new_nyt = old + 2
            self.left[old] = new_nyt
            self.right[old] = leaf
            self.parent[leaf] = old
            self.parent[new_nyt] = old
            self.freq[leaf] = 0
            self.freq[new_nyt] = 0
            self.symbol[leaf] = sym
            self.left[leaf] = self.right[leaf] = NIL
            self.left[new_nyt] = self.right[new_nyt] = NIL
            self.nyt = new_nyt
            self.symbol_slot[sym] = leaf
            self.n_slots = max(self.n_slots, new_nyt + 1)
            k = leaf

        # climb to root: swap with the highest-numbered equal-freq node
        # unless that is self or own parent, then increment (huffman.cpp:113-127)
        while self.parent[k] != NIL:
            succ = self._find_succ_slot(self.freq[k])
            if succ != NIL and succ != k and succ != self.parent[k]:
                self._swap(k, succ)
                k = succ
            self.freq[k] += 1
            k = self.parent[k]
        self.freq[k] += 1  # root


def fgk_encode(data: bytes) -> list[int]:
    """Per-symbol encode -> append -> update loop (transform.cpp:363-384),
    0-padded to a byte boundary by the caller."""
    tree = FGKTree()
    bits: list[int] = []
    for sym in data:
        bits.extend(tree.encode(sym))
        tree.update(sym)
    return bits


def fgk_decode(bits, symbol_count: int) -> bytes:
    """Per-symbol decode -> update loop (transform.cpp:386-406)."""
    tree = FGKTree()
    out = bytearray()
    pos = 0
    for _ in range(symbol_count):
        sym, pos = tree.decode(bits, pos)
        tree.update(sym)
        out.append(sym)
    return bytes(out)
