"""FGK adaptive Huffman encoder: a frozen copy of the port's pure-Python
model of the reference's ``huffman.cpp`` (``pyref/fgk.py``, its encoder
half), kept here so that the benchmark's reference imports nothing of
the program, with the successor search done by a scan in place of the
DFS (the same answer, about 2-15x faster a symbol; the DFS is kept in
``benchmark/tests/test_bench_fgk.py``, which holds the two equal). The
line references are to the reference's sources.

Design is array-based (slots ordered by decreasing nodeNum), NOT a pointer
tree. Slot ``k`` holds the node with nodeNum ``512 - k`` (root = slot 0;
the reference seeds the lone NYT node with nodeNum 2*MAX_SYMBOLS = 512,
huffman.cpp:26-30). New nodes always take the two next-lower nodeNums
(huffman.cpp:101-104), so slots are appended contiguously. Swapping two
nodes in the reference exchanges their tree positions but swaps their
nodeNums back (huffman.cpp:188-191): in slot space the two slots exchange
their *contents* (freq, symbol, children) while each keeps its
position-determined parent.
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
        subtree root has freq <= f).

        The DFS reaches a node exactly when every ancestor of it has freq
        > f (ancestors are internal), so its answer is the lowest slot
        with freq == f whose ancestors all have freq > f: the slots are
        scanned in order for freq == f (``list.index``) and each hit's
        ancestors checked, which visits a few nodes where the DFS visits
        every internal node with freq > f.
        """
        freq, parent = self.freq, self.parent
        k = -1
        while True:
            try:
                k = freq.index(f, k + 1, self.n_slots)
            except ValueError:
                return NIL
            p = parent[k]
            while p != NIL and freq[p] > f:
                p = parent[p]
            if p == NIL:
                return k

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
