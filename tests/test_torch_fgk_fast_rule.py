"""The port's vectorizable FGK successor rule against the exact DFS.

``csrc/fgk.cu`` and the plain FGK versions of the port use the fast rule
``fast_find_succ_slot(f, k_slot)`` (the lowest slot with freq == f within
the clean sorted prefix [0..k_slot]) in place of the reference's pruned DFS
(huffman.cpp:157-184). This is the JAX package's
tests/test_fgk_fast_rule.py run against the port's ``pyref.fgk``: every
update of every climb on adversarial and random streams checks that both
rules agree, including the exclusion outcome (self or own parent: no
swap). A last case holds the port's fast rule to the JAX package's, slot
for slot.
"""

import random

import numpy as np
import pytest

from huffman_codec_tpu_torch.pyref.fgk import NIL, FGKTree


class InstrumentedTree(FGKTree):
    """FGKTree whose update() checks fast rule == DFS at every climb level
    and records every slot the fast rule returns."""

    def __init__(self):
        super().__init__()
        self.mismatches = []
        self.fast_slots = []

    def update(self, sym: int) -> None:  # mirrors FGKTree.update
        k = self.symbol_slot[sym]
        if k == NIL:
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

        while self.parent[k] != NIL:
            succ_dfs = self._find_succ_slot(self.freq[k])
            succ_fast = self.fast_find_succ_slot(self.freq[k], k)
            self.fast_slots.append(succ_fast)
            # compare the effective decision: swap target or no-op
            eff_dfs = (succ_dfs if succ_dfs not in (NIL, k, self.parent[k])
                       else NIL)
            eff_fast = (succ_fast
                        if succ_fast not in (NIL, k, self.parent[k]) else NIL)
            if eff_dfs != eff_fast:
                self.mismatches.append((self.freq[k], k, succ_dfs, succ_fast))
            if eff_dfs != NIL:
                self._swap(k, eff_dfs)
                k = eff_dfs
            self.freq[k] += 1
            k = self.parent[k]
        self.freq[k] += 1


def _run(data: bytes) -> InstrumentedTree:
    tree = InstrumentedTree()
    for sym in data:
        tree.encode(sym)
        tree.update(sym)
    assert tree.mismatches == [], tree.mismatches[:10]
    return tree


@pytest.mark.parametrize(
    "data",
    [
        b"a",
        b"ab" * 50,
        b"abracadabra" * 20,
        bytes(range(256)),
        bytes(range(256)) * 3,
        b"\x00" * 500,
        bytes([i % 2 for i in range(400)]),
        bytes([i % 3 for i in range(400)]),
        # Fibonacci-like skew: maximally unbalanced tree
        b"".join(bytes([i]) * (2 ** min(i, 10)) for i in range(16)),
    ],
)
def test_fast_rule_matches_dfs(data):
    _run(data)


def test_fast_rule_matches_dfs_random():
    rng = random.Random(1234)
    for trial in range(30):
        alphabet = rng.choice([2, 3, 5, 16, 64, 256])
        n = rng.randrange(50, 3000)
        data = bytes(rng.randrange(alphabet) for _ in range(n))
        _run(data)


def test_fast_rule_matches_dfs_runs():
    rng = random.Random(99)
    for trial in range(20):
        data = bytearray()
        while len(data) < 2000:
            data += bytes([rng.randrange(6)]) * rng.randrange(1, 300)
        _run(bytes(data))


def test_fast_rule_on_image_like_data():
    # the JAX test reads 24 KiB of two corpus images; a smooth gradient
    # with noise, and its differences, stand in for them here
    rng = np.random.default_rng(7)
    i = np.arange(12288)
    img = ((i // 64) * 3 + (i % 64) * 2) // 5 + rng.integers(-2, 3, i.size)
    img = (img & 255).astype(np.uint8)
    _run(img.tobytes())
    _run(np.diff(img, prepend=np.uint8(0)).astype(np.uint8).tobytes())


def test_fast_rule_equals_jax_package():
    """The port's fast rule returns the JAX package's slots at every climb
    level, and both trees end in the same state."""
    jfgk = pytest.importorskip("huffman_codec_tpu.pyref.fgk")

    class JaxTree(jfgk.FGKTree):
        """The JAX package's tree under the same instrumented update."""

        update = InstrumentedTree.update

        def __init__(self):
            super().__init__()
            self.mismatches = []
            self.fast_slots = []

    rng = random.Random(5)
    data = bytes(rng.choice(b"aaaabbbcdeffff\x00\x01") for _ in range(1500))
    port = _run(data)
    jax_tree = JaxTree()
    for sym in data:
        jax_tree.encode(sym)
        jax_tree.update(sym)
    assert jax_tree.mismatches == []
    assert port.fast_slots == jax_tree.fast_slots
    assert len(port.fast_slots) > 1000
    for field in ("freq", "symbol", "left", "right", "parent"):
        assert getattr(port, field) == getattr(jax_tree, field), field
