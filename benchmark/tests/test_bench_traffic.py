"""The traffic generator: one seed gives the same pool and plan, another
seed the same amount of work in other bytes and another order."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.core import cells, traffic
from benchmark.tests.conftest import SEED, small

CELLS = sorted(w["name"] for w in cells.load_benchmark()["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_same_seed_same_pool(name):
    cell = small(name)
    cs = cell.config["chunk_size"]
    a = traffic.build(cell.mix, SEED, cs)
    b = traffic.build(cell.mix, SEED, cs)
    assert len(a.objects) == len(b.objects)
    for x, y in zip(a.objects, b.objects):
        np.testing.assert_array_equal(x, y)
    assert a.ranges == b.ranges
    assert [a.request(i) for i in range(50)] == [b.request(i)
                                                 for i in range(50)]


@pytest.mark.parametrize("name", CELLS)
def test_other_seed_same_work(name):
    cell = small(name)
    cs = cell.config["chunk_size"]
    a = traffic.build(cell.mix, SEED, cs)
    b = traffic.build(cell.mix, SEED + 1, cs)
    assert sorted(map(len, a.objects)) == sorted(map(len, b.objects))
    assert any(len(x) != len(y) or not np.array_equal(x, y)
               for x, y in zip(a.objects, b.objects))
    assert sorted(m for _, m in a.ranges) == sorted(m for _, m in b.ranges)


def test_sizes_of_the_mixes():
    """The mix files' own sizes: bulk 16-128 MiB with a partial last
    chunk, images 256 KiB with 3 of 12 near-flat, ranges one 128 MiB
    corpus with 4 KiB-1 MiB ranges, the mesh 64-256 MiB."""
    cs = 1 << 16
    bulk = traffic.slots(cells.find_cell("sharded-m.bulk").mix, cs)
    assert min(s.nbytes for s in bulk) > 15 << 20
    assert max(s.nbytes for s in bulk) <= 128 << 20
    assert all(s.nbytes % cs for s in bulk)
    img = traffic.slots(cells.find_cell("global-m.images").mix, cs)
    assert {s.nbytes for s in img} == {1 << 18} and len(img) == 12
    assert sum(s.model["model"] != "gradient" for s in img) == 3
    rng = cells.find_cell("sharded-m.ranges").mix
    assert traffic.slots(rng, cs)[0].nbytes == 128 << 20
    assert (rng["range"]["min_len"], rng["range"]["max_len"]) == (4096,
                                                                  1 << 20)
    mesh = traffic.slots(cells.find_cell("mesh4-m.bulk").mix, cs)
    assert min(s.nbytes for s in mesh) > 63 << 20
    assert max(s.nbytes for s in mesh) <= 256 << 20
