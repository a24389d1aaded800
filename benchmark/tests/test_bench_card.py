"""On the card: one short run of each one-chip cell through the
benchmark's command (``BENCHMARK.json``), correct, on the card's device.
Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.core import cells
from benchmark.tests.conftest import SEED


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sharded-m.bulk", "global-m.images",
                                  "sharded-m.ranges"])
def test_cell_on_the_card(name, card):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"], cwd=cells.ROOT,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
