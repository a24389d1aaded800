"""Shared helpers of the benchmark's CPU tests: cells cut to sizes a test
run holds, run on the CPU through the plain versions of the kernels."""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.core import cells, result  # noqa: E402

SEED = 2**31 + 4321  # past 32 signed bits, as real seeds may be


def small(name: str) -> cells.Cell:
    """The cell ``name`` with its traffic cut to a few hundred KiB (and
    the mesh's steps to 4 chunks), sizes that the plain versions run in
    seconds on the CPU. Only the scale changes: the models, the noise
    amplitudes and the request kinds are the mix file's."""
    cell = cells.find_cell(name)
    o = cell.mix["objects"]
    if "min_bytes" in o:
        o["min_bytes"], o["max_bytes"] = 3 << 16, 6 << 16
    elif o["bytes"] > 1 << 18:
        o["bytes"] = 6 << 16
    else:
        o["bytes"] = 1 << 15
    if "range" in cell.mix:
        cell.mix["range"]["max_len"] = 1 << 16
    if cell.chips > 1:
        cell.config["step_chunks"] = 4
    return cell


def run_small(name: str, seconds: float = 1.0, control=None, hooks=None,
              seed: int = SEED, judge_all: bool = False):
    """One run of the small cell on the CPU: (result line, notes);
    ``judge_all`` judges every answer of the window, not a sample."""
    cell = small(name)
    if judge_all:
        cell.mix["sample"] = {k: 10**6 for k in cell.mix["requests"]}
    return result.run(cell, seed, seconds, False, device="cpu",
                      control=control, t_start=time.perf_counter(),
                      hooks=hooks)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided here, at
    run time, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
