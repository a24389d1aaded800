"""Vertical stripes (``df1v``): every column one level, a new level every
``band`` columns, every row alike."""

from __future__ import annotations

import torch

from benchmark.data import WIDTH, ints


def make(n: int, g: torch.Generator, noise=None, band: int = 16):
    levels = ints(g, 0, 256, -(-WIDTH // band))
    row = levels.repeat_interleave(band)[:WIDTH]
    return row.repeat(-(-n // WIDTH))[:n].to(torch.uint8)
