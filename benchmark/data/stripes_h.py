"""Horizontal stripes (``df1h``): every row one level, a new level every
``band`` rows."""

from __future__ import annotations

import torch

from benchmark.data import WIDTH, ints


def make(n: int, g: torch.Generator, noise=None, band: int = 16):
    rows = -(-n // WIDTH)
    levels = ints(g, 0, 256, -(-rows // band))
    per_row = levels.repeat_interleave(band)[:rows]
    return per_row.repeat_interleave(WIDTH)[:n].to(torch.uint8)
