"""Horizontal and vertical stripes added (``df1hvx``), with sparse +-1
noise at ``noise_density`` of the pixels."""

from __future__ import annotations

import torch

from benchmark.data import ints, stripes_h, stripes_v


def make(n: int, g: torch.Generator, noise=None, band: int = 16,
         noise_density: float = 0.0):
    x = (stripes_h.make(n, g, band=band).to(torch.int32)
         + stripes_v.make(n, g, band=band))
    hit = torch.rand(n, generator=g, device=g.device) < float(noise_density)
    sign = ints(g, 0, 2, n) * 2 - 1
    return ((x + hit * sign) & 255).to(torch.uint8)
