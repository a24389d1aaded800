"""Smooth 512-wide 8-bit gradients with noise of +-``noise``
(``chip_smoke.gradient_input``; the first tile's level comes from the
seed too), with a block of random bytes of up to ``random_block_max``
bytes (a quarter of the object at most) where the seed puts it."""

from __future__ import annotations

import torch

from benchmark.data import WIDTH, ints, one


def make(n: int, g: torch.Generator, noise: int,
         random_block_max: int = 0) -> torch.Tensor:
    i = torch.arange(n, device=g.device, dtype=torch.int32)
    row, col = (i // WIDTH) % WIDTH, i % WIDTH
    img = (i // (WIDTH * WIDTH)) * 37 + one(g, 0, 256)
    base = (row * 3 + col * 2) // 5 + img
    x = ((base + ints(g, -noise, noise + 1, n)) & 255).to(torch.uint8)
    if random_block_max:
        m = min(n // 4, int(random_block_max))
        at = one(g, 0, n - m + 1)
        x[at: at + m] = ints(g, 0, 256, m).to(torch.uint8)
    return x
