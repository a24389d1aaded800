"""Differential model on the last axis of a uint8 tensor.

``y[i] = x[i] - x[i-1]`` (mod 256) with ``x[-1] := carry``; the revert is
the running sum mod 256. A batch of chunks takes one carry byte per row:
the byte that precedes the row in the original stream (0 at its start).
"""

from __future__ import annotations

import torch


def _carry_col(x: torch.Tensor, carry_in) -> torch.Tensor:
    carry = torch.as_tensor(carry_in, dtype=x.dtype, device=x.device)
    return carry.expand(x.shape[:-1]).unsqueeze(-1)


def diff_apply(x: torch.Tensor, carry_in=0) -> torch.Tensor:
    """``y[..., i] = x[..., i] - x[..., i-1]`` (mod 256), seeded by
    ``carry_in`` (a scalar or one byte per row)."""
    x = x.to(torch.uint8)
    if x.shape[-1] == 0:
        return x.clone()
    prev = torch.cat([_carry_col(x, carry_in), x[..., :-1]], dim=-1)
    return x - prev  # uint8 arithmetic wraps mod 256


def diff_revert(y: torch.Tensor, carry_in=0) -> torch.Tensor:
    """Inverse of ``diff_apply``: running sum mod 256 plus the carry."""
    carry = torch.as_tensor(carry_in, dtype=torch.int64, device=y.device)
    acc = torch.cumsum(y.to(torch.int64), dim=-1) + carry.unsqueeze(-1)
    return (acc & 0xFF).to(torch.uint8)
