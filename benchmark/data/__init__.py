"""The data models a mix's ``data`` entries name, one module a model,
found by its name (``benchmark/data/<model>.py``). A module's
``make(n, g, noise, **params)`` returns ``n`` bytes (a uint8 tensor on the
device of the ``torch.Generator`` ``g``); ``noise`` is the slot's
amplitude, dealt out from the entry's ``noise`` list, and ``params`` the
entry's other keys. A new model is a new module and its name in a mix.

The models copy ``chip_smoke.gradient_input`` (512-wide 8-bit gradients
with noise, a new 512 x 512 tile every 256 KiB) and add near-flat images
like the reference corpus's ``df1h``, ``df1v`` and ``df1hvx``.
"""

from __future__ import annotations

import importlib

import torch

WIDTH = 512
# an entry's keys that are not its model's parameters
NOT_PARAMS = ("model", "count", "noise", "share", "segments")


def ints(g: torch.Generator, lo: int, hi: int, n: int) -> torch.Tensor:
    """``n`` int32 drawn uniformly from [lo, hi) on ``g``'s device."""
    return torch.randint(lo, hi, (n,), generator=g, device=g.device,
                         dtype=torch.int32)


def one(g: torch.Generator, lo: int, hi: int) -> int:
    return int(ints(g, lo, hi, 1)[0])


def make(n: int, entry: dict, noise, g: torch.Generator) -> torch.Tensor:
    """``n`` bytes of the model an entry names."""
    mod = importlib.import_module(f"benchmark.data.{entry['model']}")
    params = {k: v for k, v in entry.items() if k not in NOT_PARAMS}
    return mod.make(n, g, noise, **params)
