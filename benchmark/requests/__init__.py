"""The request kinds a mix names in ``requests``, one module a kind,
found by its name (``benchmark/requests/<kind>.py``). A module has:

- ``pick(pool, i, turn)``: what request ``i`` (the ``turn``-th round of
  the mix's kinds) serves, an object's or a range's index;
- ``warm(ctx)``: the set-up's call at the shapes the window uses;
- ``serve(ctx, k)``: one timed request, returning (the answer, its bytes
  for the rates, the work counts its span keeps for the readers);
- ``judge(samples, items, device)``: {check name: count} over the
  sampled answers ``items`` ((request, index, answer) each), after the
  window, by the plain reference.

``ctx`` (``benchmark.core.loop.Context``) holds the server, the
configuration, the pool, the objects as bytes and their containers from
the set-up.
A new kind is a new module here and its name in a mix: nothing else
changes.
"""

from __future__ import annotations

import importlib


def find(kind: str):
    """The module of request kind ``kind``."""
    return importlib.import_module(f"benchmark.requests.{kind}")
