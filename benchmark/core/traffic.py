"""The one traffic generator: a mix file (``benchmark/traffic/<mix>.json``)
holds only parameters, and this module turns them and a seed into the
pool of objects a run serves and the order of its requests.

Every seed gets the same work: the pool's object sizes, data models and
noise amplitudes come from the mix file alone, and the seed chooses their
order, the pixels, where a block of random bytes lands and where a range
starts. So two seeds differ in content and order, not in how much work a
window holds.

A mix file has these keys:

- ``requests``: the request kinds, served in turn (``encode``,
  ``decode``, ``range``);
- ``objects``: ``count``, and either ``bytes`` (every object that size) or
  ``min_bytes`` / ``max_bytes`` (sizes evenly spaced between them, each
  rounded up to a whole number of chunks less ``tail_short`` bytes, so
  the last chunk is partial);
- ``data``: a list of ``{"model", "count", ...}`` entries that fill the
  pool's slots in turn, each a model of ``benchmark/data`` found by name,
  with ``noise`` (a list of amplitudes dealt out round-robin) and the
  model's own parameters; or ``segments`` to build one object out of
  several models;
- ``range`` (for ``range`` requests): ``min_len``, ``max_len`` and
  ``count`` lengths spaced log-uniformly between them, served in an
  order the seed shuffles, each at a start the seed draws uniformly.

The request kinds are ``benchmark/requests``' modules and the data models
``benchmark/data``'s, each found by its name. The data is made with a
``torch.Generator`` on the device the run uses, so one seed gives the same
bytes on one kind of device (a CPU run and a card run differ).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from benchmark import data, requests
from benchmark.data import WIDTH


@dataclass
class Slot:
    """One object of the pool, before the seed fills it."""

    nbytes: int
    model: dict
    noise: int | None = None
    segments: list = field(default_factory=list)


def _sizes(obj: dict, chunk: int) -> list[int]:
    count = int(obj["count"])
    if "bytes" in obj:
        sizes = [int(obj["bytes"])] * count
    else:
        lo, hi = int(obj["min_bytes"]), int(obj["max_bytes"])
        step = (hi - lo) / max(count - 1, 1)
        short = int(obj.get("tail_short", 0))
        sizes = []
        for k in range(count):
            n = -(-int(round(lo + k * step)) // chunk) * chunk
            sizes.append(n - short)
    return sizes


def slots(mix: dict, chunk: int) -> list[Slot]:
    """The pool's slots, in the mix file's order (no seed yet)."""
    sizes = _sizes(mix["objects"], chunk)
    out: list[Slot] = []
    models = mix["data"]
    k = 0
    for m in models:
        noises = m.get("noise", [None])
        for j in range(int(m.get("count", 1))):
            out.append(Slot(sizes[k], m, noises[j % len(noises)],
                            m.get("segments", [])))
            k += 1
    if k != len(sizes):
        raise ValueError(f"the mix's data fills {k} slots, objects has "
                         f"{len(sizes)}")
    return out


def fill(slot: Slot, g: torch.Generator) -> torch.Tensor:
    """The bytes of one slot: one model, or ``segments`` laid end to end
    (each ``{"model", "share", "noise", ...}``; the shares split the
    object, the last segment takes the rest)."""
    if not slot.segments:
        return data.make(slot.nbytes, slot.model, slot.noise, g)
    parts, left = [], slot.nbytes
    for i, seg in enumerate(slot.segments):
        n = (left if i == len(slot.segments) - 1
             else int(slot.nbytes * float(seg["share"])) // WIDTH * WIDTH)
        parts.append(data.make(n, seg, seg.get("noise"), g))
        left -= n
    return torch.cat(parts)


@dataclass
class Pool:
    """The objects of one run, in the order the seed chose, and the
    request plan."""

    objects: list[np.ndarray]
    kinds: list[str]
    ranges: list[tuple[int, int]] = field(default_factory=list)

    def request(self, i: int) -> tuple[str, int]:
        """Request ``i`` of the closed loop: (kind, the index the kind
        picks: an object's, or a range's)."""
        kind = self.kinds[i % len(self.kinds)]
        return kind, requests.find(kind).pick(self, i, i // len(self.kinds))


def slot_seed(seed: int, k: int) -> int:
    """The generator seed of slot ``k`` under the run's ``seed``."""
    return int(np.random.SeedSequence([seed, k]).generate_state(
        2, np.uint32).astype(np.uint64) @ np.array([1 << 32, 1], np.uint64)
        >> np.uint64(1))


def build(mix: dict, seed: int, chunk: int, device="cpu") -> Pool:
    """The pool and the request plan of ``mix`` for ``seed``: the objects
    are made on ``device`` (a few large calls a slot, one generator a
    slot) and handed over as host arrays."""
    rng = np.random.default_rng(seed)
    sl = slots(mix, chunk)
    order = rng.permutation(len(sl))
    pool = []
    for k in order:
        g = torch.Generator(device=device)
        g.manual_seed(slot_seed(seed, int(k)))
        pool.append(fill(sl[k], g).cpu().numpy())
    plan = Pool(pool, list(mix["requests"]))
    if "range" in mix:
        r = mix["range"]
        lo, hi, count = int(r["min_len"]), int(r["max_len"]), int(r["count"])
        lens = np.exp(np.linspace(np.log(lo), np.log(hi), count))
        lens = rng.permutation(np.round(lens).astype(np.int64))
        n = len(pool[0])
        starts = rng.integers(0, n - lens + 1)
        plan.ranges = [(int(s), int(m)) for s, m in zip(starts, lens)]
    return plan
