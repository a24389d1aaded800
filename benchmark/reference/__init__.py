"""The benchmark's plain reference, in NumPy and plain PyTorch. It judges
what the program's timed calls returned against the input the benchmark
made, and imports nothing of the program, of JAX or of the JAX package.

- ``judge_encode``: an encode's result, a v3 container (``container``)
  or, in the global layout, the v1 blob of the race (``v1``), which is
  kept only where it is strictly smaller than the v3 container;
- ``judge_bytes``: a decode's (or a range's) bytes against the input's;
- ``container.judge_columns``: a mesh step's gathered outputs.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import container, v1

# the v1 race runs on inputs of at most this many bytes whose v3
# container is at most V1_RACE_MAX_OUT bytes
V1_RACE_MAX_IN = 1 << 20
V1_RACE_MAX_OUT = 1 << 16


def judge_bytes(got: bytes, want: np.ndarray) -> int:
    """Bytes that differ, a length difference counting as differing."""
    return container._mismatch(got, want.tobytes())


def judge_encode(blob: bytes, data: np.ndarray, cfg: dict, device) -> dict:
    """Judge one encode result; see ``container.judge_v3``.

    In the global layout the result must also be the smallest of what the
    layout chooses from: the whole-file candidate, the chunked one (the
    first wins a tie) and, where the smaller is at most
    ``V1_RACE_MAX_OUT`` bytes and the input at most ``V1_RACE_MAX_IN``,
    the v1 blob, kept only where strictly smaller. The v1 blob is the
    reference's own, byte for byte; a candidate's size is known between
    two bounds (``container.global_size_bounds``), so a result counts as
    not the smallest only where the bounds prove it, and then all its
    bytes count as differing. Returns {"bad_bytes", "bad_tables", "v1": 1
    if the result is a v1 blob}."""
    use_diff = bool(cfg["use_diff"])
    glob = cfg["layout"] == "global"
    race = glob and len(data) <= V1_RACE_MAX_IN
    if glob:
        geos = container.global_geometries(
            len(data), int(cfg["chunk_size"]), bool(cfg.get("whole_file",
                                                            True)))
        bounds = [container.global_size_bounds(data, use_diff, g, device)
                  for g in geos]
    if blob[:6] == container.MAGIC:
        out = container.judge_v3(blob, data, cfg, device)
        out["v1"] = 0
        if glob:
            out["bad_bytes"] += _not_smallest(blob, geos, bounds)
        if race and len(blob) <= V1_RACE_MAX_OUT:
            ref = v1.v1_blob(data, use_diff)
            if len(ref) < len(blob):
                out["bad_bytes"] += len(ref)
        return out
    ref = v1.v1_blob(data, use_diff)
    bad = container._mismatch(blob, ref) if race else max(len(blob), 1)
    if race and (min(hi for _, hi in bounds) <= len(blob)
                 or min(lo for lo, _ in bounds) > V1_RACE_MAX_OUT):
        bad += len(blob)  # a v3 container no larger, or no race to run
    return {"bad_bytes": bad, "bad_tables": 0, "v1": 1}


def _not_smallest(blob: bytes, geos, bounds) -> int:
    """All of a global container's bytes where another candidate is
    proven smaller (or as small and first in the order), else 0."""
    geo = container.geometry_of(blob)
    if geo not in geos:
        return 0  # judge_v3 has counted a container of no candidate's shape
    me = geos.index(geo)
    for j, (_, hi) in enumerate(bounds):
        if j != me and (hi < len(blob) or (j < me and hi <= len(blob))):
            return len(blob)
    return 0
