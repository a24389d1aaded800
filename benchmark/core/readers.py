"""What the metric readers under ``benchmark/metrics`` share: rates and
tails over the window's spans, the stage split per GB, and a kernel's
roofline share from the trace."""

from __future__ import annotations

import numpy as np

from benchmark.core.peaks import HBM_BYTES_PER_S

GB = 1e9


def rate_MBps(run, kinds) -> float | None:
    """Bytes of every request of ``kinds`` in the window (1e6 B a MB) over
    the summed wall time of those requests."""
    sp = [s for s in run.spans if s.kind in kinds]
    if not sp:
        return None
    return sum(s.nbytes for s in sp) / 1e6 / sum(s.seconds for s in sp)


def p95_ms(run, kinds) -> float | None:
    """The 95th percentile (linear interpolation) of the wall time of all
    requests of ``kinds`` in the window, in ms."""
    sp = [s.seconds for s in run.spans if s.kind in kinds]
    if not sp:
        return None
    return float(np.percentile(np.asarray(sp), 95)) * 1e3


def stage_s_per_GB(run, kind: str, names) -> float | None:
    """Seconds of the stage split's ``names`` over the requests of
    ``kind``, per GB of those requests' bytes (a trace run's stages)."""
    st, nb = run.stages.get(kind), run.stage_bytes.get(kind, 0)
    if not st or not nb or not any(n in st for n in names):
        return None
    return sum(st.get(n, 0.0) for n in names) / (nb / GB)


def idle_pct(run, kind: str) -> float | None:
    if run.trace is None or not run.trace.device:
        return None
    share = run.trace.idle_share(kind)
    return None if share is None else 100.0 * share


def roofline_pct(run, kind: str, kernel: str, work) -> float | None:
    """A kernel's share of its roofline over the traced requests of
    ``kind``: the bytes ``work(span)`` counts for each (read once and
    written once) over the memory rate, divided by the trace's summed time
    of the kernels whose name holds ``kernel``. None where the trace has
    no such kernel or the requests no such work."""
    if run.trace is None:
        return None
    evs = run.trace.device_events(
        kind, lambda cat, name: cat == "kernel" and kernel in name)
    t = sum(e[1] for e in evs) / 1e6
    nbytes = sum(work(s) for s in run.extra.get("traced_spans", [])
                 if s.kind == kind)
    if t <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / t
