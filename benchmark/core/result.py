"""A run's result line: the run (``loop`` or ``mesh``), the comparison
with the reference (``judge``), the metrics the cell names, each read by
its own file under ``benchmark/metrics``, and the device."""

from __future__ import annotations

import torch

from benchmark.core import judge
from benchmark.core.cells import Cell, metric_reader


def _device(cell: Cell, info: dict) -> dict:
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0)
           if torch.cuda.is_available() else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(info.get("memory_peak_bytes", 0))}
    if "trace_busy_s" in info:
        dev["busy_s"] = info["trace_busy_s"]
        dev["window_s"] = info["trace_window_s"]
    return dev


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        control=None, t_start=None, hooks=None):
    """Run ``cell`` once. Returns (the result line as a dict, the notes to
    print on standard error before it, the checks last)."""
    if cell.chips > 1:
        from benchmark.core import mesh

        run_data, checks, info, sampled = mesh.run_cell(
            cell, seed, seconds, trace, device=device, control=control,
            t_start=t_start, hooks=hooks)
    else:
        from benchmark.core import loop

        run_data, samples, info = loop.run_cell(
            cell, seed, seconds, trace, device=device, control=control,
            t_start=t_start)
        checks = judge.judge_single(samples, info["failed"], device)
        sampled = judge.sampled(samples)
    run_data.extra["info"] = info
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = metric_reader(m["name"])(run_data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace and run_data.trace is not None and run_data.trace.spans:
        lo, hi = run_data.trace.window()
        info.setdefault("trace_busy_s", run_data.trace.busy_us(lo, hi) / 1e6)
        info.setdefault("trace_window_s", (hi - lo) / 1e6)
    line = {"correct": judge.correct(checks),
            "attempted": info["attempted"], "failed": info["failed"],
            "metrics": metrics, "device": _device(cell, info)}
    if trace and run_data.trace is not None and run_data.trace.spans:
        line["breakdown"] = run_data.trace.breakdown()
    line["checks"] = judge.as_line(checks)
    notes = [f"bpc {info['bpc']!r} (8 x {info.get('bpc_of', 'container')} "
             f"bytes / input bytes over the pool)",
             f"window {info['window_s']!r} s, set-up {info['setup_s']!r} s, "
             f"answers judged {sampled}"]
    notes += [f"check {k} {v} limit {lim}" for k, (v, lim) in checks.items()]
    return line, notes
