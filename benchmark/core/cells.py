"""What a run finds by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix and its per-layer metrics' readers.

A configuration is ``benchmark/configs/<name>.json`` (named by the
``file`` of its entry), a mix ``benchmark/traffic/<traffic>.json`` and a
per-layer metric ``benchmark/metrics/<name>.py``, whose ``read(run)``
returns the metric's value or None where the run holds nothing to read.
Adding one of them is adding a file and an entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    mix: dict  # the traffic file's contents
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark at ``root``."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / "benchmark" / "traffic" /
                      f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name, int(w["chips"]), config, mix, e2e, layer)


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
