"""The harness finds every configuration, mix and metric by the name in
``BENCHMARK.json``, and a new one added as files and entries is found
without an edit to a file the benchmark has; ``BENCHMARK.json`` keeps to
its contract's shape."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.core import cells

BENCH = cells.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_found(w):
    cell = cells.find_cell(w)
    assert cell.config["name"] == next(
        x["config"] for x in BENCH["workloads"] if x["name"] == w)
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.metric_reader(m["name"]))


def test_shape_of_benchmark_json():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert json.loads((cells.ROOT / c["file"]).read_text())[
            "reduced"] == c["reduced"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells_ = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells_
        for w in m["workloads"]:
            assert any(e["name"] == m["moves"]
                       and w in e.get("workloads", cells_)
                       for e in BENCH["end_to_end"])
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_added_files_are_found(tmp_path):
    """A configuration, a mix and a per-layer metric added as new files
    and entries, in a copy of the benchmark, are found by name."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.BENCH_DIR, root / "benchmark")
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((cells.ROOT / bench["configs"][0]["file"]).read_text())
    cfg["name"] = "sharded-m-nodiff"
    cfg["use_diff"] = False
    (root / "benchmark/configs/sharded-m-nodiff.json").write_text(
        json.dumps(cfg))
    (root / "benchmark/traffic/tiny.json").write_text(json.dumps(
        {"requests": ["encode"], "objects": {"count": 1, "bytes": 4096},
         "data": [{"model": "gradient", "count": 1, "noise": [2]}]}))
    (root / "benchmark/metrics/requests_seen.py").write_text(
        "def read(run):\n    return float(len(run.spans))\n")
    bench["configs"].append({
        "name": "sharded-m-nodiff", "source": "x",
        "file": "benchmark/configs/sharded-m-nodiff.json", "reduced": [],
        "why": "x"})
    bench["workloads"].append({"name": "sharded-m-nodiff.tiny",
                               "config": "sharded-m-nodiff",
                               "traffic": "tiny", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("sharded-m-nodiff.tiny")
    bench["per_layer"].append({
        "name": "requests_seen", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "codec host",
        "moves": bench["end_to_end"][0]["name"],
        "workloads": ["sharded-m-nodiff.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.find_cell("sharded-m-nodiff.tiny", root)
    assert cell.config["use_diff"] is False
    assert cell.mix["objects"]["bytes"] == 4096
    assert [m["name"] for m in cell.per_layer] == ["requests_seen"]
    read = cells.metric_reader("requests_seen", root)

    class Run:
        spans = [1, 2, 3]

    assert read(Run()) == 3.0


def test_added_modules_are_found(tmp_path):
    """A data model, a request kind and a system under test added as new
    modules, in a copy of the benchmark, are found by the names a mix and
    a configuration give them."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "benchmark/data/flat.py").write_text(
        "import torch\n\n\ndef make(n, g, noise=None, level=0):\n"
        "    return torch.full((n,), level, dtype=torch.uint8)\n")
    (root / "benchmark/requests/echo.py").write_text(
        "def pick(pool, i, turn):\n    return turn % len(pool.objects)\n\n\n"
        "def warm(ctx):\n    pass\n\n\n"
        "def serve(ctx, k):\n    out = ctx.server.echo(ctx.objs[k])\n"
        "    return out, len(out), {}\n\n\n"
        "def judge(samples, items, device):\n"
        "    return {'echo_bad': sum(out != samples['objects'][k].tobytes()"
        " for _, k, out in items)}\n")
    (root / "benchmark/codecs/echo_server.py").write_text(
        "class Echo:\n    def echo(self, b):\n        return b\n\n\n"
        "def build(config, device):\n    return Echo()\n")
    script = """
import sys
sys.path.insert(0, '.')
from benchmark import codecs
from benchmark.core import judge, loop, traffic
mix = {'requests': ['echo'], 'objects': {'count': 2, 'bytes': 4096},
       'data': [{'model': 'flat', 'count': 2, 'level': 7}]}
pool = traffic.build(mix, 5, 65536)
assert all((o == 7).all() for o in pool.objects)
server = codecs.build({'codec': 'echo_server'}, 'cpu')
ctx = loop.Context(server, {}, pool,
                   [o.tobytes() for o in pool.objects], [], [])
kind, k = pool.request(3)
out, n, _ = __import__('benchmark.requests.echo',
                       fromlist=['x']).serve(ctx, k)
samples = {'objects': pool.objects, 'results': {'echo': [(3, k, out)]}}
print(kind, n, judge.judge_single(samples, 0, 'cpu'))
"""
    p = subprocess.run([sys.executable, "-c", script], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split() == ["echo", "4096", "{'failed_requests':",
                                "(0,", "0),", "'echo_bad':", "(0,", "0)}"]
