"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: an answer altered where it is
produced, a step that returns its state unchanged, half of the batch left
out, and in the four-rank cell the exchange between chips left out. And
the run prints no result without a card."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from benchmark.core import cells
from benchmark.tests import faults
from benchmark.tests.conftest import SEED, run_small, small


def _flip(data: bytes) -> bytes:
    b = bytearray(data)
    b[len(b) // 2] ^= 0x01
    return bytes(b)


@pytest.fixture
def codec(monkeypatch):
    from huffman_codec_tpu_torch.models.chunked import TorchCodec
    return TorchCodec


def _after_setup(name: str, real, alter):
    """``real`` with ``alter`` applied to its answers once the set-up has
    made its own (one a pool object), so that the decode pool is sound."""
    n = len(small(name).mix["data"]) and sum(
        int(d.get("count", 1)) for d in small(name).mix["data"])
    calls = [0]

    def wrapped(self, *args):
        calls[0] += 1
        out = real(self, *args)
        return alter(out) if calls[0] > n else out

    return wrapped


@pytest.mark.parametrize("name", ["sharded-m.bulk", "global-m.images"])
def test_encode_answer_altered(name, codec, monkeypatch):
    monkeypatch.setattr(codec, "encode",
                        _after_setup(name, codec.encode, _flip))
    line, _ = run_small(name)
    assert not line["correct"]
    assert line["checks"]["encode_bad_bytes"]["value"] > 0


@pytest.mark.parametrize("name", ["sharded-m.bulk", "global-m.images",
                                  "sharded-m.ranges"])
def test_decode_answer_altered(name, codec, monkeypatch):
    real_d, real_r = codec.decode, codec.decode_range
    monkeypatch.setattr(codec, "decode", lambda self, b: _flip(real_d(self,
                                                                      b)))
    monkeypatch.setattr(codec, "decode_range",
                        lambda self, b, s, m: _flip(real_r(self, b, s, m)))
    line, _ = run_small(name, seconds=4.0)  # decodes in the window
    assert any(k != "encode" for k in line["checks"]) and line["attempted"]
    assert not line["correct"]


def test_state_unchanged(codec, monkeypatch):
    """Every encode returns the first container it made."""
    first = {}
    monkeypatch.setattr(codec, "encode", _after_setup(
        "sharded-m.bulk", codec.encode,
        lambda out: first.setdefault("blob", out)))
    line, _ = run_small("sharded-m.bulk", seconds=6.0, judge_all=True)
    assert line["attempted"] > 2
    assert not line["correct"]


@pytest.mark.parametrize("name", ["sharded-m.bulk", "sharded-m.ranges"])
def test_half_the_batch_left_out(name, monkeypatch):
    from huffman_codec_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "rle_expand", kernels.rle_expand)
    faults.half_decoded()
    line, _ = run_small(name)
    assert not line["correct"]


def test_mesh_exchange_left_out(monkeypatch):
    from huffman_codec_tpu_torch.parallel import mesh as M

    # rank 0 is this process: the planted fault is undone after the test
    monkeypatch.setattr(M, "_carry_in", M._carry_in)
    line, _ = run_small("mesh4-m.bulk",
                        hooks=["benchmark.tests.faults:no_exchange"])
    assert not line["correct"]
    assert line["checks"]["encode_bad_bytes"]["value"] > 0


def test_mesh_half_the_batch_left_out(monkeypatch):
    from huffman_codec_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "rle_expand", kernels.rle_expand)
    line, _ = run_small("mesh4-m.bulk",
                        hooks=["benchmark.tests.faults:half_decoded"])
    assert not line["correct"]
    assert line["checks"]["decode_bad_bytes"]["value"] > 0


def test_mesh_rank_lost_ends_the_run():
    """A rank that dies before it answers ends the run at once, with no
    result, where the other ranks would wait for it for good."""
    script = ("import sys, time\nsys.path.insert(0, '.')\n"
              "from benchmark.core import result\n"
              "from benchmark.tests.conftest import SEED, small\n"
              "result.run(small('mesh4-m.bulk'), SEED, 1.0, False, "
              "device='cpu', t_start=time.perf_counter(), "
              "hooks=['benchmark.tests.faults:rank_lost'])\n"
              "print('result')\n")
    p = subprocess.run([sys.executable, "-c", script], cwd=cells.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 4, p.stderr[-2000:]
    assert "result" not in p.stdout
    assert "exited with 3" in p.stderr


def _run(cwd, *extra):
    cmd = [sys.executable, "benchmark/run.py", "--workload",
           "sharded-m.bulk", "--seed", str(SEED), "--seconds", "1",
           "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _run(cells.ROOT)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the files under
    ``paths``."""
    shutil.copy(cells.ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((cells.ROOT / "BENCHMARK.json").read_text())[
            "paths"]:
        shutil.copytree(cells.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()
