"""The control and the sound runs, at a size a test run holds on the
CPU: each one-chip cell comes out correct on the program and not correct
on the control (the lowest bit of every input byte cleared before the
encode, which breaks the lossless guarantee), and the numbers compared are
printed with their limits."""

from __future__ import annotations

import pytest

from benchmark.tests.conftest import run_small

ONE_CHIP = ["sharded-m.bulk", "global-m.images", "sharded-m.ranges"]


@pytest.mark.parametrize("name", ONE_CHIP)
def test_sound_run_is_correct(name):
    line, notes = run_small(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert all(c["limit"] == 0 for c in line["checks"].values())
    assert notes[-1].startswith("check ")
    assert {"setup_s"} < set(line["metrics"])


@pytest.mark.parametrize("name", ONE_CHIP)
def test_control_is_not_correct(name):
    line, _ = run_small(name, control="lsb")
    assert not line["correct"]
    bad = [k for k, c in line["checks"].items() if c["value"] > c["limit"]]
    assert bad, line["checks"]


def test_mesh_sound_and_control():
    """The four-rank cell over gloo on the CPU."""
    line, _ = run_small("mesh4-m.bulk")
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4
    line, _ = run_small("mesh4-m.bulk", control="lsb")
    assert not line["correct"]
