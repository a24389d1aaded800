"""The codec's spans and counters (``TorchCodec.timer``, a
``utils.profiling.StageTimer``) on the CPU, and the benchmark's readers of
them.

* The global layout's encode and decode and the sharded ``decode_range``
  record exactly their span and counter names, and no span opens inside
  another; the v1 race counts its runs and wins: one v1 wins (a near-flat
  256 KiB image), one v3 wins, one that does not run (noise, whose v3
  container is over the race's 64 KiB).
* ``parse copied bytes`` holds the manifest arrays ``_parse`` copies: more
  than nothing and less than ``payload_off`` (the parse reads the manifest
  in place and never copies the payload).
* Containers and decoded bytes are the same with the timer on and off.
* Under ``torch.profiler`` each span is a ``codec.<name>`` range inside
  the caller's own range.
* The six readers under ``benchmark/metrics`` on a synthetic run: their
  values, and None where the run has no such span, counter or race.
"""

import contextlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark.core import cells  # noqa: E402
from benchmark.core.loop import RunData, Span  # noqa: E402
from huffman_codec_tpu_torch import TorchCodec  # noqa: E402
from huffman_codec_tpu_torch.models.chunked import CodecConfig  # noqa: E402
from huffman_codec_tpu_torch.utils.profiling import StageTimer  # noqa: E402

N = 512 * 512
ENCODE = {"upload", "dispatch", "wait", "crc32", "container"}
RACE = {"v1 race", "v1 races", "v1 wins"}
DECODE = {"parse", "parse copied bytes", "upload", "dispatch", "wait",
          "bytes", "crc32"}
RANGE = {"parse", "parse copied bytes", "host staging", "dispatch", "wait",
         "bytes"}


class FlatTimer(StageTimer):
    """A StageTimer that fails where a span opens inside another."""

    open_span = None

    @contextlib.contextmanager
    def stage(self, name, sync=None):
        assert self.open_span is None, f"{name} inside {self.open_span}"
        self.open_span = name
        try:
            with super().stage(name, sync):
                yield
        finally:
            self.open_span = None


def _image(kind: str) -> bytes:
    rng = np.random.default_rng(17)
    if kind == "near_flat":  # horizontal stripes, a level per 16 rows
        x = np.repeat(rng.integers(0, 256, N // (16 * 512)), 16 * 512)
    elif kind == "spikes":  # one level, 1% of the pixels another
        n = 1 << 15
        x = np.where(rng.random(n) < 0.01, 90, 77)
    else:
        x = rng.integers(0, 256, 72 << 10)
    return x.astype(np.uint8).tobytes()


def _timed(codec, fn, *args):
    codec.timer = FlatTimer()
    try:
        out = fn(*args)
        codec.timer.resolve()
        return out, codec.timer
    finally:
        codec.timer = None


@pytest.fixture(scope="module")
def global_codec():
    return TorchCodec(CodecConfig(use_diff=True), device="cpu")


@pytest.fixture(scope="module")
def sharded():
    codec = TorchCodec(CodecConfig(layout="sharded", chunk_size=512, lane=64,
                                   step_chunks=2, use_diff=True),
                       device="cpu")
    rng = np.random.default_rng(5)
    i = np.arange(7 * 512 + 99)
    data = (((i // 64) * 3 + rng.integers(-2, 3, i.size)) & 255).astype(
        np.uint8).tobytes()
    return codec, data, codec.encode(data)


@pytest.mark.parametrize("kind,races,wins", [("near_flat", 1, 1),
                                             ("spikes", 1, 0),
                                             ("noise", None, None)])
def test_global_encode_spans_and_race(global_codec, kind, races, wins):
    data = _image(kind)
    blob, t = _timed(global_codec, global_codec.encode, data)
    assert blob == global_codec.encode(data)  # the timer changes nothing
    assert set(t.stages) == ENCODE | (RACE if races else set())
    assert t.stages.get("v1 races") == races
    assert t.stages.get("v1 wins") == wins
    assert t.counters == ({"v1 races", "v1 wins"} if races else set())
    assert (blob[:6] == b"HCTPU\x03") == (wins != 1)


def test_global_decode_spans(global_codec):
    data = _image("spikes")
    blob = global_codec.encode(data)
    assert blob[:6] == b"HCTPU\x03"
    out, t = _timed(global_codec, global_codec.decode, blob)
    assert out == data == global_codec.decode(blob)
    assert set(t.stages) == DECODE and t.counters == {"parse copied bytes"}
    v1 = global_codec.encode(_image("near_flat"))
    out, t = _timed(global_codec, global_codec.decode, v1)
    assert out == _image("near_flat") and set(t.stages) == {"v1 decode"}


def test_decode_range_spans(sharded):
    codec, data, blob = sharded
    out, t = _timed(codec, codec.decode_range, blob, 700, 1500)
    assert out == data[700:2200] == codec.decode_range(blob, 700, 1500)
    assert set(t.stages) == RANGE and t.counters == {"parse copied bytes"}
    # the parse copies manifest arrays only, never the payload
    payload_off = codec._parse(blob)["payload_off"]
    assert payload_off < len(blob)
    assert 0 < t.stages["parse copied bytes"] < payload_off
    assert codec._parse(blob, None)["payload_off"] == codec._parse(
        blob, StageTimer())["payload_off"]


def test_counters_apart_in_the_report():
    t = StageTimer()
    with t.stage("parse"):
        pass
    t.count("parse copied bytes", 1234567)
    t.count("v1 races")
    t.count("v1 races")
    t.resolve()
    assert t.stages["v1 races"] == 2 and t.counters == {
        "parse copied bytes", "v1 races"}
    lines = t.report().splitlines()
    assert "%" in lines[0] and "parse" in lines[0]
    assert lines[1:] == [f"{'parse copied bytes':>16s}  1,234,567",
                         f"{'v1 races':>16s}  2"]


def test_spans_in_the_profiler_trace(global_codec, sharded, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    codec, _, blob = sharded
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for c, fn, args in ((global_codec, global_codec.encode,
                             (_image("spikes"),)),
                            (codec, codec.decode_range, (blob, 10, 3000))):
            c.timer = StageTimer()
            with torch.profiler.record_function("bench.x"):
                fn(*args)
            c.timer = None
        with torch.profiler.record_function("bench.untimed"):
            codec.decode_range(blob, 10, 3000)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    outer = [(e["ts"], e["ts"] + e["dur"]) for e in evs
             if e["name"] == "bench.x"]
    untimed = [(e["ts"], e["ts"] + e["dur"]) for e in evs
               if e["name"] == "bench.untimed"]
    spans = [e for e in evs if e["name"].startswith("codec.")]
    assert len(outer) == 2 and len(untimed) == 1
    assert {e["name"] for e in spans} == {
        "codec." + n for n in (ENCODE | RANGE | {"v1 race"})
        if n not in ("v1 races", "parse copied bytes")}
    for e in spans:
        assert any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                   for a, b in outer), e["name"]
    # with no timer set, no span is entered
    a, b = untimed[0]
    assert not [e for e in spans if a <= e["ts"] < b]


def _run(kind_counts: dict, stages: dict) -> RunData:
    spans = [Span(k, 1, 0.0, 1.0) for k, n in kind_counts.items()
             for _ in range(n)]
    return RunData(cells.find_cell("global-m.images"), spans, stages,
                   {k: 1 for k in kind_counts})


@pytest.mark.parametrize("name,kinds,stages,want", [
    ("parse_ms.range", {"range": 4}, {"range": {"parse": 0.2}}, 50.0),
    ("parse_copied_MB.range", {"range": 4},
     {"range": {"parse copied bytes": 480e6}}, 120.0),
    ("dispatch_ms.encode", {"encode": 5, "decode": 5},
     {"encode": {"dispatch": 0.075}, "decode": {"dispatch": 1.0}}, 15.0),
    ("v1_race_ms.encode", {"encode": 8}, {"encode": {"v1 race": 0.016}},
     2.0),
    ("v1_race_win_share.encode", {"encode": 8},
     {"encode": {"v1 races": 4, "v1 wins": 1}}, 25.0),
    ("v1_race_win_share.encode", {"encode": 8},
     {"encode": {"v1 races": 4, "v1 wins": 0}}, 0.0),
    ("v1_decode_ms.decode", {"decode": 10, "encode": 3},
     {"decode": {"v1 decode": 0.03}}, 3.0),
])
def test_readers_on_a_synthetic_run(name, kinds, stages, want):
    got = cells.metric_reader(name)(_run(kinds, stages))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name,kinds,stages", [
    ("parse_ms.range", {"range": 4}, {"range": {"host staging": 0.1}}),
    ("parse_ms.range", {"encode": 4}, {"range": {"parse": 0.1}}),
    ("parse_copied_MB.range", {"range": 4}, {"range": {}}),
    ("dispatch_ms.encode", {"encode": 4}, {"encode": {"D2H": 0.1}}),
    ("v1_race_ms.encode", {"encode": 4}, {"encode": {"dispatch": 0.1}}),
    ("v1_race_win_share.encode", {"encode": 4}, {"encode": {}}),
    ("v1_race_win_share.encode", {"encode": 4}, {"encode": {
        "v1 races": 0, "v1 wins": 0}}),
    ("v1_decode_ms.decode", {"decode": 4}, {"decode": {"parse": 0.1}}),
    ("v1_decode_ms.decode", {"decode": 4}, {}),
])
def test_readers_none_without_their_span(name, kinds, stages):
    assert cells.metric_reader(name)(_run(kinds, stages)) is None
