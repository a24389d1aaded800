"""The benchmark's readers of the FGK cell's per-layer metrics
(``benchmark/metrics``) on hand-built runs, and the cell itself as the
harness finds it.

* ``fgk_encode_s_per_GB.encode`` and ``fgk_decode_roofline`` read the
  trace's FGK kernels inside the spans of their kind;
  ``fgk_strip_s_per_GB.encode`` and ``fgk_rows_s_per_GB.decode`` the
  codec's spans of those names. Each returns None on a run without what
  it reads (the trace, the kernel, ``code_bits``, the span in requests of
  its kind), as on a program that lacks the kernel or the span.
* ``fgk_decode_roofline`` is the larger of the byte bound and the
  operation bound over the kernel's time: one run where each binds.
* ``sharded-fgk-m.bulk`` is found, names the ``v3_fgk`` reference, and
  every metric it reports has a reader.
"""

import pytest

pytest.importorskip("torch")

from benchmark import reference  # noqa: E402
from benchmark.codecs.torch_codec import fields  # noqa: E402
from benchmark.core import cells  # noqa: E402
from benchmark.core.loop import RunData, Span  # noqa: E402
from benchmark.core.peaks import HBM_BYTES_PER_S  # noqa: E402
from benchmark.core.trace import Trace  # noqa: E402
from benchmark.reference import v3_fgk  # noqa: E402

CELL = "sharded-fgk-m.bulk"
INT32_OPS_PER_S = 132 * 64 * 1.98e9
ENC_KERNEL = "void (anonymous namespace)::fgk_encode_kernel(unsigned char)"
DEC_KERNEL = "void (anonymous namespace)::fgk_decode_kernel(unsigned int)"
NEW = ("fgk_encode_s_per_GB.encode", "fgk_decode_roofline",
       "fgk_strip_s_per_GB.encode", "fgk_rows_s_per_GB.decode")


def _run(work=None, kernels=True, stages=None, trace=True) -> RunData:
    """One encode of 2e9 bytes in [0, 1000) us and one decode of 2e9 bytes
    in [1000, 2000) us; the FGK encode kernel runs 300 us in the encode
    (one launch of 100 us past it, in the decode, counts for nothing),
    the decode kernel 200 + 200 us in the decode."""
    work = {"payload_bytes": 10**9, "rle_bytes": 2 * 10**9,
            "code_bits": 10**9} if work is None else work
    spans = [Span("encode", 2 * 10**9, 0.0, 1e-3),
             Span("decode", 2 * 10**9, 1e-3, 2e-3, work)]
    run = RunData(cells.find_cell(CELL), spans,
                  {"encode": {}, "decode": {}} if stages is None else stages,
                  {"encode": 2 * 10**9, "decode": 2 * 10**9})
    if trace:
        dev = [(0.0, 50.0, "gpu_memcpy", "Memcpy HtoD (Pinned -> Device)"),
               (100.0, 300.0, "kernel", ENC_KERNEL),
               (1100.0, 100.0, "kernel", ENC_KERNEL),
               (1200.0, 200.0, "kernel", DEC_KERNEL),
               (1500.0, 200.0, "kernel", DEC_KERNEL)]
        if not kernels:
            dev = dev[:1]
        run.trace = Trace(device=dev, spans=[("encode", 0.0, 1000.0),
                                             ("decode", 1000.0, 1000.0)])
        run.traced_bytes = {"encode": 2 * 10**9, "decode": 2 * 10**9}
        run.extra["traced_spans"] = spans
    return run


def test_encode_kernel_per_GB():
    got = cells.metric_reader("fgk_encode_s_per_GB.encode")(_run())
    assert got == pytest.approx(300e-6 / 2, rel=1e-12)


@pytest.mark.parametrize("work,bound", [
    # 8e8 bytes at 3.35 TB/s (239 us) over 8e8 operations (48 us)
    ({"payload_bytes": 2 * 10**8, "rle_bytes": 6 * 10**8,
      "code_bits": 10**8}, "bytes"),
    # 4e9 operations at the INT32 rate (239 us) over 2e7 bytes (6 us)
    ({"payload_bytes": 10**7, "rle_bytes": 10**7, "code_bits": 5 * 10**8},
     "operations")])
def test_decode_roofline_takes_the_larger_bound(work, bound):
    got = cells.metric_reader("fgk_decode_roofline")(_run(work))
    nbytes = work["payload_bytes"] + work["rle_bytes"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 8 * work["code_bits"] / INT32_OPS_PER_S
    assert (t_bytes > t_ops) == (bound == "bytes")
    assert got == pytest.approx(100 * max(t_bytes, t_ops) / 400e-6,
                                rel=1e-12)
    assert 0 < got <= 100


@pytest.mark.parametrize("name,kind,span", [
    ("fgk_strip_s_per_GB.encode", "encode", "fgk strip"),
    ("fgk_rows_s_per_GB.decode", "decode", "fgk rows")])
def test_span_readers(name, kind, span):
    stages = {"encode": {"payload": 1.0}, "decode": {"bytes": 1.0}}
    stages[kind][span] = 0.5
    got = cells.metric_reader(name)(_run(stages=stages, trace=False))
    assert got == pytest.approx(0.5 / 2, rel=1e-12)


_NO_WORK = {"payload_bytes": 10**9, "rle_bytes": 2 * 10**9}
_OTHER_SPANS = {"encode": {"payload": 1.0}, "decode": {"bytes": 1.0}}


@pytest.mark.parametrize("name,run", [
    ("fgk_encode_s_per_GB.encode", lambda: _run(trace=False)),
    ("fgk_encode_s_per_GB.encode", lambda: _run(kernels=False)),
    ("fgk_decode_roofline", lambda: _run(trace=False)),
    ("fgk_decode_roofline", lambda: _run(kernels=False)),
    ("fgk_decode_roofline", lambda: _run(work=_NO_WORK)),
    ("fgk_strip_s_per_GB.encode", lambda: _run(stages=_OTHER_SPANS)),
    ("fgk_strip_s_per_GB.encode", lambda: _run(stages={
        "decode": {"fgk strip": 1.0}})),
    ("fgk_rows_s_per_GB.decode", lambda: _run(stages=_OTHER_SPANS)),
    ("fgk_rows_s_per_GB.decode", lambda: _run(stages={
        "encode": {"fgk rows": 1.0}})),
], ids=["encode-no-trace", "encode-no-kernel", "roofline-no-trace",
        "roofline-no-kernel", "roofline-no-code-bits", "strip-no-span",
        "strip-in-decodes", "rows-no-span", "rows-in-encodes"])
def test_none_without_what_it_reads(name, run):
    assert cells.metric_reader(name)(run()) is None


def test_the_cell_is_found():
    cell = cells.find_cell(CELL)
    assert cell.chips == 1 and cell.mix == cells.find_cell(
        "sharded-m.bulk").mix
    cfg = fields(cell.config)
    assert cfg["entropy"] == "fgk"
    assert cfg == {**fields(cells.find_cell("sharded-m.bulk").config),
                   "entropy": "fgk"}
    assert reference.for_config(cell.config, cfg) is v3_fgk
    bench = cells.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == "sharded-fgk-m")
    assert entry["source"] == cell.config["source"]
    assert entry["reduced"] == cell.config["reduced"] == ["object_bytes_max"]
    names = [m["name"] for m in cell.end_to_end + cell.per_layer]
    assert {"setup_s", "encode_MBps", "decode_MBps", *NEW} <= set(names)
    assert "lane_decode_roofline" not in names
    for name in names:
        assert callable(cells.metric_reader(name))
