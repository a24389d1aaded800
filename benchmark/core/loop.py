"""One run of a one-chip cell: set-up, the measured window (a closed loop
of one caller), the traced slice, and what the run hands to the metrics
and to the reference.

The caller serves the mix's requests in turn (``traffic.Pool.request``),
each through its kind's module (``benchmark/requests``) on the server the
configuration names (``benchmark/codecs``: the port's ``TorchCodec``, whose
``encode``, ``decode`` and ``decode_range`` are the public entries), each
timed on the host clock from the caller's bytes to the result's bytes on
the host. A span records each request: its kind, its bytes, its start and
end. The window ends with the first request that ends past ``--seconds``;
every request in it counts.
"""

from __future__ import annotations

import os
import struct
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from benchmark import codecs, requests
from benchmark.codecs.torch_codec import fields as codec_config
from benchmark.core import traffic
from benchmark.core.cells import Cell
from benchmark.core.trace import SPAN_PREFIX, Trace
from benchmark.reference import container as C

# the traced slice of a --trace 1 run: its first seconds (and at least one
# request of each kind), so that the Chrome trace stays at tens of MB
TRACE_SLICE_S = 3.0


@dataclass
class Span:
    kind: str
    nbytes: int
    t0: float
    t1: float
    work: dict = field(default_factory=dict)  # per-request counts

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class RunData:
    """What the metrics' readers see."""

    cell: Cell
    spans: list
    stages: dict  # kind -> stage name -> seconds, summed (trace runs)
    stage_bytes: dict  # kind -> bytes of the requests the stages cover
    trace: Trace | None = None
    traced_bytes: dict = field(default_factory=dict)  # kind -> bytes
    extra: dict = field(default_factory=dict)


class Reservoir:
    """A uniform sample of ``k`` of a stream's items, drawn from a seed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item


@dataclass
class Context:
    """What a request kind's module sees (``benchmark/requests``)."""

    server: object
    config: dict  # the configuration file's contents
    pool: traffic.Pool
    objs: list  # the pool's objects as bytes
    blobs: list  # each object's encode, made in the set-up
    sizes: list  # work counts of each container (``_sizes``)


class Lossy:
    """The control: the program behind a step that breaks the lossless
    guarantee, the lowest bit of every input byte cleared before the
    encode (what a codec tempted to trade a bit of noise for size would
    do)."""

    def __init__(self, codec):
        self.codec = codec

    def encode(self, data: bytes) -> bytes:
        x = np.frombuffer(data, np.uint8) & np.uint8(0xFE)
        return self.codec.encode(x.tobytes())

    def __getattr__(self, name):
        return getattr(self.codec, name)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _sizes(blob: bytes) -> dict:
    """Work counts of a sharded canonical container from its header and
    manifest (the roofline readers' bytes): the RLE bytes and the payload
    bytes."""
    if blob[:6] != C.MAGIC or not blob[7] & C.FLAG_SHARDED:
        return {}
    tw, kw = blob[9], blob[10]
    orig, total, cs, nc, lane, _ = struct.unpack_from("<QQIIII", blob, 11)
    rl = np.frombuffer(blob, "<u4", nc, C.HEADER).astype(np.int64)
    entries = int((-(-rl // lane)).sum())
    off = (C.HEADER + 5 * nc + (nc * 256 * tw + 7) // 8
           + (entries * kw + 7) // 8)
    return {"rle_bytes": int(total), "payload_bytes": len(blob) - off,
            "out_bytes": int(orig)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", control: str | None = None, t_start=None):
    """One run of a one-chip cell. Returns (RunData, samples for the
    reference, {"attempted", "failed", "setup_s", "memory_peak_bytes",
    "bpc", "trace_busy_s", "trace_window_s"})."""
    t_start = time.perf_counter() if t_start is None else t_start
    cfg = codec_config(cell.config)
    codec = codecs.build(cell.config, device)
    server = Lossy(codec) if control == "lsb" else codec
    if control not in (None, "lsb"):
        raise ValueError(f"unknown control {control!r}")
    pool = traffic.build(cell.mix, seed, cfg["chunk_size"], device)
    objs = [o.tobytes() for o in pool.objects]
    kinds = list(dict.fromkeys(pool.kinds))
    mods = {k: requests.find(k) for k in kinds}
    # set-up: every object encoded once (the decode pool, and the encode's
    # warm-up: kernel builds, the step graph, the host runtime), and each
    # request kind run once more at the shapes the window uses
    blobs = [server.encode(o) for o in objs]
    ctx = Context(server, cell.config, pool, objs, blobs,
                  [_sizes(b) for b in blobs])
    failed = 0
    for k in kinds:
        try:
            mods[k].warm(ctx)
        except Exception:  # noqa: BLE001 - counted, and the window shows it
            failed += 1
    _sync(device)
    if device != "cpu" and torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    bpc = 8.0 * sum(len(b) for b in blobs) / sum(len(o) for o in objs)
    timed = hasattr(codec, "timer")
    if timed:
        from huffman_codec_tpu_torch.utils.profiling import StageTimer

    rng = np.random.default_rng([seed, 7])
    sample_k = cell.mix.get("sample", {})
    res = {k: Reservoir(int(sample_k.get(k, 4)), rng) for k in kinds}
    spans = []
    stages = {k: {} for k in kinds}
    stage_bytes = {k: 0 for k in kinds}
    prof = None
    trace_path = Path(os.environ.get("TMPDIR", tempfile.gettempdir())) / (
        f"benchmark_trace_{cell.name}.json")
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    t_win = time.perf_counter()
    i = 0
    while True:
        kind, k = pool.request(i)
        if trace and timed:
            codec.timer = StageTimer()
        tracing = prof is not None
        ann = (torch.profiler.record_function(SPAN_PREFIX + kind)
               if tracing else None)
        if ann is not None:
            ann.__enter__()
        t0 = time.perf_counter()
        out, nbytes, work = None, 0, {}
        try:
            out, nbytes, work = mods[kind].serve(ctx, k)
        except Exception as e:  # noqa: BLE001 - a failed request is counted
            failed += 1
            out = e
        t1 = time.perf_counter()
        if ann is not None:
            ann.__exit__(None, None, None)
        spans.append(Span(kind, nbytes, t0, t1, work))
        res[kind].offer((i, k, out))
        if trace and timed:
            codec.timer.resolve()
            for name, sec in codec.timer.stages.items():
                stages[kind][name] = stages[kind].get(name, 0.0) + sec
            stage_bytes[kind] += nbytes
            codec.timer = None
        i += 1
        if (prof is not None and t1 - t_win >= min(TRACE_SLICE_S, seconds)
                and i >= len(pool.kinds)):  # every kind traced once
            _sync(device)
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(str(trace_path))
            prof = None
        if t1 - t_win >= seconds:
            break
    _sync(device)
    if prof is not None:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(trace_path))
    info = {"attempted": len(spans), "failed": failed, "setup_s": setup_s,
            "bpc": bpc, "window_s": time.perf_counter() - t_win}
    if torch.device(device).type == "cuda":
        info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    run = RunData(cell, spans, stages, stage_bytes)
    if trace:
        run.trace = Trace.load(trace_path)
        trace_path.unlink()
        run.traced_bytes = {
            kind: sum(s.nbytes for s in spans[: len(run.trace.spans)]
                      if s.kind == kind) for kind in kinds}
        run.extra["traced_spans"] = spans[: len(run.trace.spans)]
    samples = {"objects": pool.objects, "ranges": pool.ranges,
               "config": cfg, "results": {k: res[k].items for k in kinds}}
    # the program's state goes before the reference runs
    del codec, server, blobs, ctx
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return run, samples, info
