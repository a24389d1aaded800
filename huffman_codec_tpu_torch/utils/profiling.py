"""Per-stage wall timers and counters, device times from CUDA events,
and profiler traces.

Usage::

    with StageTimer() as t:
        with t.stage("encode", sync=out):
            out = codec.encode(data)
    print(t.report())

    codec.timer = StageTimer()  # the codec's spans and counters
    codec.encode(data)
    codec.timer.resolve()  # device stages timed by CUDA events
    codec.timer.stages["crc32"]  # seconds of a span
    codec.timer.stages["v1 races"]  # a counter (in codec.timer.counters)

    seconds = device_time(kernels.histogram256, (data, lengths))

    with device_trace("/tmp/trace") as path:  # a Chrome trace, Perfetto
        codec.encode(data)
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

# device clocks to spin per timed run, so that the host has enqueued every
# run before the first starts (a wrapper call costs tens of microseconds)
QUEUE_CYCLES_PER_RUN = 400_000

# the prefix of a host span's profiler range
SPAN_PREFIX = "codec."


@dataclass
class StageTimer:
    """Named totals of spans and counters, both in ``stages``.

    A span adds seconds: ``stage`` on the host clock, ``device_stage``
    from CUDA events (added by ``resolve``). A counter adds a number of
    things, bytes or calls (``count``); its name goes into ``counters``,
    so a reader of ``stages`` tells the two apart by name.
    ``TorchCodec.timer`` lists the names the codec records.

    While a profiler records, each host span is also a
    ``torch.profiler.record_function("codec.<name>")`` range, so that the
    profiler puts the spans on its own clock, beside the device's work."""

    stages: dict[str, float] = field(default_factory=dict)
    counters: set[str] = field(default_factory=set)
    _t0: float = 0.0
    _events: list = field(default_factory=list)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stages.setdefault("total", time.perf_counter() - self._t0)

    @contextlib.contextmanager
    def stage(self, name: str, sync: torch.Tensor | None = None):
        """Time one stage; pass ``sync=tensor`` to wait for the work queued
        on that tensor's CUDA device (launches return before the device
        has run them, so without it the time is the host's alone)."""
        # a profiler range only while a profiler records: with none
        # running, entering one still costs three times the span itself
        with (torch.profiler.record_function(SPAN_PREFIX + name)
              if torch.autograd._profiler_enabled()
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync is not None and sync.is_cuda:
                    torch.cuda.synchronize(sync.device)
                self.stages[name] = self.stages.get(name, 0.0) + (
                    time.perf_counter() - t0
                )

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        self.counters.add(name)
        self.stages[name] = self.stages.get(name, 0) + n

    @contextlib.contextmanager
    def device_stage(self, name: str):
        """Time the device work that the block queues on the current
        stream between two CUDA events, without waiting for it;
        ``resolve`` adds the time to the stage once the work has run."""
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        try:
            yield
        finally:
            b.record()
            self._events.append((name, a, b))

    def resolve(self) -> None:
        """Wait for the device stages' events and add their seconds."""
        for name, a, b in self._events:
            b.synchronize()
            self.stages[name] = (self.stages.get(name, 0.0)
                                 + a.elapsed_time(b) / 1e3)
        self._events.clear()

    def report(self) -> str:
        """The spans, longest first, each with its share of ``total`` (of
        their sum without it), then the counters."""
        spans = {k: v for k, v in self.stages.items()
                 if k not in self.counters}
        total = spans.get("total") or sum(spans.values())
        lines = []
        for name, dt in sorted(spans.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * dt / total if total else 0.0
            lines.append(f"{name:>16s}  {dt * 1e3:9.2f} ms  {pct:5.1f}%")
        for name in sorted(self.counters):
            lines.append(f"{name:>16s}  {self.stages[name]:,}")
        return "\n".join(lines)


def device_time(fn, args=(), reps: int = 10, warm: int = 2,
                queued: bool = True) -> float:
    """Seconds a call of ``fn(*args)`` takes on the current CUDA device:
    the mean over ``reps`` runs between two CUDA events, after ``warm``
    runs. With ``queued`` the runs are enqueued behind a spin of device
    work, so the events time the device alone and not the host's rate of
    launching (what a kernel costs inside a longer chain of launches);
    without it a stage that launches faster than the host can issue shows
    that cost."""
    for _ in range(warm):
        fn(*args)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES_PER_RUN * reps)
    a.record()
    for _ in range(reps):
        fn(*args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps / 1e3


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a GPU is present) and write it as a Chrome trace to
    ``log_dir/trace.json``, whose path the context yields. A profiler that
    fails to start or to export raises: no trace is better than an empty
    one taken for a measurement."""
    from torch.profiler import ProfilerActivity, profile

    path = Path(log_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, acc_events=True) as prof:
        yield path
    prof.export_chrome_trace(str(path))
