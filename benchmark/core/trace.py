"""The reading of a ``torch.profiler`` Chrome trace: the device's busy
intervals (kernels, copies and sets), the request spans the harness put
into it (``record_function("bench.<kind>")``), and what the readers of
per-layer metrics ask of them. ``_union_us`` and the busy share's method
are copied from ``chip_smoke.busy_share``."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


def _union_us(intervals) -> float:
    """Microseconds covered by the union of (start, duration) intervals."""
    busy, end = 0.0, float("-inf")
    for s, d in sorted(intervals):
        if s + d > end:
            busy += s + d - max(s, end)
            end = s + d
    return busy


def _clip(intervals, lo: float, hi: float):
    for s, d in intervals:
        a, b = max(s, lo), min(s + d, hi)
        if b > a:
            yield a, b - a


@dataclass
class Trace:
    """The events of one traced slice of a run, times in microseconds."""

    device: list = field(default_factory=list)  # (ts, dur, cat, name)
    host: list = field(default_factory=list)  # cpu ops: (ts, dur, name)
    spans: list = field(default_factory=list)  # (kind, ts, dur)

    @classmethod
    def load(cls, path: Path) -> "Trace":
        t = cls()
        for e in json.loads(Path(path).read_text())["traceEvents"]:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat"), e.get("name", "")
            if cat in DEVICE_CATS:
                t.device.append((e["ts"], e["dur"], cat, name))
            elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
                t.spans.append((name[len(SPAN_PREFIX):], e["ts"], e["dur"]))
            elif cat == "cpu_op":
                t.host.append((e["ts"], e["dur"], name))
        t.spans.sort(key=lambda s: s[1])
        t.device.sort()
        return t

    def _near(self, lo: float, hi: float) -> list:
        """Device events that may overlap [lo, hi)."""
        if not hasattr(self, "_starts"):
            self._starts = [e[0] for e in self.device]
            self._longest = max((e[1] for e in self.device), default=0)
        i = bisect.bisect_left(self._starts, lo - self._longest)
        j = bisect.bisect_left(self._starts, hi)
        return self.device[i:j]

    def window(self) -> tuple[float, float]:
        """The traced window: the first span's start to the last's end."""
        return (self.spans[0][1], max(ts + d for _, ts, d in self.spans))

    def kind_spans(self, kind: str) -> list:
        return [(ts, d) for k, ts, d in self.spans if k == kind]

    def device_events(self, kind: str, match=None) -> list:
        """Device events that start inside the spans of ``kind`` (and whose
        name ``match`` accepts, when given): (ts, dur, cat, name)."""
        out = []
        for ts, d in self.kind_spans(kind):
            out += [ev for ev in self._near(ts, ts + d)
                    if ts <= ev[0] < ts + d
                    and (match is None or match(ev[2], ev[3]))]
        return out

    def busy_us(self, lo: float, hi: float) -> float:
        """Device time in [lo, hi): the union of kernels, copies, sets."""
        return _union_us(list(_clip(((e[0], e[1])
                                     for e in self._near(lo, hi)), lo, hi)))

    def idle_share(self, kind: str):
        """One less the device's busy time over the spans of ``kind``,
        each span's busy time clipped to it; None without such spans."""
        spans = self.kind_spans(kind)
        total = sum(d for _, d in spans)
        if not spans or total <= 0:
            return None
        busy = sum(self.busy_us(ts, ts + d) for ts, d in spans)
        return 1.0 - busy / total

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the host operation that covered each gap's middle
        (the innermost one; the request kind where no operation did), in
        seconds."""
        by_name: dict = defaultdict(float)
        for ts, dur, cat, name in self.device:
            by_name[name[:120]] += dur / 1e6
        lo, hi = self.window()
        ivs = sorted((ts, ts + d) for ts, d, _, _ in self.device
                     if ts + d > lo and ts < hi)
        gaps, end = [], lo
        for a, b in ivs:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by_host: dict = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            # the innermost covering op starts last among those covering
            name = None
            for h in reversed(host[max(0, bisect.bisect_right(starts, mid)
                                       - 4096):bisect.bisect_right(starts,
                                                                   mid)]):
                if mid < h[0] + h[1]:
                    name = h[2]
                    break
            if name is None:
                kinds = [k for k, ts, d in self.spans if ts <= mid < ts + d]
                name = f"python ({kinds[0]})" if kinds else "between requests"
            by_host[name[:120]] += (b - a) / 1e6
        return {"device_ops": sorted(([k, v] for k, v in by_name.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in by_host.items()),
                                    key=lambda kv: -kv[1])[:top]}
