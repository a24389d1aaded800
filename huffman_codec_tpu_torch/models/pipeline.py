"""The host side of the sharded stream path: the counterpart of the JAX
package's step pipeline (``huffman_codec_tpu/models/chunked.py``:
``encode`` dispatching every step before it fetches any, the two-wave
``_fetch_dense_payloads``, ``_start_fetch``, ``stage_decode_steps`` and
the one-program decode step ``_decode_step_fused``).

``Transfers`` moves the bytes. An upload is packed into one pinned host
buffer and copied with ``non_blocking=True`` on a copy stream of its own;
an event marks the copy, and the compute stream waits on that event, so
the upload of step k + 1 runs while step k computes and the host never
waits. A fetch copies into pinned host buffers with ``non_blocking=True``
on the compute stream, and a wave of fetches ends in one event wait. On
the CPU the same calls hand the arrays over as tensors: no pinned memory,
no streams, no events.

``StepGraph`` runs one device step as one CUDA graph replay, where JAX
runs a jitted program. Its first call runs the step eagerly (the warm-up:
the kernels are built with nvcc there, and its launches are real) and
then captures it, so the step's graph exists once its geometry has been
met; from then on a call refills the static inputs and replays. A graph
keeps a memory pool of its own for as long as it lives, so a caller keeps
graphs only of a bounded set of geometries (``TorchCodec``: the encode
step counts of ``step_graph_bound``). A replay does not pass through the
kernel wrappers, so the graph adds the launches its capture recorded to
the wrappers' counts each time, and the capture, which launches nothing,
takes them back. A capture that fails raises: nothing falls back to eager
launches.

The entropy coder picks a request's schedule: ``InOrder`` runs its steps
one after another on the current stream; ``SideBySide`` runs them side by
side on the codec's side streams (``Transfers.side_streams``), where a
step is bound by one serial chain a chunk and leaves most of the card
empty (FGK): each step waits on its own inputs, not on the step before
it, and the current stream joins every side stream before the request
reads a result. How many run at once follows from the card
(``side_by_side_width``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from huffman_codec_tpu_torch.ops import kernels

# bytes every part of an upload is aligned to (the kernels' 16-byte loads)
ALIGN = 16

# streams drawn at most when the side streams grow: torch hands its
# streams out round-robin from a pool of 32 a priority, so a draw past
# that only repeats a stream already held
SIDE_STREAM_DRAWS = 32


def aligned(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


class Transfers:
    """Host <-> device copies of one codec, and the codec's timer:
    ``timer`` (a ``utils.profiling.StageTimer``, None by default)
    receives the spans the codec opens through ``host_stage`` and
    ``device_stage``, an upload's ``host staging`` among them; with no
    timer they enter nothing. No span times the copies themselves: a
    profiler's trace names each."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._copy_stream = None  # made at the first upload
        self._side: list[torch.cuda.Stream] = []  # made at first need
        self._side_drawn = False  # the pool gave every stream it has
        self.timer = None

    @property
    def copy_stream(self) -> torch.cuda.Stream:
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    def side_streams(self, n: int) -> list:
        """Up to ``n`` side streams of this codec, distinct from each
        other, from the copy stream and from the current stream; drawn
        from torch's pool at first need and kept. A draw that repeats a
        stream already held (or the copy or the current stream) is
        passed over, so fewer than ``n`` come back once the pool is
        drawn out."""
        if len(self._side) < n and not self._side_drawn:
            held = {self.copy_stream.cuda_stream,
                    torch.cuda.current_stream(self.device).cuda_stream}
            held.update(s.cuda_stream for s in self._side)
            for _ in range(SIDE_STREAM_DRAWS):
                s = torch.cuda.Stream(self.device)
                if s.cuda_stream not in held:
                    held.add(s.cuda_stream)
                    self._side.append(s)
                    if len(self._side) == n:
                        break
            else:
                self._side_drawn = True
        return self._side[:n]

    def host_stage(self, name: str | None):  # None: no span
        return (self.timer.stage(name)
                if self.timer is not None and name is not None
                else contextlib.nullcontext())

    def device_stage(self, name: str):
        return (self.timer.device_stage(name)
                if self.timer is not None and self.cuda
                else contextlib.nullcontext())

    def upload(self, parts):
        """One host -> device copy of several arrays. ``parts`` holds
        (array, count, dtype): the array's values fill the first elements
        of a 1-d tensor of ``count`` elements of ``dtype`` (whose item
        size is the array's), zeros the rest. Returns (the device buffer,
        the tensors, the event that marks the copy, None on the CPU),
        without synchronising; ``wait`` orders the current stream after
        the copy. Parts start at multiples of ALIGN bytes of the buffer."""
        offs, total = [], 0
        for _, count, dtype in parts:
            offs.append(total)
            total += aligned(count * dtype.itemsize)
        with self.host_stage("host staging"):
            host = torch.empty(max(total, ALIGN), dtype=torch.uint8,
                               pin_memory=self.cuda)
            hn = host.numpy()
            for (a, count, dtype), off in zip(parts, offs):
                a = np.asarray(a).reshape(-1)
                if a.dtype.itemsize != dtype.itemsize:
                    raise ValueError(f"upload: {a.dtype} into {dtype}")
                dst = hn[off: off + count * dtype.itemsize].view(
                    a.dtype.newbyteorder("="))
                dst[: a.size] = a
                dst[a.size:] = 0
        event = None
        if self.cuda:
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.copy_stream):
                base = torch.empty_like(host, device=self.device)
                base.copy_(host, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self.copy_stream)
            # freed only once the compute stream is past its last use
            base.record_stream(compute)
        else:
            base = host
        views = [base[off: off + count * dtype.itemsize].view(dtype)
                 for (_, count, dtype), off in zip(parts, offs)]
        return base, views, event

    def wait(self, event) -> None:
        """Order the current stream after ``event`` (no host wait)."""
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)

    def fetch(self, tensors) -> list[torch.Tensor]:
        """Start the device -> host copies of ``tensors`` into pinned
        buffers on the current stream; the host tensors hold the values
        once ``fence`` (or ``wait_host`` on a later ``record``) returns.
        On the CPU: the tensors themselves."""
        if not self.cuda:
            return list(tensors)
        out = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            out.append(h)
        return out

    def record(self):
        """An event at the current stream's end (None on the CPU)."""
        if not self.cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return event

    @staticmethod
    def wait_host(event) -> None:
        if event is not None:
            event.synchronize()

    def fence(self) -> None:
        """The host waits for everything queued on the current stream:
        the one wait that ends a wave of fetches."""
        self.wait_host(self.record())


class StepGraph:
    """``fn(*statics)`` -> a tuple of tensors, run as one CUDA graph.

    ``statics`` are the graph's input tensors; a call copies each input
    (of its static's shape) into it. The first call returns the eager
    run's outputs, every later call the graph's own outputs, overwritten
    by the next call: copy what is kept. Shapes and the host ints ``fn``
    bakes into its launches are fixed by the statics, so a caller keys its
    graphs by the geometry that fixes them. The first call synchronises
    the device (the capture does)."""

    def __init__(self, fn, statics: list[torch.Tensor]):
        self.fn = fn
        self.statics = statics
        self.graph = None
        self.outs = None
        self.launches: dict[str, int] = {}

    def __call__(self, *inputs):
        for s, x in zip(self.statics, inputs):
            s.copy_(x)
        if self.graph is None:
            outs = self.fn(*self.statics)  # counted: its launches are real
            self._capture()
            return outs
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.outs

    def _capture(self) -> None:
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                outs = self.fn(*self.statics)
        finally:
            after = kernels.launch_counts()
            self.launches = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
            kernels.add_launches(self.launches, -1)
        self.graph, self.outs = graph, outs


def side_by_side_width(resident_blocks: int, S: int) -> int:
    """Steps of S chunks (a block each) that run side by side: as many as
    the card holds the blocks of at once, ``resident_blocks``, and at
    least one."""
    return max(1, resident_blocks // S)


class InOrder:
    """``SideBySide``'s methods for steps one after another on the current
    stream: ``step`` orders the stream after ``ready`` (the host waits on
    nothing) and runs its block in a device span ``device`` of its own."""

    def __init__(self, xf: Transfers):
        self.xf = xf

    @contextlib.contextmanager
    def step(self, k: int, ready=None, held=()):
        self.xf.wait(ready)
        with self.xf.device_stage("device"):
            yield

    @staticmethod
    def hand_back(tensors):
        return tensors

    def join(self) -> None:
        pass


class SideBySide:
    """The steps of one request, each on a side stream of the codec: step k
    on ``streams[k % width]``, so a step past the width waits behind the
    earlier step on its stream, and no step waits on any other.

    ``step(k, ready, held)`` runs its block on step k's stream. The
    stream first waits on the fork, an event at the current stream at the
    request's first step (once a stream), then on ``ready``; each tensor
    of ``held``, made on another stream, is marked in use on it, so that
    the caching allocator hands out none of their memory while the step
    may still read or write it. ``hand_back`` marks a step's outputs in
    use on the current stream, which reads them after the ``join``: the
    current stream waits on every side stream used. The host waits on
    nothing. On the CPU (no streams) each step runs in place.

    One device span ``device`` runs on the current stream from just
    before the fork to the join. The timer counts ``<name>``, the steps
    run, and, on the card, ``<name> side by side``, the steps queued on a
    stream that held no earlier step of the request (the first step
    counts)."""

    def __init__(self, xf: Transfers, n_steps: int, width: int, name: str):
        self.xf, self.name = xf, name
        self.n_streams = min(n_steps, width)
        self.span = contextlib.ExitStack()
        self.streams = None  # drawn at the first step, after its upload
        self.used: set[int] = set()

    @contextlib.contextmanager
    def step(self, k: int, ready=None, held=()):
        xf = self.xf
        if self.streams is None:
            self.span.enter_context(xf.device_stage("device"))
            self.streams = xf.side_streams(self.n_streams) if xf.cuda else []
            self.current = (torch.cuda.current_stream(xf.device) if xf.cuda
                            else None)
            self.fork = xf.record()
        timer = xf.timer
        if timer is not None:
            timer.count(self.name)
        if not self.streams:
            yield
            return
        j = k % len(self.streams)
        s = self.streams[j]
        if j not in self.used:
            self.used.add(j)
            s.wait_event(self.fork)
            if timer is not None:
                timer.count(self.name + " side by side")
        if ready is not None:
            s.wait_event(ready)
        for t in held:
            t.record_stream(s)
        with torch.cuda.stream(s):
            yield

    def hand_back(self, tensors):
        """``tensors`` (None entries pass), marked in use on the current
        stream; returned as given."""
        if self.current is not None:
            for t in tensors:
                if t is not None:
                    t.record_stream(self.current)
        return tensors

    def join(self) -> None:
        """The current stream waits on every side stream used; the span
        ends."""
        for j in sorted(self.used):
            self.current.wait_stream(self.streams[j])
        self.span.close()
