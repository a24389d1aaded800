"""One run of a multi-card cell: ``parallel.mesh``'s stream steps over a
``torch.distributed`` group of one process a card (NCCL; gloo on the CPU
in the tests). This process is rank 0 and the one caller; the other ranks
are processes it spawns, and each follows rank 0's requests.

An object is cut into steps of the configuration's ``step_chunks``
chunks (the last one fewer, padded with zero chunks to a multiple of the
world size); every step starts a stream of its own (carry 0), as
``distributed_encode_step`` defines it. An encode runs
``distributed_encode_step`` over the object's steps and ends when every
step's gathered columns are on rank 0's host; a decode runs
``distributed_decode_step`` from host-held columns (the set-up's encode
of the same object) and ends when the decoded bytes are on rank 0's host.
"""

from __future__ import annotations

import importlib
import os
import queue
import socket
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from benchmark.codecs.torch_codec import fields as codec_config
from benchmark.core import judge, traffic
from benchmark.core.cells import Cell
from benchmark.core.loop import TRACE_SLICE_S, Reservoir, RunData, Span
from benchmark.core.trace import SPAN_PREFIX, Trace

STOP = -1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _steps(obj: np.ndarray, cs: int, S: int, world: int, control):
    """(host tensor of the step's padded bytes, the step's valid length)
    for each step of ``obj``."""
    if control == "lsb":
        obj = obj & np.uint8(0xFE)
    n = len(obj)
    out = []
    for lo in range(0, n, S * cs):
        m = min(n - lo, S * cs)
        c = -(-(-(-m // cs)) // world) * world
        buf = np.zeros(c * cs, np.uint8)
        buf[:m] = obj[lo: lo + m]
        out.append((torch.from_numpy(buf), m))
    return out


def _apply(hooks) -> None:
    """Run ``module:function`` hooks (the tests' planted faults)."""
    for h in hooks or ():
        mod, fn = h.split(":")
        getattr(importlib.import_module(mod), fn)()


def _rank(rank: int, world: int, port: int, cell: Cell, seed: int,
          seconds: float, trace: bool, device: str, control, hooks,
          t_start: float, q):
    """The body of every rank; rank 0 returns its run's data."""
    os.environ["LOCAL_RANK"] = str(rank)
    import torch.distributed as dist

    from huffman_codec_tpu_torch.parallel import distributed as D
    from huffman_codec_tpu_torch.parallel import mesh as M

    _apply(hooks)
    cpu = device == "cpu"
    D.init_distributed(f"localhost:{port}", world, rank,
                       backend="gloo" if cpu else "nccl",
                       device="cpu" if cpu else None)
    try:
        mesh = M.default_mesh(world, device="cpu" if cpu else None)
        out = _serve(rank, world, mesh, M, dist, cell, seed, seconds,
                     trace, control, t_start, q)
        # the group goes with nothing in flight: every rank waits for its
        # card and meets the others before any destroys its communicator
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()
        return out
    finally:
        dist.destroy_process_group()


def _serve(rank, world, mesh, M, dist, cell, seed, seconds, trace, control,
           t_start, q):
    cfg = codec_config(cell.config)
    cs, lane, S = cfg["chunk_size"], cfg["lane"], cfg["step_chunks"]
    use_diff = cfg["use_diff"]
    dev = mesh.device
    pool = traffic.build(cell.mix, seed, cs, dev)
    steps = [_steps(o, cs, S, world, control) for o in pool.objects]

    def encode(k, fetch=rank == 0):
        # in the window rank 0 fetches each step's gathered columns and
        # the others only keep pace (their copies are the same)
        cols = []
        for data, m in steps[k]:
            out = M.distributed_encode_step(data, m, mesh, cs, 0, use_diff,
                                            "canonical", lane)
            if fetch:
                cols.append([t.cpu() for t in out])
        if not fetch and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return cols

    def decode(k, cols):
        parts = []
        for (data, m), c in zip(steps[k], cols):
            buf, lw, tab, rl, car = c
            out = M.distributed_decode_step(
                buf.view(buf.shape[0], -1), rl, car, mesh, cs, tab, lw,
                use_diff, "canonical", lane)
            if rank == 0:
                parts.append(out[:m].cpu().numpy())
        if rank and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return np.concatenate(parts).tobytes() if rank == 0 else None

    # set-up: every object encoded once on every rank (each keeps the
    # columns on its host for the decodes) and decoded once
    held = [encode(k, fetch=True) for k in range(len(steps))]
    for k, cols in enumerate(held):
        decode(k, cols)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    # the payload's bits per input byte (the mesh writes no container)
    bpc = 8.0 * sum(int(c[1].sum()) * 4 for cols in held for c in cols) / (
        sum(len(o) for o in pool.objects))
    cmd = torch.zeros(2, dtype=torch.int64, device=dev)
    rng = np.random.default_rng([seed, 7])
    sample_k = cell.mix.get("sample", {})
    res = {k: Reservoir(int(sample_k.get(k, 2)), rng)
           for k in set(pool.kinds)}
    spans, failed = [], 0
    prof = None
    tmp = Path(os.environ.get("TMPDIR", tempfile.gettempdir()))
    trace_path = tmp / f"benchmark_trace_{cell.name}_rank{rank}.json"
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    t_win = time.perf_counter()
    i, done = 0, False
    while True:
        # rank 0 tells every rank the next request, or the end
        if rank == 0:
            cmd[0] = STOP if done else i
        dist.broadcast(cmd, src=0)
        if int(cmd[0]) == STOP:
            break
        kind, k = pool.request(int(cmd[0]))
        ann = (torch.profiler.record_function(SPAN_PREFIX + kind)
               if prof is not None else None)
        if ann is not None:
            ann.__enter__()
        t0 = time.perf_counter()
        try:
            out = encode(k) if kind == "encode" else decode(k, held[k])
        except Exception as e:  # noqa: BLE001 - a failed request is counted
            failed += 1
            out = e
        t1 = time.perf_counter()
        if ann is not None:
            ann.__exit__(None, None, None)
        nbytes = len(pool.objects[k])
        spans.append(Span(kind, nbytes, t0, t1))
        if rank == 0:
            res[kind].offer((i, k, out))
        i += 1
        if (prof is not None and t1 - t_win >= min(TRACE_SLICE_S, seconds)
                and i >= len(pool.kinds)):  # every kind traced once
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(str(trace_path))
            prof = None
        done = t1 - t_win >= seconds
    if prof is not None:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(trace_path))
    window_s = time.perf_counter() - t_win
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)
    tr = None
    busy = (0.0, 0.0)
    if trace:
        tr = Trace.load(trace_path)
        trace_path.unlink()
        if tr.spans:
            lo, hi = tr.window()
            busy = (tr.busy_us(lo, hi) / 1e6, (hi - lo) / 1e6)
    if rank:
        q.put((rank, peak, busy, failed))
        return None
    return dict(spans=spans, failed=failed, setup_s=setup_s, bpc=bpc,
                window_s=window_s, peak=peak, busy=busy, trace=tr,
                res={k: r.items for k, r in res.items()},
                objects=pool.objects, cfg=cfg, world=world)


def _worker(*args):
    try:
        _rank(*args)
    except Exception:
        args[-1].put((args[0], None, traceback.format_exc(), None))
        raise


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", control=None, t_start=None, hooks=None):
    """One run of a multi-card cell. Returns (RunData, checks, info,
    answers judged)."""
    import torch.multiprocessing as mp

    t_start = time.perf_counter() if t_start is None else t_start
    world = int(cell.config["ranks"])
    port = free_port()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(
        r, world, port, cell, seed, seconds, trace, device, control, hooks,
        t_start, q)) for r in range(1, world)]
    for p in procs:
        p.start()

    finished = threading.Event()

    def watch():
        # a rank that dies leaves the others waiting in a collective (or in
        # the group's rendezvous) forever: end the run instead, until every
        # rank has answered
        while not finished.wait(1.0):
            for p in procs:
                if p.exitcode not in (None, 0) and not finished.is_set():
                    print(f"rank process {p.name} exited with {p.exitcode}",
                          file=sys.stderr, flush=True)
                    for other in procs:
                        other.kill()
                    os._exit(4)

    threading.Thread(target=watch, daemon=True).start()
    try:
        out = _rank(0, world, port, cell, seed, seconds, trace, device,
                    control, hooks, t_start, q)
        ranks = []
        for _ in procs:
            try:
                ranks.append(q.get(timeout=120))
            except queue.Empty:
                break
    finally:
        finished.set()
        # a rank that has answered but hangs in its teardown is ended
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                print(f"rank process {p.name} ended after its answer",
                      file=sys.stderr, flush=True)
                p.kill()
                p.join()
    errors = [r for r in ranks if r[1] is None]
    if errors or len(ranks) != world - 1:
        raise RuntimeError(f"a rank failed: {errors or 'no answer'}")
    info = {"attempted": len(out["spans"]),
            "failed": out["failed"] + sum(r[3] for r in ranks),
            "setup_s": out["setup_s"], "bpc": out["bpc"],
            "bpc_of": "payload",
            "window_s": out["window_s"],
            "memory_peak_bytes": max([out["peak"]] + [r[1] for r in ranks])}
    run = RunData(cell, out["spans"], {}, {})
    if trace:
        # each rank traces its own window: their busy shares are averaged
        # and stated over rank 0's window
        busy = [out["busy"]] + [r[2] for r in ranks]
        shares = [b / w for b, w in busy if w > 0]
        info["trace_window_s"] = out["busy"][1]
        info["trace_busy_s"] = (sum(shares) / len(shares) * out["busy"][1]
                                if shares else 0.0)
        run.trace = out["trace"]
        n_traced = len(run.trace.spans) if run.trace else 0
        run.traced_bytes = {
            kind: sum(s.nbytes for s in out["spans"][:n_traced]
                      if s.kind == kind) for kind in ("encode", "decode")}
        run.extra["traced_spans"] = out["spans"][:n_traced]
    checks = judge_mesh(out, info["failed"], device)
    sampled = {k: len(v) for k, v in out["res"].items()}
    return run, checks, info, sampled


def judge_mesh(out: dict, failed: int, device) -> dict:
    """The mesh's checks: every sampled encode's columns, step by step,
    by ``container.judge_columns``; every sampled decode's bytes."""
    from benchmark import reference
    from benchmark.reference import container

    cfg = out["cfg"]
    cs, S = cfg["chunk_size"], cfg["step_chunks"]
    objs = out["objects"]
    checks = {"failed_requests": failed, "encode_bad_bytes": 0,
              "encode_bad_tables": 0}
    for _, k, cols in out["res"].get("encode", []):
        if isinstance(cols, Exception):
            continue
        for j, c in enumerate(cols):
            step = objs[k][j * S * cs: (j + 1) * S * cs]
            names = ("lane_buf", "lane_words", "tables", "rle_lens",
                     "carries")
            got = container.judge_columns(
                {n: t.numpy() for n, t in zip(names, c)}, step, cs,
                cfg["lane"], cfg["use_diff"], device)
            checks["encode_bad_bytes"] += got["bad_bytes"]
            checks["encode_bad_tables"] += got["bad_tables"]
    checks["decode_bad_bytes"] = sum(
        reference.judge_bytes(o, objs[k])
        for _, k, o in out["res"].get("decode", [])
        if not isinstance(o, Exception))
    return {k: (int(v), judge.LIMIT) for k, v in checks.items()}
