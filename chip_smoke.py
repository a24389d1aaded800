"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from huffman_codec_tpu_torch/csrc and the host C++
runtime of the v1 format, and drives five paths.

The sharded streaming path: holds the six kernels it runs against their
plain PyTorch versions on the card (one full step of 256 x 64 KiB chunks,
diff on and off, a batch of edge-case chunks, and the encode and decode
edge batches of ``huffman_codec_tpu_torch/edge_cases.py``), launches the
encode kernels 200 times on two small batches and fails on any result
that differs from the plain version's (the stress phase), round-trips a 64 MiB
generated input through ``TorchCodec.encode``/``decode`` with the diff
model on and off, checks a container against the plain path run on the
CPU, and times the device encode and decode and every kernel with CUDA
events.

Shapes that do not divide by 16 (``ODD_CONFIGS`` of
``huffman_codec_tpu_torch/edge_cases.py``: chunks of 1000 bytes, lanes of
100 and 8 symbols, in both layouts): every wrapper launches its kernel
there (no wrapper sends a CUDA tensor to a plain version). The phase holds
the six kernels of the sharded chain against their plain versions at those
shapes and ``rle_expand`` on a row past 2^23 bytes, round-trips each
config with the diff model on and off, checks every container against the
plain path run on the CPU and prints its counted launches.

The global layout (``CodecConfig()``, the default): holds the kernels it
runs against their plain versions at its geometries (the whole-file
candidate's fat lanes at 256 KiB, 1.25 MiB and 2.5 MiB of input, where
the fat-lane decode kernel runs; the chunked candidate's lane 2048; a
batch of edge cases, and at lane 32768 random bytes, a fixed 7-bit code,
windows with no code, codes of 20-31 bits and a chain past the lane's last
word), round-trips 256 KiB, 1.25 MiB, 2.5 MiB and 64 MiB with the diff
model on and off, runs the v1 race on a small input, checks containers
against the plain path run on the CPU, and times the fat-lane kernel (also
on 112 lanes of random bytes and of its worst case, a fixed 7-bit code
whose chains never resynchronise), the device encode and decode and the
peak device memory.

Adaptive block RLE (``use_adapt``), in both layouts: holds the RLE
kernel's tile mode against its plain version (a 256-band step of 128 x 512
bands at block sizes 8, 32 and 128, and a batch of edge cases), the
grouped manifest's walk kernel against its plain version, and every kernel
the adaptive paths launch against its plain version at the shapes they
launch it (all 1024 bands in one call; the tile rows of the decodes; the
rows of the search's histogram), round-trips a
64 MiB sharded-adaptive input (1024 bands) and one of 16 bands plus a
5-row tail, 256 KiB and 2.5 MiB global-adaptive inputs with the diff model
on and off and both candidates, reads a range across a band border, checks
containers against the plain path run on the CPU, and times the search,
the stages of the encode and the decode, and the peak device memory.

FGK entropy (``entropy="fgk"``) in every layout and the device
``V1Codec``: holds the two FGK kernels against their plain versions (the
main step's RLE streams, diff on, cut to 2048 symbols, with the FGK edge
batch of ``huffman_codec_tpu_torch/edge_cases.py``); in a stress pass over
32 seeds of the successor streams and the edge rows, round trips and the
host runtime's v1 encoder; at the main path's
shapes, where the plain loop (once a symbol) cannot run, against a second
oracle: the encoder, for codes past 32 bits and for every chunk of a full
step with diff and without, against the host runtime's v1 encoder (RLE
restarts every chunk, so a chunk's stream is the v1 stream of its diffed
bytes), and the decoder, on the first step's staged word rows of the 64
MiB round trips, against that step's RLE streams; round-trips a 64 MiB
sharded input with the diff model on and off, 256 KiB and 2.5 MiB global
inputs, a sharded-adaptive input of 16 bands and a 5-row tail, and
``V1Codec`` on 256 KiB in the four pipeline configs (bytes equal to the
host runtime's, decoded on the device and by the host runtime); checks
containers against the plain path run on the CPU on small inputs, and
times the kernels (beside their bound) and the device encode and decode.

The command line (``python -m huffman_codec_tpu_torch``) on the card,
with its device left at the default: ``cli.main`` compresses the 64 MiB
sharded input from a file (``-c -m --format=v3 --layout=sharded
--stats``) and decompresses it, the container held to ``TorchCodec``'s and
kernels 1-6 counted; v1's default backend (``torch``, the device
``V1Codec``) on 256 KiB in the four pipeline configs against
``--backend native``, and on the three broken adaptive v1 blobs (exit codes 13, 14 and 15, the host runtime's stderr lines); the
module entry in a process of its own on a 16 MiB prefix, against the
in-process bytes; ``--dump-tables`` against the CPU plain path. Then a
64 MiB sharded encode and decode run under
``utils.profiling.device_trace``, and read from the trace: the share of
the traced window that the CUDA kernels cover (the union of their
intervals), the share that kernels or copies cover, the idle share (one
less the latter), and the five kernels that took the most device time.

The multi-GPU layer (``huffman_codec_tpu_torch/parallel/``): world 1 on
NCCL in this process drives the five step functions of
``parallel/mesh.py`` on the 64 MiB input (canonical with the diff model on
and off, FGK, and the sharded-adaptive cell's search, encode and decode,
1024 chunks or bands), launches counted; the encode outputs are held to
the plain versions of kernels 1, 1b, 2 and 3 on the same rows, and the
FGK step's to the host runtime's v1 encoder a chunk at a time; the
containers assembled from the gathered outputs equal
``TorchCodec.encode``'s (diff on), every decode returns the input, and
each step is timed beside the single-process
stage on the same chunks and the gathers alone. Then two ranks, each a
process of its own: on one card both on it over gloo at 16 MiB (NCCL
takes one rank a device), on two or more cards NCCL with a rank a card
(up to 4) at 64 MiB; every rank's gathered outputs must equal world 1's,
whose encode outputs are held to the plain versions the same way.

The step pipeline of the main path (64 MiB sharded, diff on and off):
``encode`` uploads every step from pinned memory on a copy stream and
dispatches it (a CUDA graph replay; the first step of a geometry runs
eagerly and captures the graph) before it fetches any, then fetches in
two waves, the manifests and the used payload prefixes; ``decode`` stages
every step before it runs any, runs each launch by launch into its slice
of one result and fetches the bytes once. The phase holds its containers
to the eager single-step path (each step fetched before the next is
uploaded) and, on the 16 MiB + 12,345 B prefix, to the CPU plain path;
every output of a replayed encode step to the same step run launch by
launch, and each decode step written in place to the step run alone;
runs the dispatch halves of both under
``torch.cuda.set_sync_debug_mode("error")``; checks that the launch counts
(a replay adds what its capture recorded) equal an eager round trip's;
prints the stage split of the end-to-end encode and decode (host staging,
device, payload bytes, crc32, container; parse, bytes; the device stage
from CUDA events; the parse's copied bytes), the device encode with graphs
beside the eager launches and the device decode (queued and host-paced),
and the traced idle share of a round trip.

A long-lived codec (the main path's config, diff off and on, one codec
each for the whole phase) round-trips two passes of 16 seeded inputs of
64 KiB to 24 MiB (a chunk count in every power-of-two class below a step
and some above, partial last chunks, gradients of four noise amplitudes
with a block of random bytes), each input twice; it prints the device
memory and the graph count after each input and the walls by size class,
and fails if a codec keeps more CUDA graphs than
``models.chunked.step_graph_bound`` allows, if the device memory the
process holds grows by more than 64 MiB over the second pass, if a round
trip is not exact, or if three of the containers differ from the CPU
plain path's.

Kernels 1 and 6 against the host C++ runtime (``native/hctpu.cpp``, an
oracle written apart from the plain versions), on the 64 MiB main input's
1024 chunks, diff off and on: kernel 1's stream of each chunk against the
runtime's ``rle_encode`` of the chunk diffed with numpy from the byte
before it (the carry the main path's stage uses, checked step by step),
kernel 6's output of each row against the runtime's ``rle_decode`` of the
row's stream, diff-reverted with numpy; ``build_lengths_pm`` against
``build_lengths_exact`` in cost on every chunk; the runtime's v2
container of the 16 MiB + 12,345 B prefix against ``formats``' v2
functions; the one-chunk FGK forms (a launch each, counted) against the
runtime's v1 body of the first chunk. The runtime's RLE times are printed
beside the two kernels'.

Each path's kernel launches are counted from zero over its round trips.
The encode kernels (1, 1b and 3), ``repad_words`` (beside its library
call, one ``masked_scatter_``) and the fat-lane decode kernel are also
timed at every geometry they serve, each time beside its bound
(``by_geometry`` in their rows). Device times come from
``utils.profiling.device_time`` (``cuda_ms`` here): CUDA events around
runs queued behind a device spin.
It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. It exits non-zero, printing no
result, when there is no GPU or any phase fails.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import io
import json
import os
import queue
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
import zlib
from pathlib import Path

import numpy as np
import torch

from huffman_codec_tpu_torch.utils.profiling import device_time, device_trace

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# The kernels' operations are 32-bit integer work: Hopper issues 64 INT32
# operations a clock on each of its 132 SMs.
INT32_OPS_PER_CLOCK = 132 * 64
STEP = 256  # chunks per step on the main path
CS = 1 << 16
LANE = 512
SEED = 1234
STRESS_REPS = 200
# queued device time and bound of a kernel at each geometry it serves
# (kernels 1, 1b, 3, 4 and 7), filled by the phases that time them
GEOMETRY_MS: dict = {}


def log(*a):
    print(*a, flush=True)


def gradient_input(n: int, seed: int, noise: int = 2) -> np.ndarray:
    """Smooth 512-wide 8-bit gradients with noise of +-``noise``, like the
    repo's 512 x 512 grayscale corpus, made in bulk from a seed."""
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    row, col = (i // 512) % 512, i % 512
    img = (i // (512 * 512)) * 37
    base = (row * 3 + col * 2) // 5 + img
    return ((base + rng.integers(-noise, noise + 1, n)) & 255).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def int32_ops_per_s() -> float:
    """The card's INT32 rate at the maximum SM clock nvidia-smi reports."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]
    return INT32_OPS_PER_CLOCK * float(mhz) * 1e6


def bound_of(nbytes: int, ops: int):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes over the memory rate and the operations over the INT32
    rate."""
    by, op = nbytes / HBM_BYTES_PER_S * 1e3, ops / int32_ops_per_s() * 1e3
    return (by, "bytes") if by >= op else (op, "operations")


def rle_encode_ops(n_in: int, n_out: int, diff: bool, tile: bool) -> int:
    """Integer operations kernel 1's function needs, counted as a serial
    encoder does them: an input byte costs the diff's subtract (diff on),
    the compare with the byte before, the run counter's update and its
    compares with 3 and 258, and in tile mode the position's compares with
    the tile's first and last byte; an output byte costs the select of
    literal or count byte and the advance of the output address."""
    return (4 + int(diff) + 2 * int(tile)) * n_in + 2 * n_out


def cuda_ms(fn, reps: int = 10, warm: int = 2,
            queued: bool = False) -> float:
    """Milliseconds of ``fn()`` between two CUDA events, the mean of
    ``reps`` runs (``utils.profiling.device_time``). With ``queued`` the
    runs are enqueued behind a spin of device work, so the events time the
    device alone and not the host's rate of launching; without it a stage
    that launches faster than the host can issue shows that cost."""
    return device_time(fn, reps=reps, warm=warm, queued=queued) * 1e3


def histogram_library(data, lengths):
    """The byte histogram as one PyTorch ``scatter_add_`` (its yardstick;
    the port never calls it)."""
    pos = torch.arange(data.shape[1], device=data.device)[None, :]
    idx = torch.where(pos < lengths[:, None], data.to(torch.int64), 256)
    out = torch.zeros((data.shape[0], 257), dtype=torch.int32,
                      device=data.device)
    return out.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``reps`` single runs after one warm-up run
    (for calls that synchronise the host inside, where a batch mean would
    mix in the spread of the host loop)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def same(name: str, got: torch.Tensor, want: torch.Tensor, errs: dict):
    if got.is_cuda:
        torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    errs[name] = max(errs.get(name, 0), err)
    if err:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err})")


def kernel_chain(K, chunks, in_lens, carries, use_diff, errs, shapes,
                 lane=LANE):
    """Run the six kernels as the main path chains them, each held against
    its plain version on the same inputs (tolerance 0: integer codec)."""
    from huffman_codec_tpu_torch.models.entropy import (
        CANONICAL, _strip_payload)
    from huffman_codec_tpu_torch.ops.canonical import assign_codes, build_lengths_pm

    def sync():  # surface a fault of the launch just made, where it happened
        if chunks.is_cuda:
            torch.cuda.synchronize()

    C, n = chunks.shape
    cap = CANONICAL.cap(n, lane)
    st, rl = K.rle_diff_encode(chunks, in_lens, carries, use_diff, cap)
    sync()
    pst, prl = K.rle_diff_encode_plain(chunks, in_lens, carries, use_diff, cap)
    same("rle_diff_encode", st, pst, errs)
    same("rle_diff_encode.lens", rl, prl, errs)
    counts = K.histogram256(st, rl)
    sync()
    same("histogram256", counts, K.histogram256_plain(st, rl), errs)
    lens = build_lengths_pm(counts)
    tables = (assign_codes(lens) | (lens << 26)).to(torch.int32)
    buf, bits = K.lane_pack(st, rl, tables, lane)
    sync()
    pbuf, pbits = K.lane_pack_plain(st, rl, tables, lane)
    same("lane_pack", buf, pbuf, errs)
    same("lane_pack.bits", bits, pbits, errs)
    lw = ((bits + 31) >> 5).to(torch.int32)
    flat = _strip_payload(buf, lw).contiguous()
    wb = max(8, -(-int(lw.max()) // 16) * 16)
    wb = min(wb, K.lane_words_cap(lane))
    padded = K.repad_words(flat, lw, wb)
    sync()
    same("repad_words", padded, K.repad_words_plain(flat, lw, wb), errs)
    ml = int(lens.max())
    max_len = next(b for b in (8, 12, 16, 24, 31) if b >= ml)
    lt = lens.to(torch.uint8)
    nl = cap // lane
    pb = padded.view(C, nl, wb)
    dec = K.lane_decode(pb, lt, rl, lane, max_len)
    sync()
    same("lane_decode", dec, K.lane_decode_plain(pb, lt, rl, lane, max_len),
         errs)
    same("lane_decode.vs_streams", dec, st, errs)
    out = K.rle_expand(dec, rl, carries, n, use_diff)
    sync()
    same("rle_expand", out, K.rle_expand_plain(dec, rl, carries, n,
                                                use_diff), errs)
    valid = torch.arange(n, device=chunks.device)[None, :] < in_lens[:, None]
    same("round_trip", torch.where(valid, out, 0), torch.where(valid, chunks, 0),
         errs)
    shapes.update(chunks=chunks, in_lens=in_lens, carries=carries, st=st,
                  rl=rl, tables=tables, lw=lw, flat=flat, wb=wb, pb=pb, lt=lt,
                  max_len=max_len, dec=dec, use_diff=use_diff, cap=cap,
                  counts=counts, lens=lens)


def edge_batch(dev):
    """Chunks of the main-path width with edge-case contents."""
    rng = np.random.default_rng(SEED + 1)
    rows, lens = [], []
    rows.append(rng.integers(0, 256, CS, dtype=np.uint8)); lens.append(CS)
    rows.append(gradient_input(CS, SEED + 2)); lens.append(CS)
    runs = np.concatenate([np.full(259, 7), np.full(516, 9), np.full(517, 1),
                           np.full(1000, 3), np.arange(300) % 5,
                           np.full(CS - 2592, 200)]).astype(np.uint8)
    rows.append(runs); lens.append(CS)
    rows.append(np.full(CS, 65, np.uint8)); lens.append(CS)  # one symbol
    rows.append(rng.integers(0, 2, CS, dtype=np.uint8)); lens.append(CS)
    rows.append(gradient_input(CS, SEED + 3)); lens.append(1000)  # tail
    rows.append(np.zeros(CS, np.uint8)); lens.append(0)  # empty
    rows.append(np.full(CS, 5, np.uint8)); lens.append(1)
    chunks = torch.from_numpy(np.stack(rows)).to(dev)
    in_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    carries = torch.tensor([0, 1, 255, 65, 3, 9, 0, 77], dtype=torch.uint8,
                           device=dev)
    return chunks, in_lens, carries


def geometry(kernel: str, where: str, ms: float, nbytes: int, ops: int,
             **extra) -> None:
    """Record and print one kernel's time at one geometry beside its
    bound."""
    bound, by = bound_of(nbytes, ops)
    GEOMETRY_MS.setdefault(kernel, {})[where] = dict(
        ms=ms, bound_ms=bound, bound_by=by, **extra)
    log(f"{kernel} at {where}: {ms:.4f} ms, bound {bound:.5f} ms by {by} "
        f"({nbytes} B), {ms / bound:.1f}x"
        + "".join(f", {k} {v:.5f}" if isinstance(v, float) else f", {k} {v}"
                  for k, v in extra.items()))


def encode_edges(K, dev, errs):
    """Kernels 1, 1b and 3 against their plain versions on the encode edge
    batches of ``huffman_codec_tpu_torch/edge_cases.py``: rows of the
    sharded step's width with lengths at and around the kernel's 16-byte
    and 4096-byte borders, runs of 257-5000 bytes across those borders,
    runs ending at the last two positions, carries 0, 255 and the first
    byte (diff off and on, and the tile mode at T = 64, 1024 and 16384);
    lanes of 512, 2048 and 32768 symbols with codes of depth 26 and 31,
    empty, one-symbol and partial lanes."""
    from huffman_codec_tpu_torch.edge_cases import (
        pack_edge_rows, rle_encode_edge_rows)
    from huffman_codec_tpu_torch.models.entropy import CANONICAL

    cap = CANONICAL.cap(CS, LANE)
    ch, ln, car = (torch.from_numpy(a).to(dev)
                   for a in rle_encode_edge_rows(CS, SEED + 31))
    zero = torch.zeros_like(car)
    for d, tile in ((False, 0), (True, 0), (False, 64), (False, 1024),
                    (False, 16384)):
        c = zero if tile else car
        s, ln_s = K.rle_diff_encode(ch, ln, c, d, cap, tile=tile)
        torch.cuda.synchronize()
        ps, pln = K.rle_diff_encode_plain(ch, ln, c, d, cap, tile)
        name = K.TILE_MODE if tile else "rle_diff_encode"
        same(name, s, ps, errs)
        same(name + ".lens", ln_s, pln, errs)
    for lane, nl in ((512, 8), (2048, 3), (32768, 2)):
        sy, ln_p, tab, _ = (torch.from_numpy(a).to(dev)
                            for a in pack_edge_rows(lane, nl, SEED + lane))
        w, b = K.lane_pack(sy, ln_p, tab, lane)
        torch.cuda.synchronize()
        pw, pb = K.lane_pack_plain(sy, ln_p, tab, lane)
        same("lane_pack", w, pw, errs)
        same("lane_pack.bits", b, pb, errs)
    log(f"encode edges: rle_diff_encode on {tuple(ch.shape)} edge rows, diff "
        "off and on and the tile mode at T = 64, 1024, 16384; lane_pack at "
        "lane 512 x 8, 2048 x 3, 32768 x 2 with codes of depth 26 and 31: "
        "equal to their plain versions")


def stress(K, dev) -> None:
    """Kernel 1 (tile 0 with diff off and on, and the tile mode) and
    ``lane_pack`` launched STRESS_REPS times each on the small batch the GPU
    tests start from and on an encode edge batch, every result compared
    with the plain version's. Any mismatch fails the run."""
    from huffman_codec_tpu_torch.edge_cases import (
        match_plain_rows, rle_encode_edge_rows)
    from huffman_codec_tpu_torch.ops.canonical import (
        assign_codes, build_lengths_pm)

    bad = {}
    for bname, arrays, cap in (
            ("small", match_plain_rows(), 8192),
            ("edge", rle_encode_edge_rows(16384, SEED + 32), 22016)):
        ch, ln, car = (torch.from_numpy(a).to(dev) for a in arrays)
        zero = torch.zeros_like(car)
        cases = {"tile 0": (False, 0, car), "tile 0 diff": (True, 0, car),
                 "tile 64": (False, 64, zero)}
        want = {k: K.rle_diff_encode_plain(ch, ln, c, d, cap, t)
                for k, (d, t, c) in cases.items()}
        st, rl = want["tile 0 diff"]
        lens = build_lengths_pm(K.histogram256_plain(st, rl))
        tables = (assign_codes(lens) | (lens << 26)).to(torch.int32)
        want["lane_pack"] = K.lane_pack_plain(st, rl, tables, LANE)
        for k in want:
            bad[f"{bname} {k}"] = 0
        for _ in range(STRESS_REPS):
            got = {k: K.rle_diff_encode(ch, ln, c, d, cap, tile=t)
                   for k, (d, t, c) in cases.items()}
            got["lane_pack"] = K.lane_pack(st, rl, tables, LANE)
            for k, pair in got.items():
                if not all(torch.equal(g, w) for g, w in zip(pair, want[k])):
                    bad[f"{bname} {k}"] += 1
    n_bad = sum(bad.values())
    log(f"stress: {STRESS_REPS} launches a case, each held against the plain "
        f"version: {n_bad} mismatches {bad}")
    if n_bad:
        raise AssertionError(f"stress: {n_bad} mismatches {bad}")


GLOBAL_SIZES = (1 << 18, 5 << 18, 10 << 18, 64 << 20)  # 1, 5, 10 tiles; bulk
BUCKETS = (8, 12, 16, 24, 31)


def decode_edges(K, dev, errs):
    """Kernels 5 and 6 against their plain versions on the edge batches of
    ``huffman_codec_tpu_torch/edge_cases.py``: run-heavy streams at the
    sharded step's row width (count bytes at the kernel's segment and tile
    borders, count byte 255 restarts, rows of length 0, 1 and 2), and codes
    of every max_len bucket with partial and empty lanes at lane 512, 2048
    and 4096 (the deepest, 26 bits, in the 31 bucket)."""
    from huffman_codec_tpu_torch.edge_cases import (
        lane_edge_rows, pack_lane_rows, rle_edge_rows)
    from huffman_codec_tpu_torch.models.entropy import CANONICAL

    cap = CANONICAL.cap(CS, LANE)
    s, ln, car = (torch.from_numpy(a).to(dev)
                  for a in rle_edge_rows(cap, SEED + 21))
    for out_len in (128, CS, 4 * CS):  # 128: every row cut short
        for d in (False, True):
            got = K.rle_expand(s, ln, car, out_len, d)
            torch.cuda.synchronize()
            same("rle_expand", got,
                 K.rle_expand_plain(s, ln, car, out_len, d), errs)
    for lane, nl in ((512, 8), (2048, 3), (4096, 2)):
        for depth, bucket in zip((8, 12, 16, 24, 26), BUCKETS):
            sy, ln, lt = (torch.from_numpy(a).to(dev) for a in
                          lane_edge_rows(lane, nl, SEED + depth, depth))
            pb = pack_lane_rows(sy, ln, lt, lane)
            dec = K.lane_decode(pb, lt, ln, lane, bucket)
            torch.cuda.synchronize()
            same("lane_decode", dec,
                 K.lane_decode_plain(pb, lt, ln, lane, bucket), errs)
            valid = torch.arange(nl * lane, device=dev)[None, :] < ln[:, None]
            same("lane_decode.vs_input", dec, torch.where(valid, sy, 0), errs)
    # lanes that do not divide by 16 (the kernel stores them 4 bytes a
    # thread) or by 4 (a byte a thread), and one over 4096 that does not
    # divide by 128 (the codec's decode sends it here, not to kernel 7), at
    # a stride that does not divide by 4, packed by the plain versions on
    # the host
    for lane in (100, 36, 6, 4098):
        sy, ln, lt = (torch.from_numpy(a) for a in
                      lane_edge_rows(lane, 5, SEED + lane, 26))
        pb = pack_lane_rows(sy, ln, lt, lane, wb_pad=3)
        pb, lt, ln, sy = pb.to(dev), lt.to(dev), ln.to(dev), sy.to(dev)
        dec = K.lane_decode(pb, lt, ln, lane, 31)
        torch.cuda.synchronize()
        same("lane_decode", dec, K.lane_decode_plain(pb, lt, ln, lane, 31),
             errs)
        valid = torch.arange(5 * lane, device=dev)[None, :] < ln[:, None]
        same("lane_decode.vs_input", dec, torch.where(valid, sy, 0), errs)
    log(f"decode edges: rle_expand on {tuple(s.shape)} run-heavy rows to "
        f"128, {CS} and {4 * CS} B, diff on and off; lane_decode at lane 512, "
        "2048, 4096 x max_len 8, 12, 16, 24, 31 and at lane 100, 36, 6 and "
        "4098 (stride not a multiple of 4): equal to their plain versions "
        "and to the input")


def repad_geometry(K, where, flat, lw, wb):
    """Time ``repad_words`` at one geometry beside its bound and its
    library call (one ``masked_scatter_``, never called by the port), and
    record it in the kernel's ``by_geometry``."""
    C, nl = lw.shape
    dev = flat.device
    mk = torch.arange(wb, device=dev)[None, None, :] < lw[:, :, None]

    def lib():
        out = torch.zeros((C, nl, wb), dtype=torch.int32, device=dev)
        return out.masked_scatter_(mk, flat)

    same("repad_words.vs_library", K.repad_words(flat, lw, wb),
         lib().view(C, -1), {})
    ms = cuda_ms(lambda: K.repad_words(flat, lw, wb), reps=20, warm=3,
                 queued=True)
    lib_ms = cuda_ms(lib, reps=20, warm=3, queued=True)
    geometry("repad_words", where, ms,
             4 * int(lw.sum()) + 4 * C * nl + 4 * C * nl * wb,
             4 * C * nl * wb, library_ms=lib_ms)
    return ms, lib_ms


def shapes_path(K, TorchCodec, CodecConfig, errs):
    """The configs whose shapes do not divide by 16 (``ODD_CONFIGS`` of
    ``huffman_codec_tpu_torch/edge_cases.py``: chunks of 1000 bytes, lanes
    of 100 and 8 symbols), which every wrapper now launches its kernel at:
    each kernel of the sharded chain held against its plain version at
    those shapes, ``rle_expand`` on a row past 2^23 bytes, then counted
    round trips through ``encode``/``decode`` whose containers must equal
    the CPU plain path's. Returns the launch counts of the round trips."""
    from huffman_codec_tpu_torch.edge_cases import (
        ODD_CONFIGS, odd_config_input)

    dev = torch.device("cuda")
    for name in ("sharded-1000-100", "sharded-lane-8"):
        cfg = CodecConfig(**ODD_CONFIGS[name])
        x = np.frombuffer(odd_config_input(name), np.uint8)
        cs, n_ch = cfg.chunk_size, -(-x.size // cfg.chunk_size)
        rows = np.zeros(n_ch * cs, np.uint8)
        rows[: x.size] = x
        chunks = torch.from_numpy(rows).to(dev).view(n_ch, cs)
        lens = torch.from_numpy(np.clip(
            x.size - np.arange(n_ch) * cs, 0, cs).astype(np.int32)).to(dev)
        car = torch.cat([torch.zeros(1, dtype=torch.uint8, device=dev),
                         chunks[:-1, -1]])
        for d in (False, True):
            kernel_chain(K, chunks, lens, car, d, errs, {}, lane=cfg.lane)
    rng = np.random.default_rng(SEED + 41)
    n = (1 << 23) + 100
    row = torch.from_numpy(rng.integers(0, 3, (1, n), dtype=np.int64)
                           .astype(np.uint8)).to(dev)
    ln = torch.tensor([n - 7], dtype=torch.int32, device=dev)
    car = torch.tensor([5], dtype=torch.uint8, device=dev)
    for out_len in (1000, 1 << 25):
        same("rle_expand", K.rle_expand(row, ln, car, out_len, True),
             K.rle_expand_plain(row, ln, car, out_len, True), errs)
    log("shapes: the six kernels at chunk 1000 / lane 100 and chunk 4096 / "
        "lane 8, diff on and off, and rle_expand on a row of "
        f"{n} B to 1000 and 2^25 B: equal to their plain versions")

    K.reset_launches()
    for name, fields in ODD_CONFIGS.items():
        data = odd_config_input(name)
        for d in (False, True):
            cfg = CodecConfig(use_diff=d, **fields)
            gpu, cpu = TorchCodec(cfg), TorchCodec(cfg, device="cpu")
            if cfg.layout == "sharded":
                blobs = [gpu.encode(data)]
                want = [cpu.encode(data)]
            else:  # encode() keeps v1 at this size: the v3 candidates
                blobs = [gpu._encode_global(data, None, w)
                         for w in gpu.global_candidates(len(data))]
                want = [cpu._encode_global(data, None, w)
                        for w in cpu.global_candidates(len(data))]
            if blobs != want:
                raise AssertionError(f"shapes: {name} diff={d}: GPU "
                                     "container differs from the CPU plain "
                                     "path")
            for b in blobs:
                if gpu.decode(b) != data or cpu.decode(b) != data:
                    raise AssertionError(f"shapes: {name} diff={d}: round "
                                         "trip failed")
            log(f"shapes: {name} diff={d}: {[len(b) for b in blobs]} B, "
                "GPU container == CPU plain container, round trip exact")
    launches = K.launch_counts()
    log("shapes path launches:", launches)
    for k in ("rle_diff_encode", "histogram256", "lane_pack", "repad_words",
              "lane_decode", "rle_expand"):
        if not launches[k]:
            raise AssertionError(f"shapes: {k} was never launched: "
                                 f"{launches}")
    return launches


def fat_buffer(K, sy, lt, lane, pad=0):
    """(1, nl, wb) lane words of one chunk of symbols ``sy`` (1, nl * lane)
    under code lengths ``lt`` (1, 256), packed by kernel 3 and re-padded by
    kernel 4, as the whole-file decode receives them; ``pad`` zero words
    more a lane than they need."""
    from huffman_codec_tpu_torch.edge_cases import pack_lane_rows

    ln = torch.tensor([sy.shape[1]], dtype=torch.int32, device=sy.device)
    pb = pack_lane_rows(sy, ln, lt, lane)
    if pad:
        pb = torch.nn.functional.pad(pb, (0, pad))
    return pb, ln


def global_chain(K, cfg, x, whole, errs):
    """Run one global-layout candidate's device stage on resident input
    ``x`` and its decode as ``TorchCodec`` chains them, every kernel held
    against its plain version on the same inputs (tolerance 0). Returns
    the tensors the timings reuse."""
    from huffman_codec_tpu_torch.models.chunked import (
        _chunkify, _global_geometry)
    from huffman_codec_tpu_torch.models.entropy import (
        _SINGLE_MAX, _strip_payload, lookup)
    from huffman_codec_tpu_torch.ops.canonical import assign_codes, build_lengths_pm
    from huffman_codec_tpu_torch.ops.diff import diff_apply
    from huffman_codec_tpu_torch.ops.rle import rle_encode

    dev = x.device
    n = x.shape[0]
    cs, lane, max_chunks = _global_geometry(cfg, n, whole,
                                            lookup(cfg.entropy))
    xs = diff_apply(x) if cfg.use_diff else x
    stream, total = rle_encode(
        xs[None, :], torch.tensor([n], dtype=torch.int32, device=dev),
        max_chunks * cs)
    chunks, lens = _chunkify(stream[0], total[0], cs, max_chunks)
    counts = K.histogram256(chunks, lens)
    torch.cuda.synchronize()
    same("histogram256", counts, K.histogram256_plain(chunks, lens), errs)
    cl = build_lengths_pm(counts)
    tables = (assign_codes(cl) | (cl << 26)).to(torch.int32)
    buf, bits = K.lane_pack(chunks, lens, tables, lane)
    torch.cuda.synchronize()
    pbuf, pbits = K.lane_pack_plain(chunks, lens, tables, lane)
    same("lane_pack", buf, pbuf, errs)
    same("lane_pack.bits", bits, pbits, errs)
    del pbuf
    lw = ((bits + 31) >> 5).to(torch.int32)
    flat = _strip_payload(buf, lw).contiguous()
    wb = min(max(8, -(-int(lw.max()) // 16) * 16), K.lane_words_cap(lane))
    rows, rcs, lt = max_chunks, cs, cl.to(torch.uint8)
    if whole and (cs // lane) % 8 == 0 and cs <= _SINGLE_MAX:
        rows, rcs = 8, cs // 8  # decode as 8 pseudo-chunks, one table
        lw = lw.view(8, -1).contiguous()
        lt = lt.repeat(8, 1)
    padded = K.repad_words(flat, lw, wb)
    torch.cuda.synchronize()
    same("repad_words", padded, K.repad_words_plain(flat, lw, wb), errs)
    cnt = (total[0].to(torch.int64) - torch.arange(rows, device=dev) * rcs
           ).clamp(0, rcs).to(torch.int32)
    pb = padded.view(rows, lw.shape[1], wb)
    max_len = next(b for b in BUCKETS if b >= int(cl.max()))
    name = "lane_decode_lanemajor" if lane > 4096 else "lane_decode"
    dec = getattr(K, name)(pb, lt, cnt, lane, max_len)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = getattr(K, name + "_plain")(pb, lt, cnt, lane, max_len)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    same(name, dec, want, errs)
    same(name + ".vs_stream", dec.view(1, -1), stream, errs)
    return dict(x=x, chunks=chunks, lens=lens, counts=counts, cl=cl,
                tables=tables, lane=lane, cs=cs, buf=buf, flat=flat, lw=lw,
                wb=wb, pb=pb, lt=lt, cnt=cnt, max_len=max_len, dec=dec,
                total=int(total[0]), plain_ms=plain_ms, name=name,
                shape=(rows, lw.shape[1]))


def stage_split(K, g):
    """Device time of each stage of the whole-file candidate and of its
    decode, on the tensors ``global_chain`` left (diff on)."""
    from huffman_codec_tpu_torch.models.chunked import _decode_stream_tail
    from huffman_codec_tpu_torch.models.entropy import _strip_payload
    from huffman_codec_tpu_torch.ops.canonical import assign_codes, build_lengths_pm
    from huffman_codec_tpu_torch.ops.diff import diff_apply
    from huffman_codec_tpu_torch.ops.rle import rle_encode

    x, n = g["x"], g["x"].shape[0]
    nn = torch.tensor([n], dtype=torch.int32, device=x.device)
    lw1 = g["lw"].view(1, -1)
    stages = {
        "diff_apply + rle_encode (torch ops)":
            lambda: rle_encode(diff_apply(x)[None, :], nn, g["cs"]),
        "histogram256": lambda: K.histogram256(g["chunks"], g["lens"]),
        "build_lengths_pm + assign_codes (torch ops)":
            lambda: assign_codes(build_lengths_pm(g["counts"])),
        "lane_pack": lambda: K.lane_pack(g["chunks"], g["lens"], g["tables"],
                                         g["lane"]),
        "strip_payload (torch ops)": lambda: _strip_payload(g["buf"], lw1),
        "repad_words": lambda: K.repad_words(g["flat"], g["lw"], g["wb"]),
        "lane_decode_lanemajor": lambda: K.lane_decode_lanemajor(
            g["pb"], g["lt"], g["cnt"], g["lane"], g["max_len"]),
        "rle_decode + diff_revert (torch ops)": lambda: _decode_stream_tail(
            g["dec"].view(-1), g["total"], n + 8, True),
    }
    log(f"global stages at {n} B, whole-file candidate, diff on (ms):",
        {k: round(cuda_ms(f, reps=5), 3) for k, f in stages.items()})


def fat_edge_batch(K, dev, errs):
    """The fat-lane decode kernel on edge cases at lane 8192, two lanes a
    chunk and one: a full random chunk, a partial last lane, an empty
    chunk, a one-symbol table, two symbols one byte short of full; and at
    lane 32768 on ``fat_lane_rows`` of
    ``huffman_codec_tpu_torch/edge_cases.py``."""
    from huffman_codec_tpu_torch.edge_cases import fat_lane_rows
    from huffman_codec_tpu_torch.models.entropy import _strip_payload
    from huffman_codec_tpu_torch.ops.canonical import assign_codes, build_lengths_pm

    lane = 8192
    rng = np.random.default_rng(SEED + 7)
    for nl in (2, 1):
        L = nl * lane
        rows = [rng.integers(0, 256, L, dtype=np.uint8),
                gradient_input(L, SEED + 8), np.zeros(L, np.uint8),
                np.full(L, 65, np.uint8),
                rng.integers(0, 2, L, dtype=np.uint8)]
        lens = [L, L - lane + 1000, 0, L, L - 1]
        chunks = torch.from_numpy(np.stack(rows)).to(dev)
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        cl = build_lengths_pm(K.histogram256(chunks, ln))
        tables = (assign_codes(cl) | (cl << 26)).to(torch.int32)
        buf, bits = K.lane_pack(chunks, ln, tables, lane)
        lw = ((bits + 31) >> 5).to(torch.int32)
        wb = max(8, -(-int(lw.max()) // 16) * 16)
        pb = K.repad_words(_strip_payload(buf, lw).contiguous(), lw,
                           wb).view(len(rows), nl, wb)
        lt = cl.to(torch.uint8)
        dec = K.lane_decode_lanemajor(pb, lt, ln, lane, 31)
        torch.cuda.synchronize()
        same("lane_decode_lanemajor", dec,
             K.lane_decode_lanemajor_plain(pb, lt, ln, lane, 31), errs)
        valid = torch.arange(L, device=dev)[None, :] < ln[:, None]
        same("lane_decode_lanemajor.vs_input", dec,
             torch.where(valid, chunks, 0), errs)
    # lane 32768: random bytes, a fixed 7-bit code (never resynchronised),
    # windows with no code (one- and two-symbol tables), codes of 20-31
    # bits across sub-sequence borders, a chain past the lane's last word,
    # a partial lane; against the plain version in one call (its loop runs
    # once a symbol of the lane) and against kernel 5 at each row's bucket
    lane = 32768
    buf, lt, ln, buckets, names = fat_lane_rows(lane, SEED + 9, dev)
    dec = K.lane_decode_lanemajor(buf, lt, ln, lane, 31)
    torch.cuda.synchronize()
    same("lane_decode_lanemajor", dec,
         K.lane_decode_lanemajor_plain(buf, lt, ln, lane, 31), errs)
    for r, b in enumerate(buckets):
        args = (buf[r:r + 1].clone(), lt[r:r + 1].clone(),
                ln[r:r + 1].clone(), lane, b)
        same(f"lane_decode_lanemajor.vs_lane_decode {names[r]}",
             K.lane_decode_lanemajor(*args), K.lane_decode(*args), errs)
    log(f"fat edges: lane_decode_lanemajor at lane 8192 x 2 and x 1, and "
        f"at lane 32768 on {names}: equal to its plain version and to "
        "lane_decode")


def histogram_one_row(K, g, n: int, errs) -> None:
    """``histogram256`` on the whole-file chunk (C = 1, its row cut into
    slices over the card) beside ``torch.bincount`` of the valid prefix,
    one PyTorch call of the same function. ``bincount`` reads the row's
    maximum back to the host to size its output, so it cannot be queued
    behind device work: its time is host-paced (the mean of a batch
    between two events, each call waiting on its own read-back), the
    clock of the kernel's ``host_paced_ms``, which it is held against;
    the kernel's ``ms`` is queued device time."""
    chunks, lens = g["chunks"], g["lens"]
    C, L = chunks.shape
    m = int(lens[0])
    got = K.histogram256(chunks, lens)
    same("histogram256.one_row", got, K.histogram256_plain(chunks, lens), errs)
    lib = torch.bincount(chunks[0, :m], minlength=256).to(torch.int32)
    same("histogram256.one_row_vs_bincount", got[0], lib, errs)
    ms = cuda_ms(lambda: K.histogram256(chunks, lens), reps=20, warm=3,
                 queued=True)
    host_ms = cuda_ms(lambda: K.histogram256(chunks, lens), reps=20, warm=3)
    lib_ms = cuda_ms(lambda: torch.bincount(chunks[0, :m], minlength=256),
                     reps=20, warm=3)
    geometry("histogram256", f"the {n} B whole-file chunk (1 x {L}, {m} B "
             "valid)", ms, m + 4 * C + 1024 * C, 2 * m,
             host_paced_ms=host_ms, library_ms=lib_ms)


def global_path(K, TorchCodec, CodecConfig, x, errs):
    """The global layout's checks, counted round trips and timings.
    Returns (launch counts of its round trips, kernel 7's row values)."""
    from huffman_codec_tpu_torch.native import runtime

    dev = torch.device("cuda")
    cfgs = {d: CodecConfig(use_diff=d) for d in (False, True)}

    # -- kernels against their plain versions at the global geometries ------
    whole = {}
    for n in GLOBAL_SIZES[:3]:  # whole-file candidate: fat lanes, kernel 7
        xd = torch.from_numpy(x[:n].copy()).to(dev)
        whole[n] = g = global_chain(K, cfgs[True], xd, True, errs)
        log(f"global whole-file {n} B: lane {g['lane']}, chunk {g['cs']}, "
            f"decode geometry {g['shape']} x {g['lane']}: {g['name']} and "
            f"kernels 2-4 equal their plain versions (plain decode "
            f"{g['plain_ms']:.0f} ms)")
    xd = torch.from_numpy(x[: 16 << 20].copy()).to(dev)
    g = global_chain(K, cfgs[False], xd, False, errs)  # chunked: lane 2048
    log(f"global chunked 16 MiB: lane {g['lane']}, {g['shape'][0]} chunks: "
        f"{g['name']} and kernels 2-4 equal their plain versions")
    del g, xd
    fat_edge_batch(K, dev, errs)
    log("global kernels vs plain: all equal; max abs err", max(errs.values()))

    # -- counted round trips through encode()/decode() -----------------------
    blobs = {}
    K.reset_launches()
    for n in GLOBAL_SIZES:
        data = x[:n].tobytes()
        for d, cfg in cfgs.items():
            codec = TorchCodec(cfg)
            t = time.perf_counter()
            blob = codec.encode(data)
            e2e_enc = time.perf_counter() - t
            t = time.perf_counter()
            back = codec.decode(blob)
            e2e_dec = time.perf_counter() - t
            if back != data:
                raise AssertionError(f"global round trip failed ({n} B, "
                                     f"diff={d})")
            if blob[:6] != b"HCTPU\x03":
                raise AssertionError(f"expected a v3 container ({n} B, "
                                     f"diff={d}): above the v1 race's gate")
            hdr = codec._parse(blob)
            won = ("whole-file" if hdr["n_chunks"] == 1 and hdr["lane"] > 2048
                   else "chunked")
            log(f"global {n} B diff={d}: {won} candidate won (chunk "
                f"{hdr['chunk_size']}, lane {hdr['lane']}, {hdr['n_chunks']} "
                f"chunks), {len(blob)} B, {8 * len(blob) / n:.4f} bpc, round "
                f"trip exact, crc ok; end to end encode {e2e_enc:.3f} s, "
                f"decode {e2e_dec:.3f} s")
            blobs[(n, d)] = blob
    launches = K.launch_counts()
    log("global path launches (eight round trips):", launches)
    for name in ("lane_decode_lanemajor", "histogram256", "lane_pack",
                 "repad_words", "lane_decode"):
        if not launches[name]:
            raise AssertionError(f"{name} was never launched on the global "
                                 f"path: {launches}")

    # -- the v1 race on a small, compressible input --------------------------
    small = x[: 1 << 16].tobytes()
    codec = TorchCodec(cfgs[True])
    v3 = min((codec._encode_global(small, None, w)
              for w in codec.global_candidates(len(small))), key=len)
    v1 = runtime.v1_compress(small, True, False, 512)
    got = codec.encode(small)
    if got != (v1 if len(v1) < len(v3) else v3):
        raise AssertionError("encode() did not keep the smaller of v3 and v1")
    for blob in (got, v1, v3):
        if codec.decode(blob) != small:
            raise AssertionError("v1 race: decode failed")
    log(f"v1 race on {len(small)} B: v3 {len(v3)} B, v1 {len(v1)} B, "
        f"{'v1' if got == v1 else 'v3'} kept; v1 and v3 both decode exactly")

    # -- containers equal the plain path on the CPU (encode only) ------------
    for n in (GLOBAL_SIZES[0], GLOBAL_SIZES[2]):
        for d, cfg in cfgs.items():
            if TorchCodec(cfg, device="cpu").encode(x[:n].tobytes()) != \
                    blobs[(n, d)]:
                raise AssertionError(f"global GPU container differs from the "
                                     f"CPU plain path ({n} B, diff={d})")
        log(f"global {n} B: GPU container == CPU plain container, diff on "
            "and off")

    # -- kernel 7 and its neighbours at the whole-file geometries ------------
    def k7_time(where, pb, lt, cnt, lane, max_len, lw_sum):
        args = (pb, lt, cnt, lane, max_len)
        ms = cuda_ms(lambda: K.lane_decode_lanemajor(*args), reps=10,
                     queued=True)
        ms5 = cuda_ms(lambda: K.lane_decode(*args), reps=5, queued=True)
        same("lane_decode_lanemajor.vs_lane_decode",
             K.lane_decode_lanemajor(*args), K.lane_decode(*args), errs)
        rows, nl, _ = pb.shape
        nbytes = 4 * lw_sum + 260 * rows + rows * nl * lane
        # a table lookup, two shifts, a store and a refill test a symbol
        ops = 8 * int(cnt.sum())
        geometry("lane_decode_lanemajor", where, ms, nbytes, ops,
                 lane_decode_ms=ms5)
        return ms, ms5, nbytes, ops

    k7 = {}
    for n, g in whole.items():
        rows, nl = g["shape"]
        ms, ms5, nbytes, ops = k7_time(
            f"{g['shape']} x {g['lane']}, {n} B in", g["pb"], g["lt"],
            g["cnt"], g["lane"], g["max_len"], int(g["lw"].sum()))
        bound, by = bound_of(nbytes, ops)
        k7[n] = dict(ms=ms, plain_ms=g["plain_ms"], bound_ms=bound,
                     bound_by=by, lane_decode_ms=ms5, shape=g["shape"])
        log(f"lane_decode_lanemajor {g['shape']} x {g['lane']} ({n} B in): "
            f"plain {g['plain_ms']:.0f} ms")
    # the geometry of 2.5 MiB, (1, 112) x 32768, on random bytes (8-bit
    # codes), and on a fixed 7-bit code at a stride of 32 words more than
    # it needs: sub-sequences of 288 bits, which 7 does not divide, so no
    # speculative chain is ever in step with the true one (the worst case)
    lane, nl = 32768, 112
    rng = np.random.default_rng(SEED + 10)
    for what, nsym, bits, pad in (("random bytes", 256, 8, 0),
                                  ("fixed 7-bit code", 128, 7, 32)):
        sy = torch.from_numpy(rng.integers(0, nsym, (1, nl * lane),
                                           dtype=np.int64).astype(np.uint8)
                              ).to(dev)
        lt = torch.zeros((1, 256), dtype=torch.uint8, device=dev)
        lt[0, :nsym] = bits
        pb, cnt = fat_buffer(K, sy, lt, lane, pad)
        ms, ms5, nbytes, ops = k7_time(
            f"(1, 112) x 32768, {what}", pb, lt, cnt, lane, 8,
            nl * lane * bits // 32)
        same("lane_decode_lanemajor.vs_input",
             K.lane_decode_lanemajor(pb, lt, cnt, lane, 8), sy, errs)
        k7[what] = ms
        del sy, pb
    g = whole[GLOBAL_SIZES[2]]
    C, L = g["chunks"].shape
    repad_geometry(K, f"the 2.5 MiB whole-file chunk ({g['shape']} lanes, "
                   f"wb {g['wb']})", g["flat"], g["lw"], g["wb"])
    geometry("lane_pack", f"lane {g['lane']}, the 2.5 MiB whole-file chunk "
             f"(1 x {L})", cuda_ms(lambda: K.lane_pack(
                 g["chunks"], g["lens"], g["tables"], g["lane"]), reps=10,
                 queued=True),
             int(g["lens"].sum()) + 1028 * C + 4 * (L // g["lane"])
             * (K.lane_words_cap(g["lane"]) + 1), 6 * int(g["lens"].sum()))
    for n in (GLOBAL_SIZES[0], GLOBAL_SIZES[2]):
        histogram_one_row(K, whole[n], n, errs)
    stage_split(K, g)
    del whole, g
    k7_row = dict(k7[GLOBAL_SIZES[2]], random_bytes_ms=k7["random bytes"],
                  fixed_7bit_ms=k7["fixed 7-bit code"])

    # -- device encode and decode, inputs resident ---------------------------
    for n in GLOBAL_SIZES:
        xd = torch.from_numpy(x[:n].copy()).to(dev)
        for d, cfg in cfgs.items():
            codec = TorchCodec(cfg)
            cands = codec.global_candidates(n)
            hdr = codec._parse(blobs[(n, d)])
            st = codec.stage_global(blobs[(n, d)], hdr)
            torch.cuda.synchronize()

            def enc():
                return [codec.run_global_stage(xd, w) for w in cands]

            def dec():
                return codec.run_global_decode(hdr, st)

            enc_ms, dec_ms = median_ms(enc), median_ms(dec)
            line = (f"global device {n} B diff={d}: encode "
                    f"{n / enc_ms / 1e3:.1f} MB/s ({enc_ms:.3f} ms, "
                    f"{len(cands)} candidates), decode "
                    f"{n / dec_ms / 1e3:.1f} MB/s ({dec_ms:.3f} ms)")
            if n == GLOBAL_SIZES[3]:
                peaks = []
                for fn in (enc, dec):
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()
                    before = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    fn()
                    torch.cuda.synchronize()
                    peaks.append((torch.cuda.max_memory_allocated() - before)
                                 / 2 ** 30)
                line += (f"; peak device memory above what was resident: "
                         f"encode {peaks[0]:.2f} GiB, decode {peaks[1]:.2f} "
                         "GiB")
            log(line)
    return launches, k7_row


ADAPT_W, BAND_H = 512, 128  # 128 x 512 bands: one 64 KiB chunk each


def tile_edge_rows(dev):
    """Rows of one band's length for the tile mode: a run crossing many
    tile borders, one repeated byte, runs of exactly 258 and 259 inside a
    tile, noise, and two symbols."""
    rng = np.random.default_rng(SEED + 11)
    r0 = gradient_input(CS, SEED + 12)
    r0[CS // 2:] = 7
    r2 = gradient_input(CS, SEED + 13)
    r2[10:268] = 3
    r2[300:559] = 4
    rows = [r0, np.full(CS, 65, np.uint8), r2,
            rng.integers(0, 256, CS, dtype=np.uint8),
            rng.integers(0, 2, CS, dtype=np.uint8)]
    return torch.from_numpy(np.stack(rows)).to(dev)


def tile_mode_check(K, rows, lens, tile, cap, errs):
    zero = torch.zeros(rows.shape[0], dtype=torch.uint8, device=rows.device)
    s, ln = K.rle_diff_encode(rows, lens, zero, False, cap, tile=tile)
    torch.cuda.synchronize()
    ps, pln = K.rle_diff_encode_plain(rows, lens, zero, False, cap, tile)
    same(K.TILE_MODE, s, ps, errs)
    same(K.TILE_MODE + ".lens", ln, pln, errs)
    return s, ln


def tile_rows_check(K, A, streams, tile_lens, dirs, want, w, h, bs, errs):
    """The adaptive decode's tile rows as ``adapt_decode_bands`` builds
    them from (B, L) streams: ``rle_expand`` (no diff, ``out_len`` one
    tile) held against its plain version at that shape, and the placed
    tiles against the (B, h * w) matrices ``want``. Returns the shape of
    the rows and the kernel's time."""
    enc, rows_len = A._cut_tile_rows(streams, tile_lens, bs)
    zero = torch.zeros(enc.shape[0], dtype=torch.uint8, device=enc.device)
    tiles = K.rle_expand(enc, rows_len, zero, bs * bs, False)
    torch.cuda.synchronize()
    same("rle_expand", tiles,
         K.rle_expand_plain(enc, rows_len, zero, bs * bs, False), errs)
    same("rle_expand.tiles_round_trip",
         A._place_tiles(tiles, dirs, w, h, bs), want, errs)
    ms = cuda_ms(lambda: K.rle_expand(enc, rows_len, zero, bs * bs, False),
                 reps=10, queued=True)
    return tuple(enc.shape), ms


def emission_rows_check(K, A, matrix, w, h, bs, errs):
    """The block-size score's emission values at block size ``bs``, in the
    rows of 8192 that ``_emission_histogram`` hands to ``histogram256``:
    the kernel held against its plain version on them. Returns the rows'
    shape, the kernel's time and its bytes bound."""
    hor, ver, lens = A._gather_tiles(matrix.reshape(-1), w, h, bs)
    h_sz, h_vals = A._scan_emissions(hor, lens)
    v_sz, v_vals = A._scan_emissions(ver, lens)
    vals = torch.where((h_sz <= v_sz)[:, None], h_vals, v_vals).reshape(-1)
    del hor, ver, h_vals, v_vals
    if vals.shape[0] % 8192:
        vals = torch.cat([vals, vals.new_zeros(-vals.shape[0] % 8192)])
    rows = vals.view(-1, 8192)
    full = torch.full((rows.shape[0],), 8192, dtype=torch.int32,
                      device=rows.device)
    got = K.histogram256(rows, full)
    torch.cuda.synchronize()
    same("histogram256", got, K.histogram256_plain(rows, full), errs)
    ms = cuda_ms(lambda: K.histogram256(rows, full), reps=10, queued=True)
    nbytes = rows.numel() + 4 * rows.shape[0] + 1024 * rows.shape[0]
    return tuple(rows.shape), ms, nbytes / HBM_BYTES_PER_S * 1e3


def sharded_adapt_chain(K, A, codec, xd, bs, cap, errs):
    """The sharded-adaptive band stage and its decode on every full band
    of the resident input in one call, as ``run_sharded_adapt_stage`` and
    ``run_adapt_bands`` chain them, each kernel held against its plain
    version at that shape (tolerance 0). Returns the kernels' times."""
    from huffman_codec_tpu_torch.models.chunked import _band_winner_order
    from huffman_codec_tpu_torch.models.entropy import _strip_payload
    from huffman_codec_tpu_torch.ops.canonical import assign_codes, build_lengths_pm
    from huffman_codec_tpu_torch.ops.diff import diff_apply

    cfg = codec.config
    w, cs = cfg.width, cfg.chunk_size
    nb = xd.shape[0] // cs
    bands = xd[: nb * cs].view(nb, cs)
    car = torch.cat([xd.new_zeros(1), xd[cs - 1:: cs]])[:nb].contiguous()
    work = diff_apply(bands, car)
    win, dirs, tl = _band_winner_order(work, w, cs // w, bs)
    full = torch.full((nb,), cs, dtype=torch.int32, device=xd.device)
    zero = torch.zeros(nb, dtype=torch.uint8, device=xd.device)
    st, rl = tile_mode_check(K, win, full, bs * bs, cap, errs)
    same(K.TILE_MODE + ".vs_tile_lens", rl, tl.sum(dim=1).to(torch.int32),
         errs)
    counts = K.histogram256(st, rl)
    torch.cuda.synchronize()
    same("histogram256", counts, K.histogram256_plain(st, rl), errs)
    lens = build_lengths_pm(counts)
    tables = (assign_codes(lens) | (lens << 26)).to(torch.int32)
    buf, bits = K.lane_pack(st, rl, tables, LANE)
    torch.cuda.synchronize()
    pbuf, pbits = K.lane_pack_plain(st, rl, tables, LANE)
    same("lane_pack", buf, pbuf, errs)
    same("lane_pack.bits", bits, pbits, errs)
    del pbuf
    lw = ((bits + 31) >> 5).to(torch.int32)
    flat = _strip_payload(buf, lw).contiguous()
    wb = min(max(8, -(-int(lw.max()) // 16) * 16), K.lane_words_cap(LANE))
    padded = K.repad_words(flat, lw, wb)
    torch.cuda.synchronize()
    same("repad_words", padded, K.repad_words_plain(flat, lw, wb), errs)
    max_len = next(b for b in BUCKETS if b >= int(lens.max()))
    lt = lens.to(torch.uint8)
    pb = padded.view(nb, cap // LANE, wb)
    dec = K.lane_decode(pb, lt, rl, LANE, max_len)
    torch.cuda.synchronize()
    same("lane_decode", dec, K.lane_decode_plain(pb, lt, rl, LANE, max_len),
         errs)
    same("lane_decode.vs_streams", dec, st, errs)
    shape, t_exp = tile_rows_check(K, A, dec, tl, dirs, work, w, cs // w, bs,
                                   errs)
    times = {
        K.TILE_MODE: cuda_ms(lambda: K.rle_diff_encode(
            win, full, zero, False, cap, tile=bs * bs), reps=10, queued=True),
        "histogram256": cuda_ms(lambda: K.histogram256(st, rl), reps=10,
                                queued=True),
        "lane_pack": cuda_ms(lambda: K.lane_pack(st, rl, tables, LANE),
                             reps=10, queued=True),
        "repad_words": repad_geometry(K, f"all {nb} bands", flat, lw,
                                      wb)[0],
        "lane_decode": cuda_ms(lambda: K.lane_decode(pb, lt, rl, LANE,
                                                     max_len), reps=10,
                             queued=True),
        f"rle_expand {shape}": t_exp,
    }
    sum_rl, nl = int(rl.sum()), cap // LANE
    read = nb * cs + 5 * nb + 4 * nb
    geometry(K.TILE_MODE, f"all {nb} bands, T = {bs * bs}",
             times[K.TILE_MODE], read + sum_rl,
             rle_encode_ops(nb * cs, sum_rl, False, True),
             bound_padded_ms=(read + nb * cap) / HBM_BYTES_PER_S * 1e3)
    geometry("lane_pack", f"lane 512, all {nb} bands", times["lane_pack"],
             sum_rl + 1028 * nb + 4 * nb * nl * (K.lane_words_cap(LANE) + 1),
             6 * sum_rl)
    return nb, times


WALK_STRESS_SEEDS = 32


def walk_stress(K, dev, errs) -> None:
    """The walk kernel's two instances on ``edge_cases.walk_edge_streams``
    of 32 seeds, against ``edge_cases.walk_serial`` (the contract walked
    byte by byte in Python); seed 0 also against the plain version on the
    card. Every mismatch is printed, and any fails the run."""
    from huffman_codec_tpu_torch.edge_cases import (walk_edge_streams,
                                                    walk_serial)

    t0 = time.perf_counter()
    bad, n_cases, err = [], 0, 0
    for seed in range(WALK_STRESS_SEEDS):
        for name, (stream, offs, sizes, total, cap) in \
                walk_edge_streams(seed).items():
            args = (torch.from_numpy(stream).to(dev),
                    torch.from_numpy(offs).to(dev),
                    torch.from_numpy(sizes).to(dev), total, cap)
            lens = K.group_tile_lens(*args)
            lens_d, dec = K.group_tile_lens(*args, with_decoded=True)
            want = walk_serial(stream, offs, sizes, total, cap)
            n_cases += 1
            for what, g, w in (("lens", lens, want[0]),
                               ("lens (decoded instance)", lens_d, want[0]),
                               ("decoded", dec, want[1])):
                d = np.abs(g.cpu().numpy().astype(np.int64) - w)
                if d.any():
                    err = max(err, int(d.max()))
                    bad.append((seed, name, what))
                    log(f"walk stress: seed {seed} {name} {what}: "
                        f"{int((d > 0).sum())} of {d.size} tiles differ, "
                        f"first at {int(np.flatnonzero(d)[0])}")
            if seed == 0:
                plain = K.group_tile_lens_plain(*args, with_decoded=True)
                same("group_tile_lens.edge", lens, plain[0], errs)
                same("group_tile_lens.edge_decoded_lens", lens_d, plain[0],
                     errs)
                same("group_tile_lens.edge_decoded", dec, plain[1], errs)
    errs["group_tile_lens.stress"] = err
    if bad:
        raise AssertionError(f"walk stress: {len(bad)} mismatches: {bad[:8]}")
    per_seed = n_cases // WALK_STRESS_SEEDS
    log(f"walk stress: {WALK_STRESS_SEEDS} seeds x {per_seed} edge "
        "streams, both instances equal to the "
        f"serial walk (seed 0 also to the plain version), 0 mismatches, "
        f"{time.perf_counter() - t0:.1f} s")


def adaptive_path(K, TorchCodec, CodecConfig, x, errs):
    """Adaptive block RLE in both layouts: kernel checks, counted round
    trips, containers against the CPU plain path, timings. Returns (the
    launch counts of the 64 MiB sharded-adaptive round trip, the rows of
    the tile mode and of the group walk for the kernels line)."""
    from huffman_codec_tpu_torch.edge_cases import walk_serial
    from huffman_codec_tpu_torch.models.chunked import _band_winner_order
    from huffman_codec_tpu_torch.models.entropy import CANONICAL
    from huffman_codec_tpu_torch.ops import adapt as A
    from huffman_codec_tpu_torch.ops.canonical import (
        canonical_decode_batch, canonical_encode_batch)
    from huffman_codec_tpu_torch.ops.diff import diff_apply, diff_revert
    from huffman_codec_tpu_torch.ops.rle import (
        rle_classify, rle_encoded_size, rle_max_encoded_len)

    dev = torch.device("cuda")
    cap = CANONICAL.cap(CS, LANE)
    n_in = x.size

    # -- the tile mode against its plain version ------------------------------
    step = torch.from_numpy(x[: STEP * CS].copy()).to(dev).view(STEP, CS)
    car = torch.cat([step.new_zeros(1), step[:-1, -1]])
    work = diff_apply(step, car)
    full = torch.full((STEP,), CS, dtype=torch.int32, device=dev)
    wins = {}

    def band_step_check(b):
        win, _, tl = _band_winner_order(work, ADAPT_W, BAND_H, b)
        s, ln = tile_mode_check(K, win, full, b * b, cap, errs)
        same(K.TILE_MODE + ".vs_tile_lens", ln, tl.sum(dim=1).to(torch.int32),
             errs)
        wins[b] = (win, s, ln)

    for b in (8, 32, 128):
        band_step_check(b)
    edge = tile_edge_rows(dev)
    edge_lens = torch.tensor([CS, CS, CS, CS, 1000], dtype=torch.int32,
                             device=dev)
    for tile in (64, 1024, 16384, CS):  # CS: the whole row is one tile
        tile_mode_check(K, edge, edge_lens, tile, cap, errs)
        tile_mode_check(K, edge[2:3].clone(), edge_lens[2:3].clone(), tile,
                        cap, errs)  # one row
    log("tile mode vs plain: 256 bands at T = 64, 1024, 16384 and the edge "
        "batch at T = 64, 1024, 16384, 65536 all equal; max abs err",
        max(v for k, v in errs.items() if k.startswith(K.TILE_MODE)))

    # -- the grouped manifest's walk against its plain version ---------------
    img = diff_apply(torch.from_numpy(x[: 1 << 18].copy()).to(dev))
    walk = {}
    for bs in (8, 16):
        stream, total, _, tl = A.adapt_encode_fixed(img, 512, 512, bs,
                                                    with_header=False)
        offs = (torch.cumsum(tl, 0) - tl)[:: A.GROUP_K].to(
            torch.int32).contiguous()
        sizes = torch.full((tl.shape[0],), bs * bs, dtype=torch.int32,
                           device=dev)
        gcap = A.GROUP_K * rle_max_encoded_len(bs * bs)
        args = (stream, offs, sizes, int(total), gcap)
        got = K.group_tile_lens(*args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = K.group_tile_lens_plain(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        same("group_tile_lens", got, want, errs)
        same("group_tile_lens.vs_tile_lens", got, tl, errs)
        # the instance that also writes each tile's decoded size (V1Codec):
        # the same lengths, and every tile of a valid stream its size
        gd = K.group_tile_lens(*args, with_decoded=True)
        same("group_tile_lens.decoded_lens", gd[0], got, errs)
        same("group_tile_lens.decoded_vs_sizes", gd[1], sizes, errs)
        ms = cuda_ms(lambda: K.group_tile_lens(*args), reps=10, queued=True)
        dms = cuda_ms(lambda: K.group_tile_lens(*args, with_decoded=True),
                      reps=10, queued=True)
        # the stream and the manifest read once, the lengths written once;
        # a dozen integer operations a stream byte
        bound, by = bound_of(int(total) + 4 * offs.numel()
                             + 8 * sizes.numel(), 12 * int(total))
        walk[bs] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        decoded_ms=dms)
        log(f"group_tile_lens 512 x 512 bs {bs} ({offs.numel()} groups, "
            f"{int(total)} stream bytes): {ms:.4f} ms (with the decoded "
            f"sizes {dms:.4f} ms), plain {plain_ms:.0f} "
            f"ms (host clock, one run), bound {bound:.6f} ms by {by}; equal "
            "to the plain version and to the encoder's tile lengths")
        # V1Codec's walk: the same stream as one group of every tile, held
        # to edge_cases.walk_serial (the contract walked byte by byte in
        # Python; the plain version would take a torch step a stream byte),
        # to the encoder's tile lengths and to the sizes
        one = (stream[: int(total)].clone(),
               torch.zeros(1, dtype=torch.int32, device=dev), sizes,
               int(total), int(total))
        got = K.group_tile_lens(*one)
        gd = K.group_tile_lens(*one, with_decoded=True)
        t = time.perf_counter()
        serial = [torch.from_numpy(a).to(dev) for a in walk_serial(
            *(a.cpu().numpy() for a in one[:3]), *one[3:])]
        serial_ms = (time.perf_counter() - t) * 1e3
        same("group_tile_lens.one_group", got, serial[0], errs)
        same("group_tile_lens.one_group_decoded_lens", gd[0], serial[0],
             errs)
        same("group_tile_lens.one_group_decoded", gd[1], serial[1], errs)
        same("group_tile_lens.one_group_vs_tile_lens", got, tl, errs)
        same("group_tile_lens.one_group_decoded_vs_sizes", gd[1], sizes,
             errs)
        oms = cuda_ms(lambda: K.group_tile_lens(*one), reps=5, queued=True)
        odms = cuda_ms(lambda: K.group_tile_lens(*one, with_decoded=True),
                       reps=5, queued=True)
        obound, oby = bound_of(int(total) + 4 + 8 * sizes.numel(),
                               12 * int(total))
        walk[f"one group, bs {bs}"] = dict(
            ms=oms, decoded_ms=odms, bound_ms=obound, bound_by=oby,
            tiles=sizes.numel())
        log(f"group_tile_lens one group of {sizes.numel()} tiles (V1Codec's "
            f"walk), bs {bs}, {int(total)} stream bytes: {oms:.4f} ms (with "
            f"the decoded sizes {odms:.4f} ms), bound {obound:.6f} ms by "
            f"{oby}; both instances equal to the serial walk ({serial_ms:.0f}"
            " ms, host clock), the encoder's tile lengths and the sizes")
    del img
    walk_stress(K, dev, errs)

    # -- sharded adaptive: counted 64 MiB round trip ---------------------------
    cfg = CodecConfig(use_adapt=True, use_diff=True, width=ADAPT_W,
                      chunk_size=CS, lane=LANE, layout="sharded")
    codec = TorchCodec(cfg)
    data = x.tobytes()
    K.reset_launches()
    t = time.perf_counter()
    blob = codec.encode(data)
    e2e_enc = time.perf_counter() - t
    enc_counts = K.launch_counts()
    t = time.perf_counter()
    back = codec.decode(blob)
    e2e_dec = time.perf_counter() - t
    if back != data:
        raise AssertionError("64 MiB sharded-adaptive round trip failed")
    launches = K.launch_counts()
    hdr = codec._parse(blob)
    bs = hdr["bs"]
    n_cands = len(A.candidate_sizes(ADAPT_W, BAND_H))
    # all 1024 full bands in one call of the tile mode; the
    # search's histogram once a candidate, the entropy stage's once; the
    # decode expands every band's tiles in one launch
    want = {K.TILE_MODE: 1, "histogram256": n_cands + 1, "lane_pack": 1,
            "repad_words": 1, "lane_decode": 1, "rle_expand": 1,
            "rle_diff_encode": 0, "lane_decode_lanemajor": 0,
            "group_tile_lens": 0, "fgk_encode": 0, "fgk_decode": 0}
    if launches != want or enc_counts[K.TILE_MODE] != 1:
        raise AssertionError(f"sharded-adaptive launches {launches}, the "
                             f"code path implies {want}")
    log(f"sharded adaptive 64 MiB diff=True: bs {bs}, {hdr['n_chunks']} "
        f"bands, {len(blob)} B, {8 * len(blob) / n_in:.4f} bpc, round trip "
        f"exact, crc ok; end to end encode {e2e_enc:.3f} s, decode "
        f"{e2e_dec:.3f} s; launches {launches}")

    # -- every kernel of that round trip against its plain version, at the
    #    shapes it launched them: all 1024 bands in one call -------------------
    xd = torch.from_numpy(x).to(dev)
    nb_all, t_all = sharded_adapt_chain(K, A, codec, xd, bs, cap, errs)
    log(f"sharded adaptive, all {nb_all} bands in one call, bs {bs}: the "
        "tile mode, kernels 2-5 and rle_expand on the tile rows equal their "
        "plain versions; tiles placed back equal the input (ms):",
        {k: round(v, 4) for k, v in t_all.items()})
    rows_all = n_in // ADAPT_W
    sx = diff_apply(xd)
    shp, ms_h, bound_h = emission_rows_check(K, A, sx, ADAPT_W, rows_all, bs,
                                             errs)
    log(f"histogram256 on the search's emission rows {shp} (64 MiB matrix, "
        f"bs {bs}): equal to its plain version, {ms_h:.4f} ms, bound "
        f"{bound_h:.4f} ms by bytes")
    del xd, sx
    torch.cuda.empty_cache()

    # -- 16 bands and a 5-row tail; a range across a band border --------------
    n_tail = 16 * CS + 5 * ADAPT_W
    tail = data[:n_tail]
    K.reset_launches()
    tblob = codec.encode(tail)
    if K.launch_counts()[K.TILE_MODE] != 1:  # the tail band: torch ops
        raise AssertionError("the 5-row tail band must not reach the tile "
                             "mode kernel")
    if codec.decode(tblob) != tail:
        raise AssertionError("sharded-adaptive tail round trip failed")
    thdr = codec._parse(tblob)
    for start, length in ((CS - 1000, 3000), (15 * CS + 100, CS + 2000),
                          (n_tail - 700, 700)):
        if codec.decode_range(tblob, start, length) != \
                tail[start:start + length]:
            raise AssertionError(f"decode_range({start}, {length}) differs")
    if TorchCodec(cfg, device="cpu").encode(tail) != tblob:
        raise AssertionError("sharded-adaptive GPU container differs from "
                             "the CPU plain path")
    log(f"sharded adaptive {n_tail} B (16 bands + a 5-row tail): bs "
        f"{thdr['bs']}, {len(tblob)} B, round trip exact, three ranges "
        "across band borders exact, GPU container == CPU plain container")

    # -- global adaptive: 256 KiB and 2.5 MiB ----------------------------------
    gblobs = {}
    K.reset_launches()
    for n in (GLOBAL_SIZES[0], GLOBAL_SIZES[2]):
        gdata = x[:n].tobytes()
        for d in (False, True):
            gc = TorchCodec(CodecConfig(use_adapt=True, use_diff=d,
                                        width=ADAPT_W))
            t = time.perf_counter()
            gblob = gc.encode(gdata)
            e2e_enc = time.perf_counter() - t
            t = time.perf_counter()
            if gc.decode(gblob) != gdata:
                raise AssertionError(f"global adaptive round trip failed "
                                     f"({n} B, diff={d})")
            e2e_dec = time.perf_counter() - t
            gh = gc._parse(gblob)
            sizes = {}
            for whole in gc.global_candidates(n):
                cand = gc._encode_global(gdata, gh["bs"], whole)
                if gc.decode(cand) != gdata:
                    raise AssertionError(f"global adaptive candidate failed "
                                         f"({n} B, diff={d}, whole={whole})")
                ch = gc._parse(cand)
                sizes["whole-file" if whole else "chunked"] = (
                    len(cand), bool(ch["flags"] & 0x10))
            if len(gblob) != min(v[0] for v in sizes.values()):
                raise AssertionError("encode() did not keep the smaller "
                                     "candidate")
            log(f"global adaptive {n} B diff={d}: bs {gh['bs']}, "
                f"{len(gh['dirs'])} tiles, candidates (bytes, grouped "
                f"manifest) {sizes}, kept {len(gblob)} B, "
                f"{8 * len(gblob) / n:.4f} bpc, round trips exact, crc ok; "
                f"end to end encode {e2e_enc:.3f} s, decode {e2e_dec:.3f} s")
            gblobs[(n, d)] = gblob
    # a grouped manifest, whatever the search chose: bs 8 at 256 KiB
    gc = TorchCodec(CodecConfig(use_adapt=True, use_diff=True, width=ADAPT_W))
    small = x[: GLOBAL_SIZES[0]].tobytes()
    walks = K.launch_counts()["group_tile_lens"]
    g8 = gc._encode_global(small, 8, True)
    if not gc._parse(g8)["flags"] & 0x10 or gc.decode(g8) != small:
        raise AssertionError("grouped-manifest round trip failed")
    glaunches = K.launch_counts()
    if glaunches["group_tile_lens"] != walks + 1:
        raise AssertionError("the grouped decode must launch the walk kernel")
    log("global adaptive launches (four encode() round trips, their "
        "candidates and one grouped round trip):", glaunches)
    for d in (False, True):
        cc = TorchCodec(CodecConfig(use_adapt=True, use_diff=d,
                                    width=ADAPT_W), device="cpu")
        if cc.encode(small) != gblobs[(GLOBAL_SIZES[0], d)]:
            raise AssertionError("global adaptive GPU container differs "
                                 f"from the CPU plain path (diff={d})")
    if TorchCodec(CodecConfig(use_adapt=True, use_diff=True, width=ADAPT_W),
                  device="cpu")._encode_global(small, 8, True) != g8:
        raise AssertionError("grouped GPU container differs from the CPU "
                             "plain path")
    log(f"global adaptive 256 KiB: bs 8 grouped manifest round trip exact "
        f"({len(g8)} B); GPU containers == CPU plain containers, diff on "
        "and off and grouped")

    # -- the global-adaptive decodes' tile rows and the search's histogram
    #    rows against the plain versions, at the block sizes those paths chose --
    for n in (GLOBAL_SIZES[0], GLOBAL_SIZES[2]):
        h = n // ADAPT_W
        raw = torch.from_numpy(x[:n].copy()).to(dev)
        for d in (False, True):
            b = gc._parse(gblobs[(n, d)])["bs"]  # what the search chose
            img = diff_apply(raw) if d else raw
            stream, _, dirs, tl = A.adapt_encode_fixed(img, ADAPT_W, h, b,
                                                       with_header=False)
            shp, ms_e = tile_rows_check(K, A, stream[None, :], tl[None, :],
                                        dirs[None, :], img[None, :], ADAPT_W,
                                        h, b, errs)
            hshp, ms_h, _ = emission_rows_check(K, A, img, ADAPT_W, h, b, errs)
            log(f"global adaptive {n} B diff={d} bs {b}: rle_expand on tile "
                f"rows {shp} -> {b * b} B each and histogram256 on emission "
                f"rows {hshp} equal their plain versions; {ms_e:.4f} ms and "
                f"{ms_h:.4f} ms")
    del raw, img, stream

    # -- times: the tile mode at one 256-band step ------------------------------
    if bs not in wins:  # the block size the search chose
        band_step_check(bs)
    win, s_b, ln_b = wins[bs]
    zero = torch.zeros(STEP, dtype=torch.uint8, device=dev)
    sum_out = int(ln_b.sum())
    # the bands read once, every band's stream and its length written once
    # (the kernel also zero-fills each row to ``cap``: its choice, not work
    # the function needs, so the padding is shown apart)
    nbytes = STEP * CS + 5 * STEP + sum_out + 4 * STEP
    padded_bytes = nbytes - sum_out + STEP * cap
    n_ops = rle_encode_ops(STEP * CS, sum_out, False, True)
    bound, by = bound_of(nbytes, n_ops)
    per_t = {}
    for b in wins:
        w_b = wins[b][0]
        per_t[b * b] = cuda_ms(lambda: K.rle_diff_encode(
            w_b, full, zero, False, cap, tile=b * b), reps=20, warm=3,
            queued=True)
    ms = per_t[bs * bs]
    geometry(K.TILE_MODE, f"256 bands, T = {bs * bs}", ms, nbytes, n_ops,
             bound_padded_ms=padded_bytes / HBM_BYTES_PER_S * 1e3)
    plain_ms = cuda_ms(lambda: K.rle_diff_encode_plain(
        win, full, zero, False, cap, bs * bs), reps=2, warm=1)
    log(f"{K.TILE_MODE} 256 bands, T = {bs * bs}: {ms:.4f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound:.4f} ms by {by} ({nbytes} B: "
        f"{STEP * CS} read, {sum_out} stream bytes written; with the rows "
        f"zero-padded to {cap} it moves {padded_bytes} B, "
        f"{padded_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); by T: "
        + ", ".join(f"{t}: {v:.4f}" for t, v in per_t.items()))
    row_1b = {"name": K.TILE_MODE, "route": "cuda",
              "source": "huffman_codec_tpu_torch/csrc/rle_encode.cu",
              "replaces": "huffman_codec_tpu/ops/pallas_kernels.py:944",
              "launches": launches[K.TILE_MODE],
              "max_abs_err": max(v for k, v in errs.items()
                                 if k.startswith(K.TILE_MODE)),
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
              "bound_by": by, "library_ms": None}
    row_walk = {"name": "group_tile_lens", "route": "cuda",
                "source": "huffman_codec_tpu_torch/csrc/group_tile_lens.cu",
                "replaces": "huffman_codec_tpu/ops/adapt.py:159 (an XLA "
                            "scan, no TPU kernel)",
                "launches": glaunches["group_tile_lens"],
                "max_abs_err": max(v for k, v in errs.items()
                                   if k.startswith("group_tile_lens")),
                **walk[8], "library_ms": None,
                "grouped_bs16": walk[16],
                "one_group": {k: v for k, v in walk.items()
                              if isinstance(k, str)}}

    # -- times: the sharded-adaptive stages at one 256-band step ---------------
    hor, ver, _ = A._gather_tiles(work, ADAPT_W, BAND_H, bs)
    T = bs * bs
    tfull = torch.full((hor.shape[0] * hor.shape[1],), T, dtype=torch.int32,
                       device=dev)
    enc_stages = {
        "diff_apply": lambda: diff_apply(step, car),
        "tile reorder (both orders)":
            lambda: A._gather_tiles(work, ADAPT_W, BAND_H, bs),
        "size pass (both orders)":
            lambda: (rle_encoded_size(hor.reshape(-1, T), tfull),
                     rle_encoded_size(ver.reshape(-1, T), tfull)),
        "reorder + sizes + pick":
            lambda: _band_winner_order(work, ADAPT_W, BAND_H, bs),
        K.TILE_MODE: lambda: K.rle_diff_encode(win, full, zero, False, cap,
                                               tile=T),
        "entropy stage": lambda: canonical_encode_batch(s_b, ln_b, lane=LANE),
    }
    log(f"sharded-adaptive encode stages, 256 bands, bs {bs} (ms):",
        {k: round(cuda_ms(f, reps=5), 3) for k, f in enc_stages.items()})
    del hor, ver, tfull, enc_stages
    staged = codec.stage_adapt_bands(blob, hdr, 0, STEP)
    torch.cuda.synchronize()  # the staged copies ran on the copy stream
    st = staged[0]
    words = K.repad_words(st["flat"], st["lw"], hdr["wl_bucket"])
    streams = canonical_decode_batch(
        words, st["tables"], st["lw"], st["rl"], lane=LANE, out_len=cap,
        max_len=hdr["max_len_bucket"])
    enc_rows, rows_len = A._cut_tile_rows(streams, st["tile_lens"], bs)
    zrows = torch.zeros(enc_rows.shape[0], dtype=torch.uint8, device=dev)
    tiles = K.rle_expand(enc_rows, rows_len, zrows, bs * bs, False)
    placed = A._place_tiles(tiles, st["dirs"], ADAPT_W, BAND_H, bs)
    dec_stages = {
        "entropy decode (repad + lane decode)": lambda: canonical_decode_batch(
            K.repad_words(st["flat"], st["lw"], hdr["wl_bucket"]),
            st["tables"], st["lw"], st["rl"], lane=LANE, out_len=cap,
            max_len=hdr["max_len_bucket"]),
        "cut tile rows": lambda: A._cut_tile_rows(streams, st["tile_lens"],
                                                  bs),
        "rle_expand (classify fused)": lambda: K.rle_expand(
            enc_rows, rows_len, zrows, bs * bs, False),
        "place tiles": lambda: A._place_tiles(tiles, st["dirs"], ADAPT_W,
                                              BAND_H, bs),
        "diff_revert": lambda: diff_revert(placed, st["car"]),
    }
    log(f"sharded-adaptive decode stages, 256 bands, bs {bs}, "
        f"{enc_rows.shape[0]} tile rows of {enc_rows.shape[1]} (ms):",
        {k: round(cuda_ms(f, reps=5), 3) for k, f in dec_stages.items()},
        "; rle_classify as torch ops on the same rows, which the decode no "
        "longer runs:",
        round(cuda_ms(lambda: rle_classify(enc_rows, rows_len), reps=5), 3))
    del staged, st, words, streams, enc_rows, tiles, placed, dec_stages
    del wins, work, step

    # -- times: search, device encode and decode, peak memory ------------------
    xd = torch.from_numpy(x).to(dev)
    sx = diff_apply(xd)
    rows_all = n_in // ADAPT_W
    log("search per candidate, 64 MiB matrix (ms):",
        {b: round(cuda_ms(lambda: A._adapt_score_v3(sx, ADAPT_W, rows_all, b),
                          reps=3, warm=1), 3)
         for b in A.candidate_sizes(ADAPT_W, BAND_H)})
    del sx
    staged = codec.stage_adapt_bands(blob, hdr, 0, hdr["n_chunks"])
    torch.cuda.synchronize()

    def search():
        return A.adapt_search_best_v3(diff_apply(xd), ADAPT_W, rows_all,
                                      max_height=BAND_H)

    def enc():
        return codec.run_sharded_adapt_stage(xd, bs)

    def dec():
        return codec.run_adapt_bands(hdr, staged)

    t_search, t_enc, t_dec = median_ms(search), median_ms(enc), median_ms(dec)
    peaks = []
    for fn in (search, enc, dec):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - before) / 2 ** 30)
    log(f"sharded adaptive device 64 MiB diff=True: search {t_search:.3f} ms, "
        f"band stage {t_enc:.3f} ms, encode "
        f"{n_in / (t_search + t_enc) / 1e3:.1f} MB/s, decode "
        f"{n_in / t_dec / 1e3:.1f} MB/s ({t_dec:.3f} ms), "
        f"{8 * len(blob) / n_in:.4f} bpc; peak device memory above what was "
        f"resident: search {peaks[0]:.2f} GiB, band stage {peaks[1]:.2f} "
        f"GiB, decode {peaks[2]:.2f} GiB")
    del staged, xd
    torch.cuda.empty_cache()

    for n in (GLOBAL_SIZES[0], GLOBAL_SIZES[2]):
        xg = torch.from_numpy(x[:n].copy()).to(dev)
        for d in (False, True):
            gc = TorchCodec(CodecConfig(use_adapt=True, use_diff=d,
                                        width=ADAPT_W))
            gh = gc._parse(gblobs[(n, d)])
            gst = gc.stage_global(gblobs[(n, d)], gh)
            cands = gc.global_candidates(n)
            torch.cuda.synchronize()

            def gsearch():
                return A.adapt_search_best_v3(
                    diff_apply(xg) if d else xg, ADAPT_W, n // ADAPT_W)

            def genc():
                return [gc.run_global_stage(xg, w, gh["bs"]) for w in cands]

            def gdec():
                return gc.run_global_decode(gh, gst)

            ts, te, td = median_ms(gsearch), median_ms(genc), median_ms(gdec)
            log(f"global adaptive device {n} B diff={d}: search {ts:.3f} ms "
                f"({len(A.candidate_sizes(ADAPT_W, n // ADAPT_W))} "
                f"candidates), {len(cands)} candidate stages {te:.3f} ms, "
                f"encode {n / (ts + te) / 1e3:.1f} MB/s, decode "
                f"{n / td / 1e3:.1f} MB/s ({td:.3f} ms)")
    # the grouped decode's stages at 256 KiB, bs 8
    gh = gc._parse(g8)
    gst = gc.stage_global(g8, gh)
    torch.cuda.synchronize()
    log(f"global adaptive 256 KiB bs 8 (grouped) device decode "
        f"{median_ms(lambda: gc.run_global_decode(gh, gst)):.3f} ms, of "
        f"which the walk kernel {walk[8]['ms']:.4f} ms")
    return launches, row_1b, row_walk


# the FGK phase: a chunk's symbols in the plain comparison
FGK_PLAIN_SYMBOLS = 2048
FGK_STRESS_SEEDS = 32


def fgk_ops(bits: int) -> int:
    """Integer operations FGK coding needs for ``bits`` code bits, counted
    as a serial coder does them: a code bit is one tree level, which costs
    the code climb's parent load, edge compare and bit store (3) and the
    update's level there: the successor lookup's compare, the swap test,
    the weight increment and the parent load (4); a symbol's own costs
    (the stage load and its end test) are at most one more a bit."""
    return 8 * bits


def fgk_bound(nbytes: int, bits: int) -> dict:
    """The bound of an FGK kernel call."""
    bound, by = bound_of(nbytes, fgk_ops(bits))
    return {"bound_ms": bound, "bound_by": by}


def fgk_stress(K, dev) -> None:
    """The FGK stress pass: for each of ``FGK_STRESS_SEEDS`` seeds, the
    successor streams of ``edge_cases.fgk_successor_streams`` (MNP-5 coded
    by the host runtime, as v1 codes them) and the FGK edge rows in one
    batch, through the package's kernels: the round trip exact, and every
    successor stream's words equal to the host runtime's v1 body. Any
    mismatch fails the run."""
    from huffman_codec_tpu_torch.edge_cases import (fgk_edge_rows,
                                                    fgk_successor_streams)
    from huffman_codec_tpu_torch.native import runtime
    from huffman_codec_tpu_torch.ops.fgk import n_words_for
    from huffman_codec_tpu_torch.ops.pack import chunk_bytes

    bad = {"round trip": 0, "vs host v1": 0}
    n_rows = n_streams = 0
    t0 = time.perf_counter()
    for seed in range(FGK_STRESS_SEEDS):
        streams = [s for v in fgk_successor_streams(seed).values()
                   for s in v]
        coded = [runtime.rle_encode(s.tobytes()) for s in streams]
        er, el = fgk_edge_rows(2100, seed)
        n = max(max(len(c) for c in coded), er.shape[1])
        rows = np.zeros((len(coded) + len(el), n), np.uint8)
        for i, cd in enumerate(coded):
            rows[i, :len(cd)] = np.frombuffer(cd, np.uint8)
        rows[len(coded):, :er.shape[1]] = er
        lens = np.r_[[len(cd) for cd in coded], el].astype(np.int32)
        xr, ln = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
        C, nw = xr.shape[0], n_words_for(n)
        w, b = K.fgk_encode(xr, ln, nw)
        d = K.fgk_decode(w, ln, n)
        torch.cuda.synchronize()
        valid = torch.arange(n, device=dev)[None, :] < ln[:, None]
        bad["round trip"] += int((d != torch.where(valid, xr, 0)).any(1)
                                 .sum())
        for i, st in enumerate(streams):
            body = runtime.v1_compress(st.tobytes())[9:]
            got = chunk_bytes(w[i:i + 1], b[i:i + 1]).cpu().numpy().tobytes()
            bad["vs host v1"] += got != body
        n_rows += C
        n_streams += len(streams)
    n_bad = sum(bad.values())
    log(f"fgk stress: {FGK_STRESS_SEEDS} seeds, {n_rows} rows ({n_streams} "
        f"successor streams, the rest FGK edge rows), the package's kernels' "
        f"round trips and the host runtime's v1 encoder: {n_bad} mismatches "
        f"{bad} "
        f"({time.perf_counter() - t0:.1f} s)")
    if n_bad:
        raise AssertionError(f"fgk stress: {n_bad} mismatches {bad}")


def fgk_path(K, TorchCodec, V1Codec, CodecConfig, x, errs):
    """FGK entropy in every layout and the device V1Codec: the two FGK
    kernels against their plain versions and a second oracle (the host
    runtime's v1 encoder, in the stress pass too), counted round trips,
    containers against the CPU plain path, timings. Returns (the launch counts of the sharded FGK
    round trips, the kernels' rows, the launch counts of V1Codec's four
    configs)."""
    from huffman_codec_tpu_torch.edge_cases import fgk_deep_row, fgk_edge_rows
    from huffman_codec_tpu_torch.models.chunked import encode_sharded_stage
    from huffman_codec_tpu_torch.models.entropy import lookup
    from huffman_codec_tpu_torch.models.pipeline import Transfers
    from huffman_codec_tpu_torch.native import runtime
    from huffman_codec_tpu_torch.ops.fgk import n_words_for
    from huffman_codec_tpu_torch.ops.pack import chunk_bytes
    from huffman_codec_tpu_torch.ops.rle import rle_max_encoded_len

    dev = torch.device("cuda")
    cap = rle_max_encoded_len(CS)
    n_in = x.size
    step = torch.from_numpy(x[: STEP * CS].copy()).to(dev).view(STEP, CS)
    full = torch.full((STEP,), CS, dtype=torch.int32, device=dev)
    car = torch.cat([torch.zeros(1, dtype=torch.uint8, device=dev),
                     step[:-1, -1]])

    # -- kernels against their plain versions: the step's RLE streams (diff
    #    on) cut to 2048 symbols, and the edge batch, in one call ----------
    W = 2100
    st, rl = K.rle_diff_encode(step, full, car, True, cap)
    ex, el = (torch.from_numpy(a).to(dev) for a in fgk_edge_rows(W, 71))
    rows = torch.cat([st[:, :W], ex]).contiguous()
    lens = torch.cat([rl.clamp(max=FGK_PLAIN_SYMBOLS), el]).to(torch.int32)
    nw = n_words_for(W)
    w, b = K.fgk_encode(rows, lens, nw)
    t = time.perf_counter()
    pw, pb = K.fgk_encode_plain(rows, lens, nw)
    torch.cuda.synchronize()
    plain_enc_ms = (time.perf_counter() - t) * 1e3
    same("fgk_encode.bits", b, pb, errs)
    same("fgk_encode.words", w, pw, errs)
    d = K.fgk_decode(w, lens, W)
    t = time.perf_counter()
    pd = K.fgk_decode_plain(w, lens, W)
    torch.cuda.synchronize()
    plain_dec_ms = (time.perf_counter() - t) * 1e3
    same("fgk_decode", d, pd, errs)
    valid = torch.arange(W, device=dev)[None, :] < lens[:, None]
    same("fgk_decode.round_trip", d, torch.where(valid, rows, 0), errs)
    red_enc_ms = cuda_ms(lambda: K.fgk_encode(rows, lens, nw), reps=3,
                         warm=1)
    red_dec_ms = cuda_ms(lambda: K.fgk_decode(w, lens, W), reps=3, warm=1)
    log(f"fgk kernels vs plain on {STEP} RLE streams (diff on) cut to "
        f"{FGK_PLAIN_SYMBOLS} symbols and {len(el)} edge rows: equal "
        f"(plain encode {plain_enc_ms:.0f} ms, decode {plain_dec_ms:.0f} ms; "
        f"kernels {red_enc_ms:.3f} / {red_dec_ms:.3f} ms)")
    # codes past 32 bits: the deep row against the host runtime's v1
    deep = fgk_deep_row(72)
    dx = torch.from_numpy(deep).to(dev)[None, :]
    dl = torch.tensor([deep.size], dtype=torch.int32, device=dev)
    dw, db = K.fgk_encode(dx, dl, n_words_for(deep.size))
    v1 = runtime.v1_compress(deep.tobytes())
    same("fgk_encode.deep_vs_v1", chunk_bytes(dw, db).cpu(),
         torch.frombuffer(bytearray(v1[9:]), dtype=torch.uint8), errs)
    same("fgk_decode.deep", K.fgk_decode(dw, dl, deep.size), dx, errs)
    log(f"fgk deep row ({deep.size} symbols, fresh codes of 33 bits): "
        "kernel stream == host runtime's v1 body, decodes exactly")
    del rows, w, pw, d, pd, st
    fgk_stress(K, dev)

    # -- a full step against the host runtime's v1 encoder, diff off and on.
    #    RLE restarts every chunk, so a chunk's FGK stream is the v1 body of
    #    its bytes (with diff: its diffed bytes, the carry applied, coded
    #    with the v1 diff flag off), and its rle_len that blob's count ----
    flat = step.reshape(-1)
    xs = x[: STEP * CS]
    dxs = xs.copy()
    dxs[1:] -= xs[:-1]  # uint8 wraps; chunk c's carry is chunk c - 1's end

    def v1_oracle(src):
        body, counts = [], []
        for c in range(STEP):
            v1 = runtime.v1_compress(src[c * CS:(c + 1) * CS].tobytes())
            body.append(v1[9:])
            counts.append(int.from_bytes(v1[:8], "little"))
        return (torch.frombuffer(bytearray(b"".join(body)), dtype=torch.uint8),
                torch.tensor(counts, dtype=torch.int32))

    fgk, xf = lookup("fgk"), Transfers(dev)

    def strip(words, bits):  # FGK's payload wave: the streams' bytes
        return fgk.payloads(xf, [words], [bits], [None])[0][0]

    words, bits, _, rl0, _ = encode_sharded_stage(
        flat, STEP * CS, 0, False, CS, STEP, LANE, fgk)
    want_pay, want_rl = v1_oracle(xs)
    same("fgk_encode.full_step_vs_v1", strip(words, bits).cpu(), want_pay,
         errs)
    same("fgk_encode.full_step_rle_len_vs_v1", rl0.cpu(), want_rl, errs)
    st0, rls = K.rle_diff_encode(step, full, car, True, cap)
    n_words = n_words_for(cap)
    enc_ms = cuda_ms(lambda: K.fgk_encode(st0, rls, n_words), reps=3, warm=1)
    fw, fb = K.fgk_encode(st0, rls, n_words)
    want_pay, want_rl = v1_oracle(dxs)
    same("fgk_encode.full_step_diff_vs_v1", chunk_bytes(fw, fb).cpu(),
         want_pay, errs)
    same("fgk_encode.full_step_diff_rle_len_vs_v1", rls.cpu(), want_rl, errs)
    sum_bits, max_bits = int(fb.sum()), int(fb.max())
    sum_rl = int(rls.sum())
    enc_bound = fgk_bound(sum_rl + 4 * STEP + 4 * STEP * n_words + 4 * STEP,
                          sum_bits)
    # the plain loop runs once a symbol of the longest row for the whole
    # batch: its time at the full step, from the reduced run's rate
    plain_full_s = (plain_enc_ms + plain_dec_ms) / int(lens.max()) * \
        int(rls.max()) / 1e3
    log(f"fgk full step ({STEP} x {CS} B), diff off and on: every chunk's "
        f"stream and rle_len == the host runtime's v1_compress of its "
        f"(diffed) bytes; fgk_encode {enc_ms:.3f} ms a step (diff on, "
        f"{sum_rl} symbols, {sum_bits} bits), bound "
        f"{enc_bound['bound_ms']:.4f} ms by {enc_bound['bound_by']} "
        f"({max_bits} bits in the longest chunk); the plain loop would take "
        f"about {plain_full_s:.0f} s for one encode and decode of it "
        f"({int(rls.max())} symbols in the longest chunk)")
    # the same step without diff: about 2.6 times the code bits, so the two
    # times split a tree level's cost from a symbol's
    st1, rl1 = K.rle_diff_encode(step, full, car, False, cap)
    off_ms = cuda_ms(lambda: K.fgk_encode(st1, rl1, n_words), reps=3, warm=1)
    off_bits = int(K.fgk_encode(st1, rl1, n_words)[1].sum())
    log(f"fgk_encode without diff {off_ms:.3f} ms a step ({int(rl1.sum())} "
        f"symbols, {off_bits} bits)")
    # the decoder's oracle at the main path's shapes: the step's RLE streams
    valid = torch.arange(cap, device=dev)[None, :]
    streams = {False: torch.where(valid < rl1[:, None], st1, 0),
               True: torch.where(valid < rls[:, None], st0, 0)}
    del fw, st0, st1, words, flat, valid

    # -- counted round trips: sharded FGK at 64 MiB, diff off and on --------
    n_rt = n_in if enc_ms < 10_000 else STEP * CS
    data = x[:n_rt].tobytes()
    cfgs = {d: CodecConfig(use_diff=d, chunk_size=CS, lane=LANE,
                           layout="sharded", step_chunks=STEP,
                           entropy="fgk") for d in (False, True)}
    blobs, times = {}, {}
    K.reset_launches()
    for dd, cfg in cfgs.items():
        codec = TorchCodec(cfg)
        t = time.perf_counter()
        blobs[dd] = codec.encode(data)
        e2e_enc = time.perf_counter() - t
        t = time.perf_counter()
        if codec.decode(blobs[dd]) != data:
            raise AssertionError(f"fgk sharded round trip failed (diff={dd})")
        times[dd] = (e2e_enc, time.perf_counter() - t)
    launches = K.launch_counts()
    log(f"fgk sharded launches (two {n_rt} B round trips):", launches)
    for name in ("fgk_encode", "fgk_decode", "rle_diff_encode",
                 "rle_expand"):
        if not launches[name]:
            raise AssertionError(f"{name} was never launched on the sharded "
                                 f"FGK path: {launches}")
    for dd, blob in blobs.items():
        log(f"fgk sharded {n_rt} B diff={dd}: {len(blob)} B, "
            f"{8 * len(blob) / n_rt:.4f} bpc, round trip exact, crc ok; end "
            f"to end encode {times[dd][0]:.3f} s, decode {times[dd][1]:.3f} s")

    # -- device throughput, inputs resident; the decode kernel's time --------
    xd = torch.from_numpy(x[:n_rt].copy()).to(dev)
    codec = TorchCodec(cfgs[True])

    def enc():
        outs = []
        for k in range(n_rt // (STEP * CS)):
            seg = xd[k * STEP * CS:(k + 1) * STEP * CS]
            carry = int(x[k * STEP * CS - 1]) if k else 0
            a, meta, _, _, _ = encode_sharded_stage(
                seg, STEP * CS, carry, True, CS, STEP, LANE, fgk)
            outs.append(strip(a, meta))
        return outs
    dev_enc_ms = median_ms(enc, reps=3)
    hdr, staged = codec.stage_decode_steps(blobs[True])
    torch.cuda.synchronize()
    dev_dec_ms = median_ms(lambda: codec.run_decode_steps(hdr, staged),
                           reps=3)
    s0 = staged[0]
    dec_ms = cuda_ms(lambda: K.fgk_decode(s0["words"], s0["rl"], cap),
                     reps=3, warm=1)
    dbits = hdr["chunk_bits"][:STEP]
    dec_bound = fgk_bound(s0["words"].numel() * 4 + 4 * STEP + STEP * cap,
                          int(sum(dbits)))
    # the decoder at the main path's shapes (the first step's staged word
    # rows) against the step's RLE streams, diff on and off
    same("fgk_decode.full_step_diff",
         K.fgk_decode(s0["words"], s0["rl"], cap), streams[True], errs)
    s_off = TorchCodec(cfgs[False]).stage_decode_steps(blobs[False])[1][0]
    same("fgk_decode.full_step", K.fgk_decode(s_off["words"], s_off["rl"],
                                              cap), streams[False], errs)
    log(f"fgk_decode at the main path's shapes (words "
        f"{tuple(s0['words'].shape)} and {tuple(s_off['words'].shape)}): "
        "== the step's RLE streams, diff on and off")
    log(f"fgk device diff=True: encode {n_rt / dev_enc_ms / 1e3:.2f} MB/s "
        f"({dev_enc_ms:.1f} ms / {n_rt} B), decode "
        f"{n_rt / dev_dec_ms / 1e3:.2f} MB/s ({dev_dec_ms:.1f} ms); "
        f"fgk_decode {dec_ms:.3f} ms a step (words {tuple(s0['words'].shape)}"
        f"), bound {dec_bound['bound_ms']:.4f} ms by {dec_bound['bound_by']}")
    del xd, staged, s0, s_off, streams

    # -- global FGK at 256 KiB and 2.5 MiB; sharded-adaptive FGK on 16 bands
    #    and a 5-row tail ---------------------------------------------------
    K.reset_launches()
    for n, dd in ((1 << 18, True), (5 << 19, True), (5 << 19, False)):
        gdata = x[:n].tobytes()
        gc = TorchCodec(CodecConfig(use_diff=dd, entropy="fgk"))
        t = time.perf_counter()
        blob = gc.encode(gdata)
        e2e = time.perf_counter() - t
        v3 = blob if blob[:6] == b"HCTPU\x03" else gc._encode_global(
            gdata, None, False)
        for bl in {blob, v3}:
            if gc.decode(bl) != gdata:
                raise AssertionError(f"fgk global round trip failed ({n} B)")
        log(f"fgk global {n} B diff={dd}: encode() kept "
            f"{'v3' if blob == v3 else 'v1'} ({len(blob)} B; v3 {len(v3)} B, "
            f"{gc._parse(v3)['n_chunks']} chunks), round trips exact; end to "
            f"end encode {e2e:.3f} s")
    acfg = CodecConfig(use_adapt=True, use_diff=True, width=ADAPT_W,
                       chunk_size=CS, layout="sharded", entropy="fgk")
    n_tail = 16 * CS + 5 * ADAPT_W
    tail = x[:n_tail].tobytes()
    ac = TorchCodec(acfg)
    ablob = ac.encode(tail)
    if ac.decode(ablob) != tail:
        raise AssertionError("fgk sharded-adaptive round trip failed")
    if ac.decode_range(ablob, 15 * CS + 100, CS + 2000) != \
            tail[15 * CS + 100:16 * CS + 2100]:
        raise AssertionError("fgk sharded-adaptive decode_range differs")
    glaunches = K.launch_counts()
    if not (glaunches["fgk_encode"] and glaunches["fgk_decode"]):
        raise AssertionError(f"fgk kernels not launched on the global and "
                             f"adaptive paths: {glaunches}")
    log(f"fgk sharded adaptive {n_tail} B (16 bands + a 5-row tail): "
        f"{len(ablob)} B, round trip and a range across a band border "
        f"exact; global and adaptive launches {glaunches}")

    # -- V1Codec on 256 KiB in the four pipeline configs --------------------
    vdata = x[: 1 << 18].tobytes()
    K.reset_launches()
    for dd, aa in ((False, False), (True, False), (False, True),
                   (True, True)):
        vc = V1Codec(CodecConfig(use_diff=dd, use_adapt=aa, width=ADAPT_W))
        t = time.perf_counter()
        vb = vc.encode(vdata)
        e2e = time.perf_counter() - t
        if vb != runtime.v1_compress(vdata, dd, aa, ADAPT_W):
            raise AssertionError(f"V1Codec differs from the host runtime "
                                 f"(diff={dd}, adapt={aa})")
        t = time.perf_counter()
        got = vc.decode(vb)
        dev_dec = time.perf_counter() - t
        t = time.perf_counter()
        host = runtime.v1_decompress(vb)
        host_dec = time.perf_counter() - t
        if got != vdata or host != vdata:
            raise AssertionError(f"V1Codec round trip failed (diff={dd}, "
                                 f"adapt={aa})")
        log(f"V1Codec 256 KiB diff={dd} adapt={aa}: {len(vb)} B == host "
            f"runtime's v1_compress, device decode exact; end to end encode "
            f"{e2e:.3f} s, decode {dev_dec:.3f} s (the host runtime's "
            f"v1_decompress, the oracle: {host_dec:.3f} s)")
    vl = K.launch_counts()
    if not (vl["fgk_encode"] and vl["fgk_decode"]
            and vl["group_tile_lens"]):
        raise AssertionError(f"V1Codec did not launch its kernels: {vl}")

    # -- containers equal the CPU plain path on small inputs ----------------
    small = {
        "sharded": (CodecConfig(layout="sharded", chunk_size=2048,
                                use_diff=True, entropy="fgk"), x[:6000]),
        "global": (CodecConfig(chunk_size=2048, use_diff=True,
                               entropy="fgk"), x[:6000]),
        "sharded-adapt": (CodecConfig(use_adapt=True, width=64,
                                      chunk_size=1024, layout="sharded",
                                      entropy="fgk"), x[:64 * 80]),
    }
    for name, (cfg, arr) in small.items():
        sd = arr.tobytes()
        gpu, cpu = TorchCodec(cfg), TorchCodec(cfg, device="cpu")
        if cfg.layout == "global":
            g, c = (k._encode_global(sd, None, False) for k in (gpu, cpu))
        else:
            g, c = gpu.encode(sd), cpu.encode(sd)
        if g != c or gpu.decode(c) != sd:
            raise AssertionError(f"fgk {name}: GPU container differs from "
                                 "the CPU plain path")
    log("fgk containers (sharded, global, sharded adaptive) on small "
        "inputs: GPU == CPU plain path")

    rows_out = [
        {"name": "fgk_encode", "route": "cuda",
         "source": "huffman_codec_tpu_torch/csrc/fgk.cu",
         "replaces": "huffman_codec_tpu/ops/fgk.py:239 (an XLA scan)",
         "launches": launches["fgk_encode"], "ms": enc_ms,
         "plain_ms": plain_enc_ms, "library_ms": None,
         "plain_and_reduced_at": f"{STEP} chunks of {FGK_PLAIN_SYMBOLS} "
                                 f"symbols and {len(el)} edge rows",
         "reduced_ms": red_enc_ms, "no_diff_ms": off_ms, **enc_bound},
        {"name": "fgk_decode", "route": "cuda",
         "source": "huffman_codec_tpu_torch/csrc/fgk.cu",
         "replaces": "huffman_codec_tpu/ops/fgk.py:305 (an XLA scan)",
         "launches": launches["fgk_decode"], "ms": dec_ms,
         "plain_ms": plain_dec_ms, "library_ms": None,
         "plain_and_reduced_at": f"{STEP} chunks of {FGK_PLAIN_SYMBOLS} "
                                 f"symbols and {len(el)} edge rows",
         "reduced_ms": red_dec_ms, **dec_bound},
    ]
    return launches, rows_out, vl


# the kernels of the sharded chain (1-6), which the CLI's v3 runs launch,
# and those its v1 runs on the default backend (torch) launch
SHARDED_CHAIN = ("rle_diff_encode", "histogram256", "lane_pack",
                 "repad_words", "lane_decode", "rle_expand")
V1_DEVICE = ("fgk_encode", "fgk_decode", "group_tile_lens", "rle_expand")


def run_cli(cli, argv, device=None):
    """``cli.main(argv)`` in this process: (exit code, stderr text,
    seconds from call to return, file I/O included)."""
    err = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv, device=device)
    return rc, err.getvalue(), time.perf_counter() - t


def _union_us(events) -> float:
    """Microseconds covered by the union of the events' intervals."""
    busy, end = 0.0, float("-inf")
    for s, d in sorted((e["ts"], e["dur"]) for e in events):
        if s + d > end:
            busy += s + d - max(s, end)
            end = s + d
    return busy


def busy_share(trace: Path) -> dict:
    """From a Chrome trace of ``torch.profiler``: the window the trace
    spans (first event's start to last event's end), the union of the
    CUDA kernels' intervals over it, the same with the copies and sets
    added, the idle share (1 - the share of kernels or copies), and the
    five kernels that took the most device time."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    kern = [e for e in events if e.get("cat") == "kernel"]
    if not kern:
        raise AssertionError("the profiler trace holds no CUDA kernel "
                             "events")
    copies = [e for e in events
              if e.get("cat") in ("gpu_memcpy", "gpu_memset")]
    t0 = min(e["ts"] for e in events)
    window = max(e["ts"] + e["dur"] for e in events) - t0
    busy = _union_us(kern)
    by_name: dict = {}
    for e in kern:
        n = by_name.setdefault(e["name"], [0.0, 0])
        n[0] += e["dur"]
        n[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"window_ms": window / 1e3, "kernel_busy_ms": busy / 1e3,
            "busy_share": busy / window, "kernel_events": len(kern),
            "copy_and_set_ms": sum(e["dur"] for e in copies) / 1e3,
            "with_copies_share": _union_us(kern + copies) / window,
            "idle_share": 1 - _union_us(kern + copies) / window,
            "top5": [{"name": k[:80], "ms": v[0] / 1e3, "launches": v[1]}
                     for k, v in top]}


def cli_path(K, TorchCodec, CodecConfig, x) -> dict:
    """The command line on the card, device left at its default: the
    64 MiB sharded input through ``cli.main`` (-c, then -d) against
    ``TorchCodec``, v1's default backend (``torch``) against the host
    runtime on 256 KiB in the four pipeline configs and on the three
    broken adaptive blobs,
    ``python -m huffman_codec_tpu_torch`` in a subprocess, ``--dump-tables``
    against the CPU plain path; then a 64 MiB sharded encode and decode
    traced with ``utils.profiling.device_trace`` and the device's busy
    share read from the trace. Returns the launch counts of the counted
    CLI runs."""
    from huffman_codec_tpu_torch import cli
    from huffman_codec_tpu_torch.edge_cases import broken_adapt_v1_blobs

    tmp = Path(tempfile.mkdtemp(prefix="hctpu-cli-"))  # outside the repo
    try:
        data = x.tobytes()
        f = tmp / "in.raw"
        f.write_bytes(data)
        enc_argv = ["-c", "-m", "--format=v3", "--layout=sharded"]

        # -- v3 sharded at full size, launches counted ----------------------
        K.reset_launches()
        rc, err, enc_s = run_cli(cli, [*enc_argv, "--stats", "-i", str(f),
                                       "-o", str(tmp / "out.v3")])
        if rc:
            raise AssertionError(f"cli -c exit {rc}: {err}")
        stats = [ln for ln in err.splitlines() if ln.startswith("{")][-1]
        rc, err, dec_s = run_cli(cli, ["-d", "--format=v3", "-i",
                                       str(tmp / "out.v3"), "-o",
                                       str(tmp / "dec.raw")])
        if rc:
            raise AssertionError(f"cli -d exit {rc}: {err}")
        v3 = K.launch_counts()
        if not all(v3[k] for k in SHARDED_CHAIN):
            raise AssertionError(f"the CLI's v3 runs did not launch every "
                                 f"kernel of the sharded chain: {v3}")
        blob = (tmp / "out.v3").read_bytes()
        if (tmp / "dec.raw").read_bytes() != data:
            raise AssertionError("cli -d did not restore the 64 MiB input")
        if blob != TorchCodec(CodecConfig(use_diff=True,
                                          layout="sharded")).encode(data):
            raise AssertionError("the CLI's container differs from "
                                 "TorchCodec's")
        again = [run_cli(cli, [*enc_argv, "-i", str(f), "-o",
                               str(tmp / "out2.v3")])[2],
                 run_cli(cli, ["-d", "--format=v3", "-i", str(tmp / "out2.v3"),
                               "-o", str(tmp / "dec2.raw")])[2]]
        log(f"cli --stats: {stats}")
        log(f"cli 64 MiB sharded -m, end to end with file I/O: encode "
            f"{enc_s:.4f} s then {again[0]:.4f} s, decode {dec_s:.4f} s "
            f"then {again[1]:.4f} s; container == TorchCodec's, decode "
            f"exact; launches {v3}")

        # -- v1 on the card: the default backend (torch) against native ----
        v1 = tmp / "v1.raw"
        v1.write_bytes(data[: 1 << 18])
        for flags in ([], ["-m"], ["-a", "-w", "512"], ["-a", "-m"]):
            outs, times = {}, {}
            for backend, pick in (("torch", []),
                                  ("native", ["--backend=native"])):
                outs[backend] = tmp / f"v1.{backend}"
                rc, err, times[backend] = run_cli(
                    cli, ["-c", *flags, *pick, "-i",
                          str(v1), "-o", str(outs[backend])])
                if rc:
                    raise AssertionError(f"cli v1 {flags} {backend}: {err}")
            if outs["torch"].read_bytes() != outs["native"].read_bytes():
                raise AssertionError(f"v1 default (torch) {flags} differs from "
                                     "native")
            rc, err, d_s = run_cli(cli, ["-d", "-i",
                                         str(outs["torch"]), "-o",
                                         str(tmp / "v1.dec")])
            if rc or (tmp / "v1.dec").read_bytes() != data[: 1 << 18]:
                raise AssertionError(f"v1 default (torch) -d {flags}: {err}")
            log(f"cli v1 default (torch) 256 KiB "
                f"{' '.join(flags) or '(none)'}: "
                f"== native; encode {times['torch']:.3f} s (native "
                f"{times['native']:.3f} s), device decode {d_s:.3f} s")
        counts = K.launch_counts()
        if not all(counts[k] > v3[k] for k in V1_DEVICE):
            raise AssertionError(f"v1's default backend did not launch its "
                                 f"kernels: {counts}")
        for code, (blob, message) in broken_adapt_v1_blobs().items():
            bad = tmp / f"bad{code}.v1"
            bad.write_bytes(blob)
            got = run_cli(cli, ["-d", "-i", str(bad),
                                "-o", str(tmp / "bad.out")])[:2]
            want = run_cli(cli, ["-d", "--backend=native", "-i", str(bad),
                                 "-o", str(tmp / "bad.out")])[:2]
            if got != want or got != (code, f"ERROR: {message}\n"):
                raise AssertionError(f"broken blob {code}: torch {got}, "
                                     f"native {want}")
            log(f"cli v1 default (torch) on the broken blob {code}: exit "
                f"{got[0]}, {got[1].strip()!r} == native")

        # -- the module entry, a process of its own, on the card -----------
        part = tmp / "in16.raw"
        part.write_bytes(data[: 16 << 20])
        rc, err, _ = run_cli(cli, [*enc_argv, "-i", str(part), "-o",
                                   str(tmp / "in16.v3")])
        if rc:
            raise AssertionError(f"cli 16 MiB: {err}")
        root = Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=str(root))
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "huffman_codec_tpu_torch",
                            *enc_argv, "-i", str(part), "-o",
                            str(tmp / "sub.v3")], cwd=root, env=env,
                           capture_output=True, text=True, timeout=300)
        sub_s = time.perf_counter() - t
        if r.returncode or (tmp / "sub.v3").read_bytes() != (
                tmp / "in16.v3").read_bytes():
            raise AssertionError(f"python -m huffman_codec_tpu_torch: exit "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
        log(f"python -m huffman_codec_tpu_torch on 16 MiB: exit 0, the "
            f"in-process bytes, {sub_s:.1f} s with the interpreter's start")

        # -- --dump-tables on the card against the CPU plain path ----------
        small = tmp / "small.raw"
        small.write_bytes(data[:20000])
        for argv in (["-c", "-m", "--format=v3", "--layout=sharded",
                      "--chunk-size=4096"], ["-c", "-m", "--backend=torch"]):
            full = [*argv, "--dump-tables", "-i", str(small), "-o",
                    str(tmp / "small.out")]
            gpu, cpu = run_cli(cli, full)[:2], run_cli(cli, full, "cpu")[:2]
            if gpu != cpu or gpu[0]:
                raise AssertionError(f"--dump-tables {argv}: the card's "
                                     "text differs from the CPU's")
        log("cli --dump-tables (v3 canonical, v1): the card's text == the "
            "CPU plain path's")

        # -- the profiler: the device's busy share of a 64 MiB round trip --
        codec = TorchCodec(CodecConfig(use_diff=True, layout="sharded"))
        t = time.perf_counter()
        with device_trace(str(tmp / "trace")) as path:
            rt = codec.decode(codec.encode(data))
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t
        if rt != data:
            raise AssertionError("traced round trip failed")
        share = busy_share(path)
        log(f"profiler: 64 MiB sharded -m encode + decode traced in "
            f"{traced_s:.3f} s (export included); trace window "
            f"{share['window_ms']:.3f} ms, CUDA kernels busy "
            f"{share['kernel_busy_ms']:.3f} ms = "
            f"{100 * share['busy_share']:.2f}% of it, "
            f"{share['kernel_events']} kernel events; copies and sets "
            f"{share['copy_and_set_ms']:.3f} ms; kernels or copies busy "
            f"{100 * share['with_copies_share']:.2f}%, so the device idles "
            f"{100 * share['idle_share']:.2f}%")
        log("profiler top 5 kernels: " + json.dumps(share["top5"]))
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# -- the multi-GPU layer (parallel/) -----------------------------------------

MESH_WIDTH, MESH_BAND_H = 512, 128  # the sharded-adaptive cell's geometry
MESH_RANK_TIMEOUT = 180  # seconds a rank of the multi-process check may take
MESH_TAIL = 12345  # bytes the multi-process check's input falls short of
# the kernels the mesh's main path launches (kernel 4 is not among them:
# the mesh decode takes the lanes padded; kernel 7 serves fat lanes only)
MESH_KERNELS = ("rle_diff_encode", "rle_diff_encode_tile", "histogram256",
                "lane_pack", "lane_decode", "rle_expand", "fgk_encode",
                "fgk_decode")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def mesh_run(M, mesh, data: torch.Tensor, length: int, bs=None):
    """Drive the five step functions of ``parallel.mesh`` once on one
    input (the global array, on any device): the stream encode and decode,
    canonical with the diff model on and off and FGK with it; the
    adaptive search, the encode at ``bs`` (the search's pick when None)
    and its decode, in bands of the sharded-adaptive cell. Returns
    ({output name: tensor}, the block size)."""
    from huffman_codec_tpu_torch.models.entropy import lookup
    from huffman_codec_tpu_torch.ops.adapt import candidate_sizes
    from huffman_codec_tpu_torch.ops.fgk import n_words_for

    out = {}
    for key, diff, ent in (("canonical", True, "canonical"),
                           ("canonical-nodiff", False, "canonical"),
                           ("fgk", True, "fgk")):
        nw = n_words_for(lookup(ent).cap(CS, LANE))
        a, meta, tab, rl, car = M.distributed_encode_step(
            data, length, mesh, CS, nw, diff, ent, LANE)
        out.update({f"{key}.a": a, f"{key}.meta": meta,
                    f"{key}.rle_lens": rl, f"{key}.carries": car})
        if tab is not None:
            out[f"{key}.tables"] = tab
        out[f"{key}.decoded"] = M.distributed_decode_step(
            a.view(a.shape[0], -1), rl, car, mesh, CS, tab, meta, diff, ent,
            LANE)
    w, bh = MESH_WIDTH, MESH_BAND_H
    out["adapt.scores"] = M.distributed_adapt_search(data, mesh, w, bh)
    if bs is None:  # the first minimum wins
        bs = candidate_sizes(w, bh)[
            int(np.argmin(out["adapt.scores"].cpu().numpy()))]
    enc = M.distributed_adapt_encode_step(data, mesh, w, bh, bs, True,
                                          "canonical", LANE)
    out.update(zip(("adapt.a", "adapt.meta", "adapt.tables", "adapt.totals",
                    "adapt.dirs", "adapt.tile_lens", "adapt.carries"), enc))
    buf, lw, tab, totals, dirs, tl, car = enc
    out["adapt.decoded"] = M.distributed_adapt_decode_step(
        buf.view(buf.shape[0], -1), totals, tl, dirs, car, tab, lw, mesh, w,
        bh, bs, True, LANE)
    return out, bs


def mesh_plain(K, M, out: dict, xd: torch.Tensor, length: int, bs: int,
               errs: dict) -> None:
    """Hold ``mesh_run``'s encode outputs on the input ``xd`` (the first
    ``length`` bytes valid) to the plain versions of the kernels that made
    them, on the same rows: kernel 1, then 2 and 3, for the canonical
    steps (diff on and off); kernel 1b, then 2 and 3, for the adaptive
    step at block size ``bs``; the FGK step (diff on) against the host
    runtime's v1 encoder a chunk at a time, as ``fgk_path`` holds it (the
    plain FGK loop runs once a symbol: far too slow at this size).
    Tolerance 0: integer codec."""
    from huffman_codec_tpu_torch.models.chunked import _band_winner_order
    from huffman_codec_tpu_torch.models.entropy import CANONICAL
    from huffman_codec_tpu_torch.native import runtime
    from huffman_codec_tpu_torch.ops.canonical import (
        assign_codes, build_lengths_pm)
    from huffman_codec_tpu_torch.ops.diff import diff_apply
    from huffman_codec_tpu_torch.ops.pack import chunk_bytes

    dev = xd.device

    def pack(key, streams, lens):
        """Kernels 2 and 3 after the plain RLE: the step's tables, lane
        buffers and lane words."""
        counts = K.histogram256_plain(streams, lens)
        same(f"histogram256.mesh_{key}", K.histogram256(streams, lens),
             counts, errs)
        code_lens = build_lengths_pm(counts)
        same(f"histogram256.mesh_{key}_tables", out[f"{key}.tables"],
             code_lens.to(torch.uint8), errs)
        tables = (assign_codes(code_lens) | (code_lens << 26)).to(torch.int32)
        buf, bits = K.lane_pack_plain(streams, lens, tables, LANE)
        same(f"lane_pack.mesh_{key}", out[f"{key}.a"], buf, errs)
        same(f"lane_pack.mesh_{key}_words", out[f"{key}.meta"],
             ((bits + 31) >> 5).to(torch.int32), errs)

    C = xd.numel() // CS
    chunks = xd.view(C, CS)
    in_lens = (length - torch.arange(C, device=dev, dtype=torch.int64) * CS
               ).clamp(0, CS).to(torch.int32)
    car = torch.cat([chunks.new_zeros(1), chunks[:-1, -1]])
    cap = CANONICAL.cap(CS, LANE)
    for key, diff in (("canonical", True), ("canonical-nodiff", False)):
        st, rl = K.rle_diff_encode_plain(chunks, in_lens, car, diff, cap)
        same(f"rle_diff_encode.mesh_{key}_rle_lens", out[f"{key}.rle_lens"],
             rl, errs)
        same(f"rle_diff_encode.mesh_{key}_carries", out[f"{key}.carries"],
             car if diff else torch.zeros_like(car), errs)
        pack(key, st, rl)
        del st

    w, bh = MESH_WIDTH, MESH_BAND_H
    bands = xd.view(-1, w * bh)
    nb = bands.shape[0]
    acar = torch.cat([bands.new_zeros(1), bands[:-1, -1]])
    same(f"{K.TILE_MODE}.mesh_adapt_carries", out["adapt.carries"], acar,
         errs)
    win, dirs, tile_lens = _band_winner_order(diff_apply(bands, acar), w, bh,
                                              bs)
    same(f"{K.TILE_MODE}.mesh_adapt_dirs", out["adapt.dirs"], dirs, errs)
    same(f"{K.TILE_MODE}.mesh_adapt_tile_lens", out["adapt.tile_lens"],
         tile_lens, errs)
    st, tot = K.rle_diff_encode_plain(
        win, torch.full((nb,), w * bh, dtype=torch.int32, device=dev),
        torch.zeros(nb, dtype=torch.uint8, device=dev), False,
        CANONICAL.cap(w * bh, LANE), bs * bs)
    same(f"{K.TILE_MODE}.mesh_adapt_totals", out["adapt.totals"], tot, errs)
    pack("adapt", st, tot)
    del st, win

    # RLE restarts every chunk, so a chunk's FGK stream is the v1 body of
    # its diffed bytes (chunk c's carry is chunk c - 1's last byte)
    src = xd[:length].cpu().numpy()
    dx = src.copy()
    dx[1:] -= src[:-1]  # uint8 wraps
    body, counts = [], []
    for c in range(C):
        seg = dx[c * CS:(c + 1) * CS]
        v1 = runtime.v1_compress(seg.tobytes()) if seg.size else bytes(9)
        body.append(v1[9:])
        counts.append(int.from_bytes(v1[:8], "little"))
    same("fgk_encode.mesh_vs_v1",
         chunk_bytes(out["fgk.a"], out["fgk.meta"]).cpu(),
         torch.frombuffer(bytearray(b"".join(body)), dtype=torch.uint8), errs)
    same("fgk_encode.mesh_rle_lens_vs_v1", out["fgk.rle_lens"].cpu(),
         torch.tensor(counts, dtype=torch.int32), errs)
    same("fgk_encode.mesh_carries", out["fgk.carries"], car, errs)


def wire_payload(codec, kept, meta) -> bytes:
    """The wire bytes of a stage's payload as its coder keeps it
    (``entropy.keep``), through the coder's payload wave and wire format,
    as ``TorchCodec.fetch_sharded`` makes them."""
    ent = codec.entropy
    pays, landed = ent.payloads(codec._xfer, [kept], [meta], [meta.cpu()])
    codec._xfer.wait_host(landed)
    return ent.wire(pays[0])


def mesh_container(TorchCodec, CodecConfig, out: dict, key: str,
                   data: bytes, bs: int):
    """The v3 container assembled from the mesh outputs ``key`` of a whole
    input (no partial tail), the way ``TorchCodec.encode`` assembles its
    steps. Returns (the codec of that config, the container)."""
    adapt = key == "adapt"
    codec = TorchCodec(CodecConfig(
        use_diff=key != "canonical-nodiff", use_adapt=adapt,
        width=MESH_WIDTH, chunk_size=CS, lane=LANE,
        entropy="fgk" if key == "fgk" else "canonical", layout="sharded"))
    ent = codec.entropy
    meta = out[f"{key}.meta"]
    rl, car = (out[k].cpu().numpy() for k in (
        "adapt.totals" if adapt else f"{key}.rle_lens", f"{key}.carries"))
    cols = [out[k].cpu().numpy() for k in (f"{key}.meta", f"{key}.tables")
            if k in out]
    adapt_meta = (MESH_WIDTH, len(data) // MESH_WIDTH, bs,
                  out["adapt.dirs"].cpu().numpy().reshape(-1),
                  out["adapt.tile_lens"].cpu().numpy().reshape(-1),
                  False) if adapt else None
    blob = codec._container(
        wire_payload(codec, ent.keep(out[f"{key}.a"], meta), meta),
        len(data), int(rl.sum()), *ent.manifest(*cols), (rl, car),
        zlib.crc32(data), adapt_meta=adapt_meta)
    return codec, blob


def _mesh_rank(rank: int, world: int, port: int, backend: str, path: str,
               length: int, bs: int, q) -> None:
    """One rank of the multi-process mesh check, in a spawned process:
    ``mesh_run`` on the input file over a group of ``world`` ranks on
    ``backend``. Puts (rank, {output: sha256}, seconds, device) on ``q``,
    or (rank, None, the traceback, None) and exits non-zero."""
    os.environ["LOCAL_RANK"] = str(rank)  # one host: what torchrun sets
    try:
        import torch.distributed as dist

        from huffman_codec_tpu_torch.parallel import distributed as D
        from huffman_codec_tpu_torch.parallel import mesh as M

        t = time.perf_counter()
        if not D.init_distributed(f"localhost:{port}", world, rank,
                                  backend=backend):
            raise RuntimeError("init_distributed started no group")
        try:
            mesh = M.default_mesh(world)
            data = torch.from_numpy(np.fromfile(path, np.uint8))
            out, _ = mesh_run(M, mesh, data, length, bs)
            sums = {k: digest(v) for k, v in out.items()}
        finally:
            dist.destroy_process_group()
        q.put((rank, sums, time.perf_counter() - t, str(mesh.device)))
    except Exception:
        q.put((rank, None, traceback.format_exc(), None))
        raise


def mesh_ranks(K, M, mesh1, x: np.ndarray, errs: dict) -> None:
    """Two or more ranks, each a process of its own (spawned with
    ``torch.multiprocessing``): every rank's gathered outputs must equal
    world 1's on the same input (itself held to the plain versions by
    ``mesh_plain``), the adaptive search's scores the sum of
    each rank's block scored alone (they depend on the world size). One
    card: two ranks on it over gloo, at 16 MiB. Two or more cards: NCCL,
    a rank a card (up to 4), at 64 MiB. A rank that fails, hangs or
    differs fails the run."""
    from huffman_codec_tpu_torch.ops.adapt import (
        _adapt_score_v3, candidate_sizes)
    from huffman_codec_tpu_torch.ops.diff import diff_apply

    n_dev = torch.cuda.device_count()
    if n_dev >= 2:
        backend, world, n_in = "nccl", min(4, n_dev), len(x)
        why = f"{n_dev} cards: NCCL, one rank a card"
    else:
        backend, world, n_in = "gloo", 2, 16 << 20
        why = ("one card: NCCL takes one rank a device, so the phase "
               "chooses gloo, both ranks on cuda:0 (a check of the rank "
               "logic, not a scaling figure)")
    length = n_in - MESH_TAIL
    xd = torch.from_numpy(x[:n_in].copy()).to(mesh1.device)
    ref, bs = mesh_run(M, mesh1, xd, length)
    mesh_plain(K, M, ref, xd, length, bs, errs)
    want = {k: digest(v) for k, v in ref.items()}
    cs = MESH_WIDTH * MESH_BAND_H
    blocks = xd.view(world, -1)
    want["adapt.scores"] = digest(sum(
        torch.stack([_adapt_score_v3(diff_apply(b), MESH_WIDTH,
                                     b.numel() // MESH_WIDTH, c)
                     for c in candidate_sizes(MESH_WIDTH, MESH_BAND_H)])
        for b in blocks).to(torch.int32))
    del ref, xd, blocks
    tmp = Path(tempfile.mkdtemp(prefix="hctpu-mesh-"))  # outside the repo
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = []
    try:
        path = tmp / "in.raw"
        x[:n_in].tofile(path)
        port = free_port()
        t = time.perf_counter()
        procs = [ctx.Process(target=_mesh_rank,
                             args=(r, world, port, backend, str(path),
                                   length, bs, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        for _ in range(world):
            try:
                r, sums, info, dev = q.get(timeout=MESH_RANK_TIMEOUT)
            except queue.Empty:
                raise AssertionError(f"mesh: a rank gave no result within "
                                     f"{MESH_RANK_TIMEOUT} s") from None
            if sums is None:
                raise AssertionError(f"mesh: rank {r} failed:\n{info}")
            got[r] = (sums, info, dev)
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"mesh: a rank exited {p.exitcode}")
        wall = time.perf_counter() - t
        for r, (sums, _, _) in got.items():
            bad = sorted(k for k in want.keys() | sums.keys()
                         if sums.get(k) != want.get(k))
            if bad:
                raise AssertionError(f"mesh: rank {r} of {world} differs "
                                     f"from world 1 in {bad}")
        log(f"mesh {world} ranks on {backend} ({why}): {n_in} B, "
            f"{n_in // CS} chunks, the input {MESH_TAIL} B short; "
            f"{len(want)} gathered outputs on every rank == world 1's "
            f"(the search's scores == each block scored alone, summed; bs "
            f"{bs}); ranks on " + ", ".join(
                f"{got[r][2]} {got[r][1]:.2f} s" for r in sorted(got))
            + f" (start to result); {wall:.1f} s with the spawn")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)


def mesh_path(K, TorchCodec, CodecConfig, x: np.ndarray, errs: dict) -> dict:
    """The multi-GPU layer on the card. (a) World 1 on NCCL in this
    process: the 64 MiB main path through the five step functions
    (``mesh_run``), launches counted from zero; the encode outputs held to
    the kernels' plain versions on the same rows (``mesh_plain``); the
    containers assembled
    from the outputs equal ``TorchCodec.encode``'s (diff on: canonical,
    FGK and sharded adaptive; without diff the mesh's carries are zero,
    as JAX's are, so that container is decoded only), every decode
    returns the input; each step timed beside the single-process stage
    on the same 1024 chunks. (b) ``mesh_ranks``. Returns (a)'s launch
    counts."""
    import torch.distributed as dist

    from huffman_codec_tpu_torch.models.chunked import encode_sharded_stage
    from huffman_codec_tpu_torch.parallel import mesh as M

    dist.init_process_group("nccl", world_size=1, rank=0,
                            init_method=f"tcp://localhost:{free_port()}")
    try:
        mesh = M.default_mesh(1)
        data = x.tobytes()
        n = len(data)
        xd = torch.from_numpy(x).to(mesh.device)
        torch.cuda.synchronize()
        K.reset_launches()
        out, bs = mesh_run(M, mesh, xd, n)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        missing = [k for k in MESH_KERNELS if not launches[k]]
        if missing:
            raise AssertionError(f"mesh: {missing} never launched: "
                                 f"{launches}")
        t = time.perf_counter()
        mesh_plain(K, M, out, xd, n, bs, errs)
        log(f"mesh world 1, {n // CS} chunks: the encode outputs == the "
            "plain versions on the same rows (kernels 1, 2, 3 on the "
            "canonical steps, diff on and off; 1b, 2, 3 on the adaptive "
            "step; the FGK step == the host runtime's v1_compress a chunk "
            f"at a time), {time.perf_counter() - t:.1f} s")
        for key in ("canonical", "canonical-nodiff", "fgk", "adapt"):
            if out[f"{key}.decoded"].cpu().numpy().tobytes() != data:
                raise AssertionError(f"mesh: the {key} decode did not "
                                     "return the input")
        sizes = {}
        for key in ("canonical", "fgk", "adapt", "canonical-nodiff"):
            codec, blob = mesh_container(TorchCodec, CodecConfig, out, key,
                                         data, bs)
            if key != "canonical-nodiff" and blob != codec.encode(data):
                raise AssertionError(f"mesh: the {key} container differs "
                                     "from TorchCodec.encode's")
            if codec.decode(blob) != data:
                raise AssertionError(f"mesh: TorchCodec cannot read the "
                                     f"{key} container")
            sizes[key] = len(blob)
        log(f"mesh world 1 on {mesh.backend} ({mesh.device}), {n} B, "
            f"{n // CS} chunks: "
            f"containers == TorchCodec.encode's (canonical, fgk, adaptive "
            f"bs {bs}; diff on), {sizes} B; every decode exact; launches "
            f"{launches}")

        # -- device times beside the single-process stages --------------
        buf, lw, tab, rl, car = (out[f"canonical.{k}"] for k in (
            "a", "meta", "tables", "rle_lens", "carries"))
        words = buf.view(buf.shape[0], -1)
        codec, blob = mesh_container(TorchCodec, CodecConfig, out,
                                     "canonical", data, bs)
        hdr, staged = codec.stage_decode_steps(blob)
        torch.cuda.synchronize()  # the staged copies ran on the copy stream
        w, bh = MESH_WIDTH, MESH_BAND_H
        abuf, alw, atab, atot, adirs, atl, acar = (out[f"adapt.{k}"] for k in (
            "a", "meta", "tables", "totals", "dirs", "tile_lens", "carries"))
        dec = out["canonical.decoded"]
        # kernel 5 on the mesh's lanes at their full stride, and on the
        # single-process path's, repadded to the fattest lane's bucket
        st = staged[0]
        rp = K.repad_words(st["flat"], st["lw"], hdr["wl_bucket"]).view(
            buf.shape[0], buf.shape[1], -1)
        fns = {
            "encode": lambda: M.distributed_encode_step(
                xd, n, mesh, CS, 0, True, "canonical", LANE),
            "encode_single": lambda: encode_sharded_stage(
                xd, n, 0, True, CS, n // CS, LANE),
            "encode_gathers": lambda: [M._gather(mesh, t)
                                       for t in (buf, lw, tab, rl, car)],
            "decode": lambda: M.distributed_decode_step(
                words, rl, car, mesh, CS, tab, lw, True, "canonical", LANE),
            "decode_single": lambda: codec.run_decode_steps(hdr, staged),
            "decode_gather": lambda: M._gather(mesh, dec),
            "lane_decode_full_stride": lambda: K.lane_decode(buf, tab, rl,
                                                             LANE),
            "lane_decode_repadded": lambda: K.lane_decode(
                rp, st["tables"], st["rl"], LANE, hdr["max_len_bucket"]),
            "adapt_search": lambda: M.distributed_adapt_search(xd, mesh, w,
                                                               bh),
            "adapt_encode": lambda: M.distributed_adapt_encode_step(
                xd, mesh, w, bh, bs, True, "canonical", LANE),
            "adapt_decode": lambda: M.distributed_adapt_decode_step(
                abuf.view(abuf.shape[0], -1), atot, atl, adirs, acar, atab,
                alw, mesh, w, bh, bs, True, LANE),
        }
        ms = {k: cuda_ms(f, reps=5, warm=1, queued=True)
              for k, f in fns.items()}
        log(f"mesh world 1, {n} B, device ms (queued; the single-process "
            "stage on the same 1024 chunks, run_decode_steps with its "
            "repad of the dense words; the gathers alone; kernel 5 on the "
            "mesh's lanes at their full stride and on the repadded ones): "
            + json.dumps({k: round(v, 4) for k, v in ms.items()}))
        del out, fns, buf, lw, tab, rl, car, words, abuf, alw, atab, atot
        del adirs, atl, acar, dec, staged, st, rp
        torch.cuda.empty_cache()
        mesh_ranks(K, M, mesh, x, errs)
    finally:
        dist.destroy_process_group()
    return launches


# -- the step pipeline on the main path ----------------------------------------

MAIN_KERNELS = ("rle_diff_encode", "histogram256", "lane_pack",
                "repad_words", "lane_decode", "rle_expand")
SPLIT_RUNS = 3  # timed end-to-end runs of each stage split


def eager_encode(codec, data: bytes) -> bytes:
    """The sharded stream encode one step at a time, launch by launch, each
    step fetched before the next is uploaded: the path the pipeline
    replaced, as the yardstick of its bytes."""
    cfg = codec.config
    ent = codec.entropy
    arr = np.frombuffer(data, np.uint8)
    n_chunks = -(-len(arr) // cfg.chunk_size)
    S = min(cfg.step_chunks or n_chunks, n_chunks)
    pay, cols = [], []
    for k in range(-(-n_chunks // S)):
        a, meta, tab, rl, car = codec.encode_chunk_range(arr, k * S,
                                                         (k + 1) * S)
        pay.append(wire_payload(codec, ent.keep(a, meta), meta))
        cols.append([t.cpu().numpy() for t in (meta, tab, rl, car)])
    meta, tab, rl, car = (np.concatenate([c[i] for c in cols])[:n_chunks]
                          for i in range(4))
    return codec._container(b"".join(pay), len(arr), int(rl.sum()),
                            *ent.manifest(meta, tab), (rl, car),
                            zlib.crc32(data))


def eager_round_trip_counts(K, codec, data: bytes, blob: bytes) -> dict:
    """Launch counts of a step-by-step eager encode and decode of
    ``data`` (no graphs), counted from zero."""
    K.reset_launches()
    if eager_encode(codec, data) != blob:
        raise AssertionError("eager encode differs from the pipeline's")
    hdr, staged = codec.stage_decode_steps(blob)
    for st in staged:
        codec._decode_step(hdr, st)
    torch.cuda.synchronize()
    return K.launch_counts()


def pipeline_split(codec, data: bytes, blob: bytes) -> dict:
    """One end-to-end encode and decode with the codec's stage timer on:
    host seconds (staging; the encode's payload bytes, crc32 and
    container; the decode's parse, bytes and crc32), the steps' device
    seconds from CUDA events (``device``: a sum over steps, which
    overlap), the bytes the parse copied, and the wall of each."""
    from huffman_codec_tpu_torch.utils.profiling import StageTimer

    split = {}
    for name, fn, want in (("encode", lambda: codec.encode(data), blob),
                           ("decode", lambda: codec.decode(blob), data)):
        torch.cuda.synchronize()
        codec.timer = timer = StageTimer()
        t = time.perf_counter()
        got = fn()
        wall = time.perf_counter() - t
        codec.timer = None
        if got != want:
            raise AssertionError(f"stage-split {name} differs")
        timer.resolve()
        split[name] = {"wall_s": wall, **{k: v for k, v in
                                          timer.stages.items()}}
    return split


def pipeline_path(K, TorchCodec, CodecConfig, x: np.ndarray, errs: dict):
    """The step pipeline of the main path (64 MiB sharded, diff on and
    off): containers against the eager single-step path and the CPU plain
    path, replayed encode graph steps against eager steps for every output
    and the decode's steps written into their slices of its result against
    steps run alone, the dispatch halves under sync debug mode "error",
    launch counts with and without graphs, the stage split of the
    end-to-end encode and decode, the device encode with graphs beside the
    eager figures and the device decode, and the traced idle share of a
    round trip. Returns the counted launches of the pipelined round
    trips."""
    from huffman_codec_tpu_torch.models.chunked import _encode_step
    from huffman_codec_tpu_torch.models.entropy import CANONICAL

    data = x.tobytes()
    n = len(data)
    arr = np.frombuffer(data, np.uint8)
    cfgs = {d: CodecConfig(use_diff=d, chunk_size=CS, lane=LANE,
                           layout="sharded", step_chunks=STEP)
            for d in (False, True)}

    # -- counted: fresh codecs, so the first step warms and captures, as a
    #    first call does
    K.reset_launches()
    codecs, blobs = {}, {}
    for d, cfg in cfgs.items():
        codecs[d] = codec = TorchCodec(cfg)
        blobs[d] = codec.encode(data)
        if codec.decode(blobs[d]) != data:
            raise AssertionError(f"pipeline round trip failed (diff={d})")
    launches = K.launch_counts()
    log("pipeline launches (two 64 MiB round trips, graphs):", launches)
    if not all(launches[k] for k in MAIN_KERNELS):
        raise AssertionError(f"a main-path kernel never ran: {launches}")
    graphs = {d: {str(k): (g.graph is not None, g.launches)
                  for k, g in c._graphs.items()} for d, c in codecs.items()}
    if not all(cap for gs in graphs.values() for cap, _ in gs.values()):
        raise AssertionError(f"a step graph was never captured: {graphs}")
    log("step graphs (captured, launches a replay adds):", graphs)
    eager = {}
    for d in cfgs:
        for k, v in eager_round_trip_counts(K, codecs[d], data,
                                            blobs[d]).items():
            eager[k] = eager.get(k, 0) + v
    if eager != launches:
        raise AssertionError(f"launch counts differ with graphs: {launches}"
                             f" against eager {eager}")
    log("launch counts equal with and without graphs; the eager "
        "single-step encode's containers equal the pipeline's (64 MiB, "
        "diff on and off)")

    # -- the 16 MiB + 12,345 B prefix: pipeline == eager == CPU plain
    tail = data[: (16 << 20) + 12345]
    for d, cfg in cfgs.items():
        g = codecs[d].encode(tail)
        if g != eager_encode(codecs[d], tail):
            raise AssertionError(f"prefix: pipeline != eager (diff={d})")
        if g != TorchCodec(cfg, device="cpu").encode(tail):
            raise AssertionError(f"prefix: pipeline != CPU plain (diff={d})")
        if codecs[d].decode(g) != tail:
            raise AssertionError(f"prefix round trip failed (diff={d})")
    log(f"{len(tail)} B prefix, diff on and off: pipeline == eager single "
        "step == CPU plain path; round trips exact")

    # -- replayed encode steps against eager steps, every output; the
    #    decode's steps in their slices of its result against steps alone
    for d, codec in codecs.items():
        for k in range(n // (STEP * CS)):
            base = codec._upload_step(arr, k * STEP, (k + 1) * STEP)
            got = codec._run_encode_step(base, STEP)
            want = _encode_step(base, STEP, CS, LANE, d, CANONICAL)
            for i, (g, w) in enumerate(zip(got, want)):
                same(f"pipeline.encode_step.{i}", g, w, errs)
        hdr, staged = codec.stage_decode_steps(blobs[d])
        for got, st in zip(codec.run_decode_steps(hdr, staged), staged):
            same("pipeline.decode_step", got, codec._decode_step(hdr, st),
                 errs)
    log("graph-replayed encode steps == eager steps, every output, every "
        "step; the decode's steps in place == steps alone; diff on and off")

    # -- the dispatch halves under sync debug mode "error"
    for d, codec in codecs.items():
        hdr = codec._parse(blobs[d])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs = codec.dispatch_sharded(data)
            flat = codec._run_decode(hdr,
                                     codec.stage_decode_steps(blobs[d],
                                                              hdr)[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if codec.fetch_sharded(data, outs) != blobs[d]:
            raise AssertionError("sync-debug encode differs")
        if flat[:n].cpu().numpy().tobytes() != data:
            raise AssertionError("sync-debug decode differs")
    log('dispatch halves of encode and decode: no synchronisation under '
        'torch.cuda.set_sync_debug_mode("error")')

    # -- device encode (graphs against eager) and decode, inputs resident
    for d, codec in codecs.items():
        bases = [codec._upload_step(arr, k * STEP, (k + 1) * STEP)
                 for k in range(n // (STEP * CS))]
        hdr, staged = codec.stage_decode_steps(blobs[d])
        torch.cuda.synchronize()
        fns = {
            "encode_graph": lambda: [codec._run_encode_step(b, STEP)
                                     for b in bases],
            "encode_eager": lambda: [_encode_step(b, STEP, CS, LANE, d,
                                                  CANONICAL)
                                     for b in bases],
            "decode": lambda: codec.run_decode_steps(hdr, staged),
            "decode_steps_alone": lambda: [codec._decode_step(hdr, st)
                                           for st in staged],
        }
        times = {k: {"queued_ms": cuda_ms(f, reps=10, warm=2, queued=True),
                     "host_paced_ms": cuda_ms(f, reps=10, warm=2)}
                 for k, f in fns.items()}
        log(f"pipeline device times, 64 MiB diff={d} (ms; encode_graph = "
            "replays + the clones of their outputs; decode = the steps "
            "written into one result, decode_steps_alone = each into a "
            "tensor of its own):", json.dumps(times))
        del bases, staged

    # -- the stage split of the end-to-end encode and decode
    for d, codec in codecs.items():
        for r in range(SPLIT_RUNS):
            log(f"stage split 64 MiB diff={d} run {r} (s):",
                json.dumps(pipeline_split(codec, data, blobs[d])))

    # -- the traced idle share of a 64 MiB round trip (warm codec)
    tmp = Path(tempfile.mkdtemp(prefix="pipe_trace_"))
    try:
        codec = codecs[True]
        t = time.perf_counter()
        with device_trace(str(tmp / "trace")) as path:
            rt = codec.decode(codec.encode(data))
            torch.cuda.synchronize()
        traced_s = time.perf_counter() - t
        if rt != data:
            raise AssertionError("traced pipeline round trip failed")
        share = busy_share(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"profiler, pipeline: 64 MiB sharded diff encode + decode traced in "
        f"{traced_s:.3f} s; window {share['window_ms']:.3f} ms, kernels "
        f"busy {share['kernel_busy_ms']:.3f} ms = "
        f"{100 * share['busy_share']:.2f}%, {share['kernel_events']} kernel "
        f"events; copies and sets {share['copy_and_set_ms']:.3f} ms; "
        f"kernels or copies {100 * share['with_copies_share']:.2f}%, idle "
        f"{100 * share['idle_share']:.2f}%")
    log("profiler top 5 kernels (pipeline): " + json.dumps(share["top5"]))
    del codecs
    torch.cuda.empty_cache()
    return launches


# -- a long-lived codec: its graphs and device memory over varied inputs -------

LONG_LIVED_SEEDS = (1401, 1402)  # the first pass's inputs, the second's
LONG_LIVED_NOISE = (0, 2, 8, 32)  # the gradient's noise amplitudes
LONG_LIVED_MAX_CHUNKS = 384  # 24 MiB: the largest input, two steps
LONG_LIVED_SLACK = 64 << 20  # device bytes the second pass may add


def long_lived_inputs(seed: int) -> list:
    """One pass of the long-lived phase, made from ``seed``: 16 (input,
    noise) pairs of 64 KiB to 24 MiB in a shuffled order. Chunk counts:
    one in each power-of-two class below a step (1, 2, 3-4, ...,
    129-255), two above a step (257-384) and five from 1-384; every input
    of more than one chunk ends in a partial chunk. Contents:
    ``gradient_input`` at a noise amplitude drawn from LONG_LIVED_NOISE
    with one block of random bytes at a random place, so that the
    containers' lane stride (``wl_bucket``) and code-length bucket vary
    with the data."""
    rng = np.random.default_rng(seed)
    counts = [1] + [int(rng.integers((1 << (k - 1)) + 1,
                                     min(1 << k, STEP - 1) + 1))
                    for k in range(1, STEP.bit_length())]
    counts += rng.integers(STEP + 1, LONG_LIVED_MAX_CHUNKS + 1, 2).tolist()
    counts += rng.integers(1, LONG_LIVED_MAX_CHUNKS + 1, 5).tolist()
    inputs = []
    for i in rng.permutation(len(counts)):
        c = counts[i]
        n = CS if c == 1 else (c - 1) * CS + int(rng.integers(1, CS))
        noise = int(rng.choice(LONG_LIVED_NOISE))
        x = gradient_input(n, int(rng.integers(1 << 31)), noise)
        m = int(rng.integers(1, min(n // 4, 1 << 20) + 1))
        at = int(rng.integers(0, n - m + 1))
        x[at: at + m] = rng.integers(0, 256, m, dtype=np.uint8)
        inputs.append((x.tobytes(), noise))
    return inputs


def held_bytes() -> int:
    """``memory_reserved()`` once the caching allocator has released its
    free blocks: the device bytes of live tensors and of the memory pools
    of live CUDA graphs, whatever a capture (which empties the cache) or
    the last input left cached."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def size_class(n_chunks: int) -> str:
    return next(f"{lo}-{hi} chunks" for lo, hi in
                ((1, 16), (17, 128), (129, STEP - 1),
                 (STEP, LONG_LIVED_MAX_CHUNKS)) if n_chunks <= hi)


def long_lived_path(TorchCodec, CodecConfig, bound: int) -> None:
    """Two codecs of the main path's config (diff off and on), each alive
    for the whole phase, round-trip two passes of ``long_lived_inputs``
    (seeds LONG_LIVED_SEEDS), every input twice: the first trip meets the
    input's geometry, the second costs what a repeat of the request
    costs. After each input it prints ``memory_reserved()``, the bytes the
    process holds above the phase's start (``held_bytes``), each codec's
    graph count and the graphs the input added; after each pass, the
    encode and decode walls of both trips by size class. It fails if a
    round trip is not exact, if the containers of the first pass's
    smallest input, of one below a step and of one above a step differ
    from the CPU plain path's, if a codec ever keeps more than ``bound``
    graphs, or if the process holds more than LONG_LIVED_SLACK bytes more
    after the second pass than after the first; every reading is printed
    before it fails on a bound."""
    cfgs = {d: CodecConfig(use_diff=d, chunk_size=CS, lane=LANE,
                           layout="sharded", step_chunks=STEP)
            for d in (False, True)}
    t_phase = time.perf_counter()
    start = held_bytes()
    codecs = {d: TorchCodec(cfg) for d, cfg in cfgs.items()}
    faults, held, most = [], [], 0
    for p, seed in enumerate(LONG_LIVED_SEEDS):
        inputs = long_lived_inputs(seed)
        chunks = [-(-len(x) // CS) for x, _ in inputs]
        cpu = set()
        if p == 0:
            by_size = sorted(range(len(inputs)), key=lambda i: chunks[i])
            cpu = {by_size[0],
                   next(i for i in by_size if 1 < chunks[i] < STEP
                        and chunks[i] & (chunks[i] - 1)),
                   next(i for i in by_size if chunks[i] > STEP)}
        walls: dict = {}
        for i, (data, noise) in enumerate(inputs):
            row = {"pass": p + 1, "input": i, "bytes": len(data),
                   "chunks": chunks[i], "noise": noise}
            for d, codec in codecs.items():
                keys = set(codec._graphs)
                for trip in ("first", "repeat"):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    blob = codec.encode(data)
                    t_enc = time.perf_counter() - t
                    t = time.perf_counter()
                    back = codec.decode(blob)
                    t_dec = time.perf_counter() - t
                    if back != data:
                        raise AssertionError(
                            f"long-lived round trip failed (pass {p + 1}, "
                            f"input {i}, diff={d}, {trip} trip)")
                    walls.setdefault(f"{size_class(chunks[i])} diff={d} "
                                     f"{trip}", []).append((t_enc, t_dec))
                if i in cpu and TorchCodec(cfgs[d], device="cpu").encode(
                        data) != blob:
                    raise AssertionError(
                        f"long-lived: container of {len(data)} B (diff={d}) "
                        "differs from the CPU plain path's")
                hdr = codec._parse(blob)
                most = max(most, len(codec._graphs))
                if len(codec._graphs) > bound:
                    faults.append(f"{len(codec._graphs)} graphs (diff={d}, "
                                  f"pass {p + 1}, input {i}) > {bound}")
                row[f"diff={d}"] = {
                    "container": len(blob), "wl_bucket": hdr["wl_bucket"],
                    "max_len_bucket": hdr["max_len_bucket"],
                    "graphs": len(codec._graphs),
                    "added": [str(k) for k in codec._graphs if k not in keys]}
            row["reserved"] = torch.cuda.memory_reserved()
            row["held"] = held_bytes() - start
            log("long-lived:", json.dumps(row))
        held.append(held_bytes() - start)
        log(f"long-lived pass {p + 1} walls (s; median encode, decode; "
            "inputs):", json.dumps({
                k: [float(np.median([w[0] for w in v])),
                    float(np.median([w[1] for w in v])), len(v)]
                for k, v in sorted(walls.items())}))
        if p == 0:
            log("long-lived: CPU plain path == the card's containers of "
                f"{[len(inputs[i][0]) for i in sorted(cpu)]} B, diff off "
                "and on")
    growth = held[1] - held[0]
    log(f"long-lived: held above the start {held[0]} B after pass 1, "
        f"{held[1]} B after pass 2 (growth {growth} B); graphs at most "
        f"{most} a codec (bound {bound}); every round trip exact; "
        f"{time.perf_counter() - t_phase:.1f} s")
    if growth > LONG_LIVED_SLACK:
        faults.append(f"held memory grew {growth} B over the second pass "
                      f"(> {LONG_LIVED_SLACK})")
    del codecs
    torch.cuda.empty_cache()
    if faults:
        raise AssertionError("long-lived codec: " + "; ".join(faults))


ORACLE_TAIL = 12345  # bytes past 16 MiB of the v2 check's input


def native_oracle_path(K, x: np.ndarray, errs: dict, card: str) -> None:
    """Kernels 1 and 6 against the host C++ runtime (``native/hctpu.cpp``),
    code written apart from the port's plain versions, on the 64 MiB main
    input (1024 chunks), diff off and on. Kernel 1's stream of each chunk
    must equal the runtime's ``rle_encode`` of that chunk diffed with numpy
    from the byte before it (0 for the first: the carry of the main path's
    stage, which the step-by-step stage is checked to give); kernel 6's
    output of each row must equal the runtime's ``rle_decode`` of the row's
    stream, diff-reverted with numpy. Then ``build_lengths_pm`` against
    ``build_lengths_exact`` (the two-queue Huffman merge) on the streams'
    histograms: equal total bits on every chunk. Then the runtime's v2
    container on the 16 MiB + 12,345 B prefix against ``formats``'
    ``parse_v2_container``/``make_v2_container``, and the one-chunk FGK
    forms (``fgk_encode_chunk``/``fgk_decode_chunk``, one launch each,
    counted) against the runtime's v1 body of the first chunk. Prints
    every mismatch count (each also in ``errs``) and the runtime's times
    beside the kernels'; any mismatch fails the run."""
    from huffman_codec_tpu_torch import native
    from huffman_codec_tpu_torch.formats import (
        make_v2_container, parse_v2_container)
    from huffman_codec_tpu_torch.models.chunked import encode_sharded_stage
    from huffman_codec_tpu_torch.models.entropy import CANONICAL
    from huffman_codec_tpu_torch.ops.canonical import (
        build_lengths_exact, build_lengths_pm)
    from huffman_codec_tpu_torch.ops.fgk import (
        fgk_decode_chunk, fgk_encode_chunk, n_words_for)
    from huffman_codec_tpu_torch.ops.pack import chunk_bytes

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    n = x.shape[0]
    C = n // CS
    rows = x.reshape(C, CS)
    xd = torch.from_numpy(x).to(dev).view(C, CS)
    full = torch.full((C,), CS, dtype=torch.int32, device=dev)
    car = torch.cat([torch.zeros(1, dtype=torch.uint8, device=dev),
                     xd[:-1, -1]])
    car_np = np.concatenate([[0], rows[:-1, -1]]).astype(np.uint8)
    cap = CANONICAL.cap(CS, LANE)
    bad: dict = {}

    def count(name: str, n_bad: int) -> None:
        bad[name] = bad.get(name, 0) + n_bad
        errs[name] = max(errs.get(name, 0), n_bad)

    for d in (False, True):
        streams, lens = K.rle_diff_encode(xd, full, car, d, cap)
        # the main path's stage, step by step, gives these lengths and
        # carries
        nc = 0
        for k in range(C // STEP):
            sl = slice(k * STEP, (k + 1) * STEP)
            *_, rl, sc = encode_sharded_stage(
                xd[sl].reshape(-1), STEP * CS, car[k * STEP:k * STEP + 1],
                d, CS, STEP, LANE)
            nc += int((rl != lens[sl]).sum() + (sc != car[sl]).sum())
        count("rle_diff_encode.stage_vs_oracle_carry", nc)
        work = np.diff(rows, axis=1, prepend=car_np[:, None]) if d else rows
        t = time.perf_counter()
        want = [native.rle_encode(work[c].tobytes()) for c in range(C)]
        host_enc_s = time.perf_counter() - t
        s_np, l_np = streams.cpu().numpy(), lens.cpu().numpy()
        got = [s_np[c, :l_np[c]].tobytes() for c in range(C)]
        n1 = sum(g != w for g, w in zip(got, want))
        count("rle_diff_encode.native", n1)
        k1_ms = cuda_ms(lambda: K.rle_diff_encode(xd, full, car, d, cap),
                        reps=10, warm=2, queued=True)

        out = K.rle_expand(streams, lens, car, CS, d).cpu().numpy()
        t = time.perf_counter()
        dec = [native.rle_decode(g) for g in got]
        host_dec_s = time.perf_counter() - t
        ok = [c for c in range(C) if len(dec[c]) == CS]
        ref = np.stack([np.frombuffer(dec[c], np.uint8) for c in ok])
        if d:
            ref = ((np.cumsum(ref, axis=1, dtype=np.int64)
                    + car_np[ok, None]) & 255).astype(np.uint8)
        n6 = C - len(ok) + int((out[ok] != ref).any(axis=1).sum())
        count("rle_expand.native", n6)
        k6_ms = cuda_ms(lambda: K.rle_expand(streams, lens, car, CS, d),
                        reps=10, warm=2, queued=True)
        log(f"native oracle, 64 MiB diff={d}, {C} chunks: kernel 1 rows != "
            f"host rle_encode of the numpy-diffed chunk: {n1}; kernel 6 rows "
            f"!= host rle_decode, diff-reverted: {n6}; stage lengths or "
            f"carries off the oracle's carry rule: {nc}")
        log(f"native oracle times, 64 MiB diff={d} on {card}: host C++ "
            f"rle_encode {host_enc_s * 1e3:.3f} ms ({C} calls, diff "
            f"excluded) vs kernel 1 {k1_ms:.4f} ms; host rle_decode "
            f"{host_dec_s * 1e3:.3f} ms vs kernel 6 {k6_ms:.4f} ms "
            f"(diff revert included)")

        counts = K.histogram256(streams, lens).to(torch.int64)
        pm = build_lengths_pm(counts)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ex = build_lengths_exact(counts)
        torch.cuda.synchronize()
        ex_ms = (time.perf_counter() - t) * 1e3
        cost_pm, cost_ex = (pm * counts).sum(1), (ex * counts).sum(1)
        count("build_lengths_pm.cost_vs_exact",
              int((cost_pm != cost_ex).sum()))
        same_rows = int((pm == ex).all(dim=1).sum())
        log(f"code lengths, 64 MiB diff={d}: package-merge cost == exact "
            f"Huffman cost on {int((cost_pm == cost_ex).sum())} of {C} "
            f"chunks ({int(cost_pm.sum())} bits); lengths equal element by "
            f"element on {same_rows} of {C}; build_lengths_exact "
            f"{ex_ms:.1f} ms host-paced")
        del streams, lens, out, s_np, got, dec, ref, counts, pm, ex

    # -- the host runtime's v2 container and formats' v2 functions ---------
    prefix = x[: (16 << 20) + ORACLE_TAIL].tobytes()
    for d in (False, True):
        t = time.perf_counter()
        blob = native.v2_compress(prefix, use_diff=d)
        v2_enc_s = time.perf_counter() - t
        hdr, payload = parse_v2_container(blob)
        checks = {
            "orig_size": hdr.orig_size == len(prefix),
            "n_chunks": hdr.n_chunks == -(-hdr.symbol_count
                                          // hdr.chunk_size),
            "payload": sum(-(-b // 8) for b in hdr.chunk_bits)
            == len(payload),
            "remake": make_v2_container(hdr, payload) == blob,
        }
        t = time.perf_counter()
        checks["round_trip"] = native.v2_decompress(blob) == prefix
        v2_dec_s = time.perf_counter() - t
        count("v2.checks", sum(not v for v in checks.values()))
        log(f"v2 {len(prefix)} B diff={d}: {len(blob)} B, {hdr.n_chunks} "
            f"chunks of {hdr.chunk_size} symbols; checks {checks}; host "
            f"v2_compress {v2_enc_s:.3f} s, v2_decompress {v2_dec_s:.3f} s")

    # -- the one-chunk FGK forms: the first chunk's stream (diff on, carry
    #    0), whose FGK bits are the runtime's v1 body of the chunk ---------
    streams, lens = K.rle_diff_encode(xd[:1], full[:1], car[:1], True, cap)
    m = int(lens[0])
    K.reset_launches()
    w, b = fgk_encode_chunk(streams[0], m, n_words_for(m))
    back = fgk_decode_chunk(w, m, out_len=cap)
    fl = K.launch_counts()
    v1 = native.v1_compress(rows[0].tobytes(), use_diff=True)
    body = chunk_bytes(w[None], b[None]).cpu().numpy().tobytes()
    count("fgk_encode.chunk_vs_v1", int(body != v1[9:])
          + int(int.from_bytes(v1[:8], "little") != m))
    count("fgk_decode.chunk", int(not torch.equal(back[:m], streams[0, :m])))
    if fl["fgk_encode"] != 1 or fl["fgk_decode"] != 1:
        raise AssertionError(f"one-chunk FGK forms did not launch their "
                             f"kernels once each: {fl}")
    log(f"fgk_encode_chunk / fgk_decode_chunk on chunk 0 ({m} symbols, "
        f"{int(b)} bits): launches {fl['fgk_encode']} / {fl['fgk_decode']};"
        f" body == host v1_compress: {body == v1[9:]}; decode exact: "
        f"{bad['fgk_decode.chunk'] == 0}")

    log(f"native oracle mismatches: {json.dumps(bad)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if any(bad.values()):
        raise AssertionError(f"native oracle mismatches: {bad}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from huffman_codec_tpu_torch import CodecConfig, TorchCodec, V1Codec
    from huffman_codec_tpu_torch.models.chunked import (
        encode_sharded_stage, step_graph_bound)
    from huffman_codec_tpu_torch.models.entropy import _strip_payload
    from huffman_codec_tpu_torch.native import runtime as native_runtime
    from huffman_codec_tpu_torch.ops import _build
    from huffman_codec_tpu_torch.ops import kernels as K
    from huffman_codec_tpu_torch.ops.canonical import assign_codes, build_lengths_pm
    from huffman_codec_tpu_torch.ops.rle import rle_classify

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "unknown"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"build: host runtime {native_runtime.build().name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in _build.SOURCES:
        lg = _build.BUILD_DIR / f"{name}.log"
        if lg.exists():
            for line in lg.read_text().splitlines():
                if "Compiling entry" in line:
                    line = line.split("'")[1] if "'" in line else line
                if ("registers" in line or "spill" in line
                        or line.startswith("_Z")):
                    log(f"  {name}: {line.strip()}")

    # -- kernels against their plain versions ------------------------------
    errs: dict = {}
    n_in = 64 << 20
    x = gradient_input(n_in, SEED)
    x[5_000_000:5_300_000] = 17  # long runs inside the stream
    step0 = torch.from_numpy(x[: STEP * CS].copy()).to(dev).view(STEP, CS)
    full = torch.full((STEP,), CS, dtype=torch.int32, device=dev)
    car0 = torch.cat([torch.zeros(1, dtype=torch.uint8, device=dev),
                      step0[:-1, -1]])
    main_shapes: dict = {}
    for use_diff in (False, True):
        kernel_chain(K, step0, full, car0, use_diff, errs, main_shapes)
    ec, el, ecar = edge_batch(dev)
    for use_diff in (False, True):
        kernel_chain(K, ec, el, ecar, use_diff, errs, {})
    decode_edges(K, dev, errs)
    encode_edges(K, dev, errs)
    stress(K, dev)
    log("kernels vs plain: all equal; max abs err", max(errs.values()))

    # -- the main path: 64 MiB round trips, launches counted ----------------
    cfgs = {d: CodecConfig(use_diff=d, chunk_size=CS, lane=LANE,
                           layout="sharded", step_chunks=STEP)
            for d in (False, True)}
    data = x.tobytes()
    blobs = {}
    K.reset_launches()
    for d, cfg in cfgs.items():
        codec = TorchCodec(cfg)
        blobs[d] = codec.encode(data)
        if codec.decode(blobs[d]) != data:
            raise AssertionError(f"64 MiB round trip failed (diff={d})")
    launches = K.launch_counts()
    log("main path launches (two 64 MiB round trips):", launches)
    sharded_kernels = [k.__name__ for k in K.KERNELS
                       if k not in (K.lane_decode_lanemajor,
                                    K.group_tile_lens, K.fgk_encode,
                                    K.fgk_decode)]
    if not all(launches[k] for k in sharded_kernels):
        raise AssertionError(f"a kernel was never launched: {launches}")
    for d, b in blobs.items():
        log(f"64 MiB diff={d}: {len(b)} B, {8 * len(b) / n_in:.4f} bpc, "
            "round trip exact, crc ok")

    # -- container equals the plain path on the CPU (partial tail) ----------
    n_tail = (16 << 20) + 12345
    tail = data[:n_tail]
    g = TorchCodec(cfgs[True]).encode(tail)
    c = TorchCodec(cfgs[True], device="cpu").encode(tail)
    if g != c:
        raise AssertionError("GPU container differs from the CPU plain path")
    if TorchCodec(cfgs[True]).decode(c) != tail:
        raise AssertionError("tail round trip failed")
    if TorchCodec(cfgs[False]).encode(b"") != TorchCodec(
            cfgs[False], device="cpu").encode(b""):
        raise AssertionError("empty container differs")
    log(f"{n_tail} B with a partial tail chunk: GPU container == CPU plain "
        f"container ({len(g)} B)")

    # -- device throughput, inputs resident ---------------------------------
    xd = torch.from_numpy(x).to(dev)
    for d, cfg in cfgs.items():
        def enc():
            outs = []
            for k in range(n_in // (STEP * CS)):
                seg = xd[k * STEP * CS:(k + 1) * STEP * CS]
                carry = int(x[k * STEP * CS - 1]) if k else 0
                buf, lw, tab, rl, car = encode_sharded_stage(
                    seg, STEP * CS, carry, d, CS, STEP, LANE)
                outs.append(_strip_payload(buf, lw))
            return outs
        enc_ms = median_ms(enc)
        codec = TorchCodec(cfg)
        hdr, staged = codec.stage_decode_steps(blobs[d])
        torch.cuda.synchronize()
        dec_ms = median_ms(lambda: codec.run_decode_steps(hdr, staged))
        # end to end on the host clock (upload, fetch, crc, container),
        # after one encode that captures the step graph
        codec.encode(data)
        t = time.perf_counter()
        blob = codec.encode(data)
        e2e_enc = time.perf_counter() - t
        t = time.perf_counter()
        if codec.decode(blob) != data:
            raise AssertionError("timed round trip failed")
        e2e_dec = time.perf_counter() - t
        log(f"device diff={d}: encode {n_in / enc_ms / 1e3:.1f} MB/s "
            f"({enc_ms:.3f} ms / 64 MiB), decode {n_in / dec_ms / 1e3:.1f} "
            f"MB/s ({dec_ms:.3f} ms), {8 * len(blobs[d]) / n_in:.4f} bpc; "
            f"end to end encode {e2e_enc:.3f} s, decode {e2e_dec:.3f} s")

    # -- per-kernel times at one main-path step (diff on) --------------------
    s = main_shapes
    C = STEP
    nl = s["cap"] // LANE
    sum_in = int(s["in_lens"].sum())
    sum_rl = int(s["rl"].sum())
    sum_lw = int(s["lw"].sum())
    mk = torch.arange(s["wb"], device=dev)[None, None, :] < s["lw"][:, :, None]

    def repad_lib():
        out = torch.zeros((C, nl, s["wb"]), dtype=torch.int32, device=dev)
        return out.masked_scatter_(mk, s["flat"])

    # integer operations each kernel needs on this step's data, counted
    # per element as a serial version of the function does them
    specs = [
        ("rle_diff_encode", "rle_encode.cu", 944,
         lambda: K.rle_diff_encode(s["chunks"], s["in_lens"], s["carries"],
                                   True, s["cap"]),
         lambda: K.rle_diff_encode_plain(s["chunks"], s["in_lens"],
                                         s["carries"], True, s["cap"]),
         # written: each chunk's stream and its length (the zero padding
         # of the rows to ``cap`` is the kernel's choice, not counted)
         None, sum_in + 5 * C + sum_rl + 4 * C,
         rle_encode_ops(sum_in, sum_rl, True, False)),
        ("histogram256", "histogram.cu", 1163,
         lambda: K.histogram256(s["st"], s["rl"]),
         lambda: K.histogram256_plain(s["st"], s["rl"]),
         lambda: histogram_library(s["st"], s["rl"]),
         sum_rl + 4 * C + 1024 * C, 2 * sum_rl),
        ("lane_pack", "lane_pack.cu", 312,
         lambda: K.lane_pack(s["st"], s["rl"], s["tables"], LANE),
         lambda: K.lane_pack_plain(s["st"], s["rl"], s["tables"], LANE),
         None, sum_rl + 1028 * C + 4 * C * nl * K.lane_words_cap(LANE)
         + 4 * C * nl, 6 * sum_rl),
        ("repad_words", "repad.cu", 1125,
         lambda: K.repad_words(s["flat"], s["lw"], s["wb"]),
         lambda: K.repad_words_plain(s["flat"], s["lw"], s["wb"]),
         repad_lib, 4 * sum_lw + 4 * C * nl + 4 * C * nl * s["wb"],
         4 * C * nl * s["wb"]),
        ("lane_decode", "lane_decode.cu", 531,
         lambda: K.lane_decode(s["pb"], s["lt"], s["rl"], LANE, s["max_len"]),
         lambda: K.lane_decode_plain(s["pb"], s["lt"], s["rl"], LANE,
                                     s["max_len"]),
         # what decoding needs: a symbol is one table lookup, the shift of
         # the window and its store, four operations (the kernel's table
         # yields up to three symbols a lookup)
         None, 4 * sum_lw + 260 * C + C * nl * LANE, 4 * sum_rl),
        ("rle_expand", "rle_expand.cu", 1031,
         lambda: K.rle_expand(s["dec"], s["rl"], s["carries"], CS, True),
         lambda: K.rle_expand_plain(s["dec"], s["rl"], s["carries"], CS,
                                    True),
         # what decoding needs: a stream byte is one step of the serial
         # decoder's FSM, four operations; an output byte its diff sum and
         # its store, two (the kernel's own maps, four FSM chains a byte,
         # and its scans are more work than the function needs)
         None, sum_rl + 5 * C + C * CS, 4 * sum_rl + 2 * sum_in),
    ]
    rows = []
    for name, src, line, kern, plain, lib, nbytes, n_ops in specs:
        ms = cuda_ms(kern, reps=20, warm=3, queued=True)
        host_ms = cuda_ms(kern, reps=20, warm=3)
        pms = cuda_ms(plain, reps=2, warm=1)
        lms = cuda_ms(lib, reps=20, warm=3, queued=True) if lib else None
        bound, bound_by = bound_of(nbytes, n_ops)
        rows.append({
            "name": name, "route": "cuda",
            "source": f"huffman_codec_tpu_torch/csrc/{src}",
            "replaces": f"huffman_codec_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(v for k, v in errs.items()
                               if k.split(".")[0] == name),
            "ms": ms, "plain_ms": pms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lms,
            "host_paced_ms": host_ms})
        log(f"{name:16s} {ms:9.4f} ms (host-paced {host_ms:.4f})  plain "
            f"{pms:10.3f} ms  bound "
            f"{bound:.4f} ms by {bound_by} ({nbytes} B)  library "
            f"{lms if lms is None else round(lms, 4)}  launches "
            f"{launches[name]}")
        if name == "rle_diff_encode":  # the zero tail counted as written too
            geometry(name, "the sharded step (diff on)", ms, nbytes, n_ops,
                     bound_padded_ms=(nbytes - sum_rl + C * s["cap"])
                     / HBM_BYTES_PER_S * 1e3)
        elif name == "lane_pack":
            geometry(name, "lane 512, the sharded step", ms, nbytes, n_ops)
    repad_geometry(K, "the sharded step (diff on)", s["flat"], s["lw"],
                   s["wb"])
    buf_s = K.lane_pack(s["st"], s["rl"], s["tables"], LANE)[0]
    ops = {
        "rle_classify": lambda: rle_classify(s["dec"], s["rl"]),
        "build_lengths_pm": lambda: build_lengths_pm(s["counts"]),
        "assign_codes": lambda: assign_codes(s["lens"]),
        "strip_payload": lambda: _strip_payload(buf_s, s["lw"]),
    }
    log("torch ops per 256-chunk step (ms; rle_classify is what the decode "
        "no longer runs):", {
            k: round(cuda_ms(f, reps=5), 3) for k, f in ops.items()})
    # kernel 5 on the same streams packed at the wider lanes it serves
    by_lane = {LANE: rows[4]["ms"]}
    for lane in (2048, 4096):
        buf_l, bits_l = K.lane_pack(s["st"], s["rl"], s["tables"], lane)
        lw_l = ((bits_l + 31) >> 5).to(torch.int32)
        wb_l = max(8, -(-int(lw_l.max()) // 16) * 16)
        pb_l = K.repad_words(_strip_payload(buf_l, lw_l).contiguous(), lw_l,
                             wb_l).view(C, -1, wb_l)
        dec_l = K.lane_decode(pb_l, s["lt"], s["rl"], lane, s["max_len"])
        same("lane_decode.vs_streams", dec_l, s["st"], errs)
        if lane == 2048:
            nl_l = s["cap"] // lane
            geometry("lane_pack", "lane 2048, the sharded step's streams",
                     cuda_ms(lambda: K.lane_pack(s["st"], s["rl"],
                                                 s["tables"], 2048),
                             reps=20, warm=3, queued=True),
                     sum_rl + 1028 * C + 4 * C * nl_l
                     * (K.lane_words_cap(lane) + 1), 6 * sum_rl)
        by_lane[lane] = cuda_ms(lambda: K.lane_decode(
            pb_l, s["lt"], s["rl"], lane, s["max_len"]), reps=20, warm=3,
            queued=True)
    log("lane_decode on the step's streams by lane (ms):",
        {k: round(v, 4) for k, v in by_lane.items()})

    del specs, ops, buf_s, repad_lib, mk, xd
    main_shapes.clear()
    torch.cuda.empty_cache()

    # -- the step pipeline: graphs, two fetch waves, the stage split -------
    plaunches = pipeline_path(K, TorchCodec, CodecConfig, x, errs)
    for row in rows:
        row["launches_pipeline"] = plaunches[row["name"]]

    # -- a long-lived codec over varied inputs: graphs and memory bounded --
    long_lived_path(TorchCodec, CodecConfig, step_graph_bound(STEP))

    # -- kernels 1 and 6 against the host C++ runtime ------------------------
    native_oracle_path(K, x, errs, card)

    # -- shapes that do not divide by 16 -------------------------------------
    slaunches = shapes_path(K, TorchCodec, CodecConfig, errs)
    for row in rows:
        row["launches_shapes"] = slaunches[row["name"]]

    # -- the global layout -----------------------------------------------------
    glaunches, k7 = global_path(K, TorchCodec, CodecConfig, x, errs)
    for row in rows:
        row["launches_global"] = glaunches[row["name"]]
    rows.append({
        "name": "lane_decode_lanemajor", "route": "cuda",
        "source": "huffman_codec_tpu_torch/csrc/lane_decode_lm.cu",
        "replaces": "huffman_codec_tpu/ops/pallas_kernels.py:673",
        "launches": glaunches["lane_decode_lanemajor"],
        "launches_global": glaunches["lane_decode_lanemajor"],
        "max_abs_err": max(v for k, v in errs.items()
                           if k.split(".")[0] == "lane_decode_lanemajor"),
        "ms": k7["ms"], "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
        "library_ms": None,
        "lane_decode_ms": k7["lane_decode_ms"],
        "random_bytes_ms": k7["random_bytes_ms"],
        "fixed_7bit_ms": k7["fixed_7bit_ms"]})
    alaunches, row_1b, row_walk = adaptive_path(K, TorchCodec, CodecConfig, x,
                                                errs)
    for row in rows:
        row["launches_adaptive"] = alaunches[row["name"]]
    rows += [row_1b, row_walk]
    flaunches, fgk_rows, v1_launches = fgk_path(
        K, TorchCodec, V1Codec, CodecConfig, x, errs)
    # the one-group instance's launches: V1Codec's four configs on 256 KiB
    row_walk["one_group"]["launches"] = v1_launches["group_tile_lens"]
    for row in rows:
        row["launches_fgk"] = flaunches[row["name"]]
    rows += fgk_rows
    claunches = cli_path(K, TorchCodec, CodecConfig, x)
    for row in rows:
        row["launches_cli"] = claunches[row["name"]]
    mlaunches = mesh_path(K, TorchCodec, CodecConfig, x, errs)
    for row in rows:
        row["launches_mesh"] = mlaunches[row["name"]]
    for row in rows:  # the later phases' comparisons count as well
        row["max_abs_err"] = max(v for k, v in errs.items()
                                 if k.split(".")[0] == row["name"])
        if row["name"] in GEOMETRY_MS:
            row["by_geometry"] = GEOMETRY_MS[row["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
