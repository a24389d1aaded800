"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the six CUDA kernels from huffman_codec_tpu_torch/csrc, holds each
one against its plain PyTorch version on the card (one full main-path
step of 256 x 64 KiB chunks, diff on and off, and a batch of edge-case
chunks), round-trips a 64 MiB generated input through
``TorchCodec.encode``/``decode`` with the diff model on and off, checks a
container against the plain path run on the CPU, and times the device
encode and decode and every kernel with CUDA events. It prints the card's
name and power limit, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
when there is no GPU or any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
STEP = 256  # chunks per step on the main path
CS = 1 << 16
LANE = 512
SEED = 1234


def log(*a):
    print(*a, flush=True)


def gradient_input(n: int, seed: int) -> np.ndarray:
    """Smooth 512-wide 8-bit gradients with noise, like the repo's
    512 x 512 grayscale corpus, made in bulk from a seed."""
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    row, col = (i // 512) % 512, i % 512
    img = (i // (512 * 512)) * 37
    base = (row * 3 + col * 2) // 5 + img
    noise = rng.integers(-2, 3, n)
    return ((base + noise) & 255).astype(np.uint8)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


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


def kernel_chain(K, chunks, in_lens, carries, use_diff, errs, shapes):
    """Run the six kernels as the main path chains them, each held against
    its plain version on the same inputs (tolerance 0: integer codec)."""
    from huffman_codec_tpu_torch.models.chunked import _sharded_cap, _strip_payload
    from huffman_codec_tpu_torch.ops.canonical import assign_codes, build_lengths_pm
    from huffman_codec_tpu_torch.ops.rle import rle_classify

    def sync():  # surface a fault of the launch just made, where it happened
        if chunks.is_cuda:
            torch.cuda.synchronize()

    C, n = chunks.shape
    cap = _sharded_cap(n, "canonical", LANE)
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
    buf, bits = K.lane_pack(st, rl, tables, LANE)
    sync()
    pbuf, pbits = K.lane_pack_plain(st, rl, tables, LANE)
    same("lane_pack", buf, pbuf, errs)
    same("lane_pack.bits", bits, pbits, errs)
    lw = ((bits + 31) >> 5).to(torch.int32)
    flat = _strip_payload(buf, lw).contiguous()
    wb = max(8, -(-int(lw.max()) // 16) * 16)
    wb = min(wb, K.lane_words_cap(LANE))
    padded = K.repad_words(flat, lw, wb)
    sync()
    same("repad_words", padded, K.repad_words_plain(flat, lw, wb), errs)
    ml = int(lens.max())
    max_len = next(b for b in (8, 12, 16, 24, 31) if b >= ml)
    lt = lens.to(torch.uint8)
    nl = cap // LANE
    pb = padded.view(C, nl, wb)
    dec = K.lane_decode(pb, lt, rl, LANE, max_len)
    sync()
    same("lane_decode", dec, K.lane_decode_plain(pb, lt, rl, LANE, max_len),
         errs)
    same("lane_decode.vs_streams", dec, st, errs)
    ic = rle_classify(dec, rl)
    out = K.rle_expand(dec, ic, rl, carries, n, use_diff)
    sync()
    same("rle_expand", out, K.rle_expand_plain(dec, ic, rl, carries, n,
                                                use_diff), errs)
    valid = torch.arange(n, device=chunks.device)[None, :] < in_lens[:, None]
    same("round_trip", torch.where(valid, out, 0), torch.where(valid, chunks, 0),
         errs)
    shapes.update(chunks=chunks, in_lens=in_lens, carries=carries, st=st,
                  rl=rl, tables=tables, lw=lw, flat=flat, wb=wb, pb=pb, lt=lt,
                  max_len=max_len, dec=dec, ic=ic, use_diff=use_diff, cap=cap,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from huffman_codec_tpu_torch import CodecConfig, TorchCodec
    from huffman_codec_tpu_torch.models.chunked import (
        _encode_sharded_stage, _strip_payload)
    from huffman_codec_tpu_torch.ops import _build
    from huffman_codec_tpu_torch.ops import kernels as K
    from huffman_codec_tpu_torch.ops.canonical import assign_codes, build_lengths_pm
    from huffman_codec_tpu_torch.ops.rle import rle_classify

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
    for name in _build.SOURCES:
        lg = _build.BUILD_DIR / f"{name}.log"
        if lg.exists():
            for line in lg.read_text().splitlines():
                if "registers" in line or "spill" in line:
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
    if not all(launches.values()):
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
                buf, lw, tab, rl, car = _encode_sharded_stage(
                    seg, STEP * CS, carry, d, CS, STEP, LANE)
                outs.append(_strip_payload(buf, lw))
            return outs
        enc_ms = median_ms(enc)
        codec = TorchCodec(cfg)
        hdr, staged = codec.stage_decode_steps(blobs[d])
        torch.cuda.synchronize()
        dec_ms = median_ms(lambda: codec.run_decode_steps(hdr, staged))
        # end to end on the host clock (upload, fetch, crc, container)
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

    specs = [
        ("rle_diff_encode", "rle_encode.cu", 944,
         lambda: K.rle_diff_encode(s["chunks"], s["in_lens"], s["carries"],
                                   True, s["cap"]),
         lambda: K.rle_diff_encode_plain(s["chunks"], s["in_lens"],
                                         s["carries"], True, s["cap"]),
         None, sum_in + 5 * C + C * s["cap"] + 4 * C),
        ("histogram256", "histogram.cu", 1163,
         lambda: K.histogram256(s["st"], s["rl"]),
         lambda: K.histogram256_plain(s["st"], s["rl"]),
         lambda: histogram_library(s["st"], s["rl"]),
         sum_rl + 4 * C + 1024 * C),
        ("lane_pack", "lane_pack.cu", 312,
         lambda: K.lane_pack(s["st"], s["rl"], s["tables"], LANE),
         lambda: K.lane_pack_plain(s["st"], s["rl"], s["tables"], LANE),
         None, sum_rl + 1028 * C + 4 * C * nl * K.lane_words_cap(LANE)
         + 4 * C * nl),
        ("repad_words", "repad.cu", 1125,
         lambda: K.repad_words(s["flat"], s["lw"], s["wb"]),
         lambda: K.repad_words_plain(s["flat"], s["lw"], s["wb"]),
         repad_lib, 4 * sum_lw + 4 * C * nl + 4 * C * nl * s["wb"]),
        ("lane_decode", "lane_decode.cu", 531,
         lambda: K.lane_decode(s["pb"], s["lt"], s["rl"], LANE, s["max_len"]),
         lambda: K.lane_decode_plain(s["pb"], s["lt"], s["rl"], LANE,
                                     s["max_len"]),
         None, 4 * sum_lw + 260 * C + C * nl * LANE),
        ("rle_expand", "rle_expand.cu", 1031,
         lambda: K.rle_expand(s["dec"], s["ic"], s["rl"], s["carries"], CS,
                              True),
         lambda: K.rle_expand_plain(s["dec"], s["ic"], s["rl"], s["carries"],
                                    CS, True),
         None, 2 * sum_rl + 5 * C + C * CS),
    ]
    rows = []
    for name, src, line, kern, plain, lib, nbytes in specs:
        ms = cuda_ms(kern, reps=20, warm=3)
        pms = cuda_ms(plain, reps=2, warm=1)
        lms = cuda_ms(lib, reps=20, warm=3) if lib else None
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": f"huffman_codec_tpu_torch/csrc/{src}",
            "replaces": f"huffman_codec_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches[name],
            "max_abs_err": max(v for k, v in errs.items()
                               if k.split(".")[0] == name),
            "ms": ms, "plain_ms": pms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lms})
        log(f"{name:16s} {ms:9.4f} ms  plain {pms:10.3f} ms  bound "
            f"{bound:.4f} ms ({nbytes} B)  library "
            f"{lms if lms is None else round(lms, 4)}  launches "
            f"{launches[name]}")
    buf_s = K.lane_pack(s["st"], s["rl"], s["tables"], LANE)[0]
    ops = {
        "rle_classify": lambda: rle_classify(s["dec"], s["rl"]),
        "build_lengths_pm": lambda: build_lengths_pm(s["counts"]),
        "assign_codes": lambda: assign_codes(s["lens"]),
        "strip_payload": lambda: _strip_payload(buf_s, s["lw"]),
    }
    log("torch ops per 256-chunk step (ms):", {
        k: round(cuda_ms(f, reps=5), 3) for k, f in ops.items()})

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
