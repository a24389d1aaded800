"""Time the design variants of the two encode kernels (``csrc/rle_encode.cu``
and ``csrc/lane_pack.cu``) beside the package's own, in one process on one
card:

    python3 kernel_variants/time_variants.py            # every variant
    python3 kernel_variants/time_variants.py a b_m6     # some of them

Needs a CUDA card and nvcc. Every variant is a source of this directory
built with the package's nvcc flags and its own -D flags, all builds at
once, into ``build/kernel_variants/``; the registers and spills ptxas
reports are printed beside each. The RLE variants encode the sharded step
of ``chip_smoke.py`` (256 chunks of 64 KiB of its seeded input, diff on);
the ``lane_pack`` variants pack that step's streams at lane 512 and 2048.
Each time is a queued device time (``chip_smoke.cuda_ms(queued=True)``),
and ``equal`` says whether the output equals the plain version: the
ablations, which drop a step on purpose, are timed only. The last line is
one JSON object of every time, the package's kernels under ``package``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import CS, LANE, STEP, cuda_ms, gradient_input  # noqa: E402
from huffman_codec_tpu_torch.models.chunked import _sharded_cap  # noqa: E402
from huffman_codec_tpu_torch.ops import _build  # noqa: E402
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.ops.canonical import (  # noqa: E402
    assign_codes, build_lengths_pm)

HERE = os.path.join(ROOT, "kernel_variants")
OUT = os.path.join(ROOT, "build", "kernel_variants")

# name: (source, -D flags). (a)-(d) are the RLE encoder's designs in the
# order they were tried; the package's kernel is (d) with 2 groups, 6
# blocks an SM.
RLE = {
    "a": ("rle_encode_a.cu", ()),
    "a_nolookback": ("rle_encode_a.cu", ("NO_LOOKBACK",)),
    "a_nocompute": ("rle_encode_a.cu", ("NO_COMPUTE",)),
    "a_neither": ("rle_encode_a.cu", ("NO_LOOKBACK", "NO_COMPUTE")),
    "a_m2": ("rle_encode_a.cu", ("MINB=2",)),
    "a_m8": ("rle_encode_a.cu", ("MINB=8",)),
    "b": ("rle_encode_b.cu", ()),
    "b_m6": ("rle_encode_b.cu", ("MINB=6",)),
    "b_m8": ("rle_encode_b.cu", ("MINB=8",)),
    "b_relaxed_m6": ("rle_encode_b.cu", ("RELAXED", "MINB=6")),
    "b_halo_m6": ("rle_encode_b.cu", ("HALO_GLOBAL", "MINB=6")),
    "b_t512_m2": ("rle_encode_b.cu", ("THREADS=512", "MINB=2")),
    "b_t512_m3": ("rle_encode_b.cu", ("THREADS=512", "MINB=3")),
    "b_rh_m8": ("rle_encode_b.cu", ("RELAXED", "HALO_GLOBAL", "MINB=8")),
    "b_rh_m8_noatomic": ("rle_encode_b.cu",
                         ("RELAXED", "HALO_GLOBAL", "MINB=8", "NO_ATOMIC")),
    "b_rh_m8_nostore": ("rle_encode_b.cu",
                        ("RELAXED", "HALO_GLOBAL", "MINB=8", "NO_STORE")),
    "b_rh_m8_nolookback": ("rle_encode_b.cu",
                           ("RELAXED", "HALO_GLOBAL", "MINB=8",
                            "NO_LOOKBACK")),
    "b_rh_t128_m16": ("rle_encode_b.cu",
                      ("RELAXED", "HALO_GLOBAL", "THREADS=128", "MINB=16")),
    "c_m8": ("rle_encode_c.cu", ()),
    "c_m6": ("rle_encode_c.cu", ("MINB=6",)),
    "c_m4": ("rle_encode_c.cu", ("MINB=4",)),
    "d_g1_m8": ("rle_encode_d.cu", ("GROUPS=1", "MINB=8")),
    "d_g2_m8": ("rle_encode_d.cu", ("GROUPS=2", "MINB=8")),
    "d_g2_m6": ("rle_encode_d.cu", ("GROUPS=2", "MINB=6")),
    "d_g2_m4": ("rle_encode_d.cu", ("GROUPS=2", "MINB=4")),
    "d_g4_m4": ("rle_encode_d.cu", ("GROUPS=4", "MINB=4")),
}
PACK = {
    "pack_a": ("lane_pack_a.cu", ()),
    "pack_a_m6": ("lane_pack_a.cu", ("MINB=6",)),
    "pack_a_m8": ("lane_pack_a.cu", ("MINB=8",)),
}


def build(variants: dict) -> dict:
    """Compile every variant at once; return {name: CDLL} of those built."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (src, flags) in variants.items():
        out = os.path.join(OUT, f"{name}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               *[f"-D{f}" for f in flags], "-o", out, os.path.join(HERE, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        text, _ = proc.communicate()
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        print(name, "build rc", proc.returncode, regs, flush=True)
        if proc.returncode:
            print(text[-3000:], flush=True)
        else:
            libs[name] = ctypes.CDLL(out)
    return libs


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    pick = set(argv)
    rle = {k: v for k, v in RLE.items() if not pick or k in pick}
    pack = {k: v for k, v in PACK.items() if not pick or k in pick}
    libs = build({**rle, **pack})

    dev = torch.device("cuda")
    step = torch.from_numpy(gradient_input(STEP * CS, 1234)).to(dev).view(
        STEP, CS)
    full = torch.full((STEP,), CS, dtype=torch.int32, device=dev)
    car = torch.cat([step.new_zeros(1), step[:-1, -1]])
    cap = _sharded_cap(CS, "canonical", LANE)
    sid = torch.cuda.current_stream().cuda_stream
    res = {"package": {}}

    def timed(name, run, ok):
        ms = cuda_ms(run, reps=30, warm=3, queued=True)
        res[name] = {"ms": ms, "equal": ok}
        print(f"{name:22s} {ms:.5f} ms  equal {ok}", flush=True)

    want = K.rle_diff_encode_plain(step, full, car, True, cap)
    res["package"]["rle_diff_encode"] = cuda_ms(
        lambda: K.rle_diff_encode(step, full, car, True, cap), reps=30,
        warm=3, queued=True)
    print(f"{'package rle_diff_encode':22s} "
          f"{res['package']['rle_diff_encode']:.5f} ms", flush=True)
    for name in rle:
        if name not in libs:
            continue
        fn = libs[name].rle_encode_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        streams = torch.empty((STEP, cap), dtype=torch.uint8, device=dev)
        out_lens = torch.empty(STEP, dtype=torch.int32, device=dev)
        # a status word a tile of 1024 bytes or more, and the tile counter
        scratch = torch.empty(STEP * (CS // 1024) + 1, dtype=torch.int64,
                              device=dev)

        def run(fn=fn, streams=streams, out_lens=out_lens, scratch=scratch,
                name=name):
            err = fn(step.data_ptr(), full.data_ptr(), car.data_ptr(),
                     streams.data_ptr(), out_lens.data_ptr(),
                     scratch.data_ptr(), STEP, CS, cap, 1, 0, sid)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        run()
        torch.cuda.synchronize()
        timed(name, run, torch.equal(streams, want[0])
              and torch.equal(out_lens, want[1]))

    st, rl = K.rle_diff_encode(step, full, car, True, cap)
    lens = build_lengths_pm(K.histogram256(st, rl))
    tables = (assign_codes(lens) | (lens << 26)).to(torch.int32)
    for lane in (512, 2048):
        pw, pb = K.lane_pack_plain(st, rl, tables, lane)
        W = K.lane_words_cap(lane)
        ms = cuda_ms(lambda: K.lane_pack(st, rl, tables, lane), reps=30,
                     warm=3, queued=True)
        res["package"][f"lane_pack@{lane}"] = ms
        print(f"{'package lane_pack@' + str(lane):22s} {ms:.5f} ms",
              flush=True)
        for name in pack:
            if name not in libs:
                continue
            fn = libs[name].lane_pack_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            words = torch.empty((STEP, cap // lane, W), dtype=torch.int32,
                                device=dev)
            bits = torch.empty((STEP, cap // lane), dtype=torch.int32,
                               device=dev)

            def run(fn=fn, words=words, bits=bits, lane=lane, W=W,
                    name=name):
                err = fn(st.data_ptr(), rl.data_ptr(), tables.data_ptr(),
                         words.data_ptr(), bits.data_ptr(), STEP, cap, lane,
                         W, sid)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            timed(f"{name}@{lane}", run,
                  torch.equal(words, pw) and torch.equal(bits, pb))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
