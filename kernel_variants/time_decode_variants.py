"""Time the design variants of two decode kernels (``csrc/repad.cu`` and
``csrc/lane_decode_lm.cu``) beside the package's own, in one process on
one card:

    python3 kernel_variants/time_decode_variants.py            # all
    python3 kernel_variants/time_decode_variants.py repad_a    # some

Needs a CUDA card and nvcc. Variants are sources of this directory built
as ``time_variants.py`` builds them. Inputs come from ``chip_smoke.py``'s
seeded generator: the sharded step (256 chunks of 64 KiB, diff on, lane
512), the whole-file candidate's decode at 256 KiB, 1.25 MiB and 2.5 MiB
(lane 32768 at ``(8, 2)``, ``(8, 7)`` and ``(1, 112)``), the sharded
step's lanes four times over (1024 chunks, the size of the adaptive
path's 1024 bands), and ``(1, 112)`` lanes of 32768 random bytes (8-bit
codes) and of a fixed 7-bit code. Each time is a queued device time
(``chip_smoke.cuda_ms(queued=True)``), and ``equal`` says whether the
output equals the package kernel's, which the GPU tests and
``chip_smoke.py`` hold to the plain versions. The last line is one JSON
object of every time.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    CS, LANE, STEP, cuda_ms, fat_buffer, gradient_input)
from huffman_codec_tpu_torch import CodecConfig  # noqa: E402
from huffman_codec_tpu_torch.models.chunked import (  # noqa: E402
    _SINGLE_MAX, _chunkify, _global_geometry, _sharded_cap, _strip_payload)
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.ops.canonical import (  # noqa: E402
    assign_codes, build_lengths_pm)
from huffman_codec_tpu_torch.ops.diff import diff_apply  # noqa: E402
from huffman_codec_tpu_torch.ops.rle import rle_encode  # noqa: E402
from kernel_variants.time_variants import build  # noqa: E402

BUCKETS = (8, 12, 16, 24, 31)
# name: (source, -D flags)
REPAD = {
    # the first one-pass design: warp 0 looks back 32 blocks a round, a
    # thread's loads and stores interleaved
    "repad_a": ("repad_a.cu", ()),
    # the package's, and its ablations (repad_b.cu says what each drops)
    "repad_b": ("repad_b.cu", ()),
    "repad_b_noticket": ("repad_b.cu", ("NO_TICKET",)),
    "repad_b_noticket_nomemset": ("repad_b.cu", ("NO_TICKET", "NO_MEMSET")),
    "repad_b_nolookback": ("repad_b.cu", ("NO_LOOKBACK",)),
    "repad_b_smallsmem": ("repad_b.cu", ("SMALL_SMEM",)),
    "repad_b_slot1": ("repad_b.cu", ("SLOT1",)),
    "repad_b_slot1_smallsmem": ("repad_b.cu", ("SLOT1", "SMALL_SMEM")),
    # two launches: a scan of the lane starts, then the copy
    "repad_c": ("repad_c.cu", ()),
    # no ticket, and status words the kernel clears itself
    "repad_d": ("repad_d.cu", ()),
}
# variants whose scratch must be zero before the first launch and which
# leave it zero
SELF_CLEARING = {"repad_d"}
LANE_DECODE_LM = {
    # the package's kernel with 0 and 16 resynchronising rounds
    "lm_rounds0": ("lane_decode_lm_r.cu", ("ROUNDS=0",)),
    "lm_rounds16": ("lane_decode_lm_r.cu", ("ROUNDS=16",)),
}


def lane_words(buf, bits):
    lw = ((bits + 31) >> 5).to(torch.int32)
    wb = max(8, -(-int(lw.max()) // 16) * 16)
    return _strip_payload(buf, lw).contiguous(), lw, wb


def sharded_step(dev):
    """(flat, lane words, wb) of the sharded step's lanes, diff on."""
    x = torch.from_numpy(gradient_input(STEP * CS, 1234)).to(dev)
    step = x.view(STEP, CS)
    full = torch.full((STEP,), CS, dtype=torch.int32, device=dev)
    car = torch.cat([step.new_zeros(1), step[:-1, -1]])
    cap = _sharded_cap(CS, "canonical", LANE)
    st, rl = K.rle_diff_encode(step, full, car, True, cap)
    lens = build_lengths_pm(K.histogram256(st, rl))
    tables = (assign_codes(lens) | (lens << 26)).to(torch.int32)
    return lane_words(*K.lane_pack(st, rl, tables, LANE))


def whole_file(dev, n):
    """The whole-file candidate's decode inputs at ``n`` input bytes, as
    ``TorchCodec.stage_global`` lays them out: (flat, lane words, wb,
    buffer (rows, nl, wb), code lengths, counts, lane, max_len)."""
    x = torch.from_numpy(gradient_input(n, 1234)).to(dev)
    cs, lane, max_chunks = _global_geometry(CodecConfig(use_diff=True), n,
                                            True)
    stream, total = rle_encode(
        diff_apply(x)[None, :],
        torch.tensor([n], dtype=torch.int32, device=dev), max_chunks * cs)
    chunks, lens = _chunkify(stream[0], total[0], cs, max_chunks)
    cl = build_lengths_pm(K.histogram256(chunks, lens))
    tables = (assign_codes(cl) | (cl << 26)).to(torch.int32)
    flat, lw, wb = lane_words(*K.lane_pack(chunks, lens, tables, lane))
    wb = min(wb, K.lane_words_cap(lane))
    rows, rcs, lt = max_chunks, cs, cl.to(torch.uint8)
    if (cs // lane) % 8 == 0 and cs <= _SINGLE_MAX:
        rows, rcs = 8, cs // 8
        lw = lw.view(8, -1).contiguous()
        lt = lt.repeat(8, 1)
    cnt = (total[0].to(torch.int64) - torch.arange(rows, device=dev) * rcs
           ).clamp(0, rcs).to(torch.int32)
    pb = K.repad_words(flat, lw, wb).view(rows, lw.shape[1], wb)
    max_len = next(b for b in BUCKETS if b >= int(cl.max()))
    return flat, lw, wb, pb, lt, cnt, lane, max_len


def flat_code_lanes(dev, nsym, bits, seed, pad=0):
    """(1, 112) lanes of 32768 symbols drawn uniformly from ``nsym``
    symbols under a flat ``bits``-bit code, at a stride of ``pad`` zero
    words more than the lanes need."""
    lane, nl = 32768, 112
    rng = np.random.default_rng(seed)
    sy = torch.from_numpy(rng.integers(0, nsym, (1, nl * lane),
                                       dtype=np.int64).astype(np.uint8)
                          ).to(dev)
    lt = torch.zeros((1, 256), dtype=torch.uint8, device=dev)
    lt[0, :nsym] = bits
    pb, ln = fat_buffer(K, sy, lt, lane, pad)
    return pb, lt, ln, lane, 8


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    pick = set(argv)
    repad = {k: v for k, v in REPAD.items() if not pick or k in pick}
    ldlm = {k: v for k, v in LANE_DECODE_LM.items()
            if not pick or k in pick}
    libs = build({**repad, **ldlm})
    dev = torch.device("cuda")
    sid = torch.cuda.current_stream().cuda_stream
    res = {}

    def timed(key, run, ok=None):
        ms = cuda_ms(run, reps=30, warm=3, queued=True)
        res[key] = ms if ok is None else {"ms": ms, "equal": ok}
        print(f"{key:48s} {ms:.5f} ms" + ("" if ok is None else
                                          f"  equal {ok}"), flush=True)

    # -- repad_words ---------------------------------------------------------
    step = sharded_step(dev)
    flat4 = torch.cat([step[0]] * 4)
    lw4 = torch.cat([step[1]] * 4)
    wf = whole_file(dev, 10 << 18)
    geoms = {"sharded step": step, "1024 chunks": (flat4, lw4, step[2]),
             "2.5 MiB whole-file chunk": (wf[0], wf[1], wf[2])}
    for where, (flat, lw, wb) in geoms.items():
        want = K.repad_words(flat, lw, wb)
        timed(f"package repad_words @ {where}",
              lambda: K.repad_words(flat, lw, wb))
        C, nl = lw.shape
        for name in repad:
            if name not in libs:
                continue
            fn = libs[name].repad_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out = torch.empty_like(want)
            # enough for every variant (repad_c keeps the starts there)
            words = K.repad_scratch_words(C, nl, wb) + C * nl + 64
            kept = torch.zeros(words, dtype=torch.int64, device=dev)

            def run(fn=fn, out=out, name=name, kept=kept):
                scratch = (kept if name in SELF_CLEARING else
                           torch.empty(words, dtype=torch.int64, device=dev))
                err = fn(flat.data_ptr(), lw.data_ptr(), out.data_ptr(),
                         scratch.data_ptr(), words, C, nl, wb, flat.numel(),
                         sid)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            timed(f"{name} @ {where}", run, torch.equal(out, want))

    # -- lane_decode_lanemajor -----------------------------------------------
    cases = {f"{n} B whole file": whole_file(dev, n)[3:]
             for n in (1 << 18, 5 << 18, 10 << 18)}
    cases["(1, 112) random bytes"] = flat_code_lanes(dev, 256, 8, 1244)
    cases["(1, 112) fixed 7-bit code"] = flat_code_lanes(dev, 128, 7, 1245)
    # 32 words more a lane: sub-sequences of 288 bits, which 7 does not
    # divide, so no speculative chain is ever in step with the true one
    cases["(1, 112) fixed 7-bit code, wb + 32"] = flat_code_lanes(
        dev, 128, 7, 1245, pad=32)
    for where, args in cases.items():
        want = K.lane_decode_lanemajor(*args)
        ok = torch.equal(want, K.lane_decode(*args))
        timed(f"package lane_decode_lanemajor @ {where} {tuple(args[0].shape)}",
              lambda: K.lane_decode_lanemajor(*args), ok)
        timed(f"package lane_decode @ {where}",
              lambda: K.lane_decode(*args))
        pb, lt, cnt, lane, max_len = args
        C, nl, wb = pb.shape
        for name in ldlm:
            if name not in libs:
                continue
            fn = libs[name].lane_decode_lm_launch
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out = torch.empty_like(want)

            def run(fn=fn, out=out, name=name):
                err = fn(pb.data_ptr(), lt.data_ptr(), cnt.data_ptr(),
                         out.data_ptr(), C, nl, wb, lane, max_len,
                         K.fat_subseq_bits(wb), sid)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            timed(f"{name} @ {where}", run, torch.equal(out, want))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
