"""Time the group walk kernel (``csrc/group_tile_lens.cu``, a warp a
group) beside its design variants in one process on one card:

    python3 kernel_variants/time_walk_variants.py

Needs a CUDA card and nvcc. The variants are built as ``time_variants.py``
builds its sources: ``group_tile_lens_thread.cu`` (the first design, a
thread a group, walking byte by byte from global memory) and
``group_tile_lens_pass.cu`` (the first warp design, a new pass at every
restart). Inputs come from ``chip_smoke.py``'s seeded generator: its
first 256 KiB, diffed, adaptive-encoded as one 512 x 512 matrix at block
sizes 8 and 16 and walked as a grouped manifest (64 tiles a group: 64 and
16 groups), and each stream walked as one group of every tile (4096 and
1024), as ``V1Codec`` walks a v1 payload. At each input the package's
kernel without the decoded sizes and the first design are timed in turns
(package, thread, thread, package), then each with the decoded sizes,
then the first warp design. Each time is a queued device time
(``chip_smoke.cuda_ms(queued=True)``), and ``equal`` says whether every
variant's lengths (and decoded sizes, in that instance) equal the package
kernel's. The last line is one JSON object of every time.
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

from chip_smoke import SEED, cuda_ms, gradient_input  # noqa: E402
from huffman_codec_tpu_torch.ops import adapt as A  # noqa: E402
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.ops.diff import diff_apply  # noqa: E402
from huffman_codec_tpu_torch.ops.rle import rle_max_encoded_len  # noqa: E402
from kernel_variants.time_variants import build  # noqa: E402

VARIANTS = {
    "thread": ("group_tile_lens_thread.cu", ()),
    "pass": ("group_tile_lens_pass.cu", ()),
}


def walk_inputs(dev) -> dict:
    """name -> (stream, group_offs, sizes, total, group_cap) on the card."""
    img = diff_apply(torch.from_numpy(
        gradient_input(1 << 18, SEED)).to(dev))
    inputs = {}
    for bs in (8, 16):
        stream, total, _, tl = A.adapt_encode_fixed(img, 512, 512, bs,
                                                    with_header=False)
        offs = (torch.cumsum(tl, 0) - tl)[:: A.GROUP_K].to(
            torch.int32).contiguous()
        sizes = torch.full((tl.shape[0],), bs * bs, dtype=torch.int32,
                           device=dev)
        inputs[f"bs {bs}, {offs.numel()} groups"] = (
            stream, offs, sizes, int(total),
            A.GROUP_K * rle_max_encoded_len(bs * bs))
        body = stream[: int(total)].clone()
        inputs[f"bs {bs}, one group of {tl.shape[0]} (V1Codec's walk)"] = (
            body, torch.zeros(1, dtype=torch.int32, device=dev), sizes,
            int(total), int(total))
    return inputs


def bind(lib: ctypes.CDLL):
    fn = lib.group_tile_lens_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(args, lens, dec):
        stream, offs, sizes, total, cap = args
        err = fn(stream.data_ptr(), offs.data_ptr(), sizes.data_ptr(),
                 lens.data_ptr(), None if dec is None else dec.data_ptr(),
                 offs.numel(), sizes.numel() // offs.numel(),
                 stream.shape[0], total, cap,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"walk variant: CUDA error {err}")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    runs = {k: bind(lib) for k, lib in build(VARIANTS).items()}
    res = {}
    for where, args in walk_inputs(torch.device("cuda")).items():
        sizes = args[2]
        want = K.group_tile_lens(*args, with_decoded=True)
        out = {k: (torch.empty_like(sizes), torch.empty_like(sizes))
               for k in runs}
        equal = {}
        for k, run in runs.items():
            lens, dec = out[k]
            run(args, lens, dec)
            equal[k] = bool(torch.equal(lens, want[0])
                            and torch.equal(dec, want[1]))
            lens.zero_()  # the instance without the decoded sizes
            run(args, lens, None)
            equal[k] &= bool(torch.equal(lens, want[0]))
        slow = "one group" in where
        reps = 3 if slow else 10
        plan = [("package", lambda: K.group_tile_lens(*args)),
                ("thread", lambda: runs["thread"](args, out["thread"][0],
                                                  None)),
                ("thread ", lambda: runs["thread"](args, out["thread"][0],
                                                   None)),
                ("package ", lambda: K.group_tile_lens(*args)),
                ("package_decoded", lambda: K.group_tile_lens(
                    *args, with_decoded=True)),
                ("thread_decoded", lambda: runs["thread"](
                    args, *out["thread"])),
                ("pass", lambda: runs["pass"](args, out["pass"][0], None))]
        times = {}
        for key, fn in plan:
            times.setdefault(key.strip(), []).append(
                cuda_ms(fn, reps=reps, warm=1, queued=True))
        res[where] = {**times, "equal": equal}
        print(f"{where:40s} " + "  ".join(
            f"{k} {' / '.join(f'{v:.4f}' for v in vs)} ms"
            for k, vs in times.items()) + f"  equal {equal}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
