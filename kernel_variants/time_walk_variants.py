"""Time the group walk kernel (``csrc/group_tile_lens.cu``) beside its
design variant ``group_tile_lens_a.cu`` in one process on one card:

    python3 kernel_variants/time_walk_variants.py

Needs a CUDA card and nvcc. The variant is built as ``time_variants.py``
builds its sources. Inputs come from ``chip_smoke.py``'s seeded generator:
its first 256 KiB, diffed, adaptive-encoded as one 512 x 512 matrix at
block sizes 8 and 16 and walked as a grouped manifest (64 tiles a group,
64 and 16 groups), and the block-size-16 stream walked as one group of
its 1024 tiles, as ``V1Codec`` walks a v1 payload. At each input the
package's kernel without the decoded sizes (what the grouped manifest
runs), the variant and the package's kernel again are timed in turns
(package, variant, variant, package), then the package's kernel with the
decoded sizes (what ``V1Codec`` runs). Each time is a queued device time
(``chip_smoke.cuda_ms(queued=True)``), and ``equal`` says whether the
variant's lengths and sizes equal the package kernel's. The last line is
one JSON object of every time.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    fn = build({"walk_a": ("group_tile_lens_a.cu", ())})[
        "walk_a"].group_tile_lens_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
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
    body = stream[: int(total)].clone()  # bs 16: one group of every tile
    inputs["bs 16, one group (V1Codec's walk)"] = (
        body, torch.zeros(1, dtype=torch.int32, device=dev), sizes,
        int(total), int(total))
    res = {}
    for where, args in inputs.items():
        stream, offs, sizes, total, cap = args
        lens, dec = torch.empty_like(sizes), torch.empty_like(sizes)

        def variant():
            err = fn(stream.data_ptr(), offs.data_ptr(), sizes.data_ptr(),
                     lens.data_ptr(), dec.data_ptr(), offs.numel(),
                     sizes.numel() // offs.numel(), stream.shape[0], total,
                     cap, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"group_tile_lens_a: CUDA error {err}")

        variant()
        want = K.group_tile_lens(*args, with_decoded=True)
        equal = bool(torch.equal(lens, want[0]) and torch.equal(dec, want[1]))
        reps = 3 if "one group" in where else 10
        times = {}
        for key, run in (("package", lambda: K.group_tile_lens(*args)),
                         ("variant_a", variant), ("variant_a ", variant),
                         ("package ", lambda: K.group_tile_lens(*args)),
                         ("package_decoded", lambda: K.group_tile_lens(
                             *args, with_decoded=True))):
            times.setdefault(key.strip(), []).append(
                cuda_ms(run, reps=reps, warm=1, queued=True))
        res[where] = {**times, "equal": equal}
        print(f"{where:36s} " + "  ".join(
            f"{k} {' / '.join(f'{v:.4f}' for v in vs)} ms"
            for k, vs in times.items()) + f"  equal {equal}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
