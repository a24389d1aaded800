"""Time the sharded stream path's step policies on one card:

    python3 kernel_variants/time_step_policies.py [ROOT ...]

Each ROOT is a checkout of the repository (default: this one); each is
timed in a process of its own, which builds that checkout's kernels into
its ``build/``, so that two commits compare on one card in turns (a
parent unpacked with ``git archive`` into a directory ``.gitignore``
lists: ``parent . . parent``). Needs a CUDA card and nvcc.

In each process, on the main path's config (64 KiB chunks, lane 512,
256 chunks a step), diff off and on, on ``chip_smoke.py``'s 64 MiB input
(seed 1234, the 300 KB run at 5.0 MB), with a warm codec (two encodes and
two decodes first, so that whatever the package captures is captured):

* the device decode, ``run_decode_steps`` on the four staged steps, and
  the device encode, ``_run_encode_step`` on the four uploaded steps
  (``chip_smoke.cuda_ms``: queued, and host-paced beside it);
* the end-to-end ``encode`` and ``decode`` walls of the 64 MiB input
  (host clock, median of WALL_REPS);
* the end-to-end encode walls of the input's first 1 MiB and 9 MiB
  (one step or less) two ways, in turns (package, eager, eager, package)
  x SMALL_REPS: ``encode`` as the package runs it, and the other policy
  for an input of one step or less, its step run eagerly at its own chunk
  count (``_encode_step`` then ``fetch_sharded``); the two containers
  must be equal.

Each process prints one JSON line; the last line is one JSON object of
every root's result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SCRIPT = os.path.abspath(__file__)
CS, LANE, STEP = 1 << 16, 512, 256
WALL_REPS = 5
SMALL_REPS = 5
SMALL_SIZES = (1 << 20, 9 << 20)


def wall(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def median(v) -> float:
    v = sorted(v)
    return (v[len(v) // 2] + v[(len(v) - 1) // 2]) / 2


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from chip_smoke import SEED, cuda_ms, gradient_input
    from huffman_codec_tpu_torch import CodecConfig, TorchCodec
    from huffman_codec_tpu_torch.models.chunked import _encode_step
    from huffman_codec_tpu_torch.ops import _build

    _build.build_all()
    x = gradient_input(64 << 20, SEED)
    x[5_000_000:5_300_000] = 17
    data = x.tobytes()
    out = {"root": root, "device": torch.cuda.get_device_name(0)}
    for d in (False, True):
        codec = TorchCodec(CodecConfig(use_diff=d, chunk_size=CS, lane=LANE,
                                       layout="sharded", step_chunks=STEP))
        blob = codec.encode(data)
        if codec.encode(data) != blob:
            raise AssertionError("a warm encode differs")
        for _ in range(2):
            if codec.decode(blob) != data:
                raise AssertionError("64 MiB round trip failed")
        hdr, staged = codec.stage_decode_steps(blob)
        bases = [codec._upload_step(x, k * STEP, (k + 1) * STEP)
                 for k in range(len(data) // (STEP * CS))]
        torch.cuda.synchronize()
        dec = lambda: codec.run_decode_steps(hdr, staged)  # noqa: E731
        enc = lambda: [codec._run_encode_step(b, STEP)  # noqa: E731
                       for b in bases]
        r = {"decode_ms": cuda_ms(dec, reps=20, warm=3, queued=True),
             "decode_host_paced_ms": cuda_ms(dec, reps=20, warm=3),
             "encode_ms": cuda_ms(enc, reps=10, warm=2, queued=True),
             "encode_host_paced_ms": cuda_ms(enc, reps=10, warm=2)}
        del bases, staged
        r["encode_wall_s"] = median([wall(lambda: codec.encode(data))
                                     for _ in range(WALL_REPS)])
        r["decode_wall_s"] = median([wall(lambda: codec.decode(blob))
                                     for _ in range(WALL_REPS)])
        for size in SMALL_SIZES:
            small = data[:size]
            arr = x[:size]
            n_chunks = -(-size // CS)

            def eager():
                base = codec._upload_step(arr, 0, n_chunks)
                return codec.fetch_sharded(small, [_encode_step(
                    base, n_chunks, CS, LANE, d, "canonical")])

            codec.encode(small)
            want = codec.encode(small)
            if eager() != want:
                raise AssertionError(f"{size} B: eager step differs")
            pkg, egr = [], []
            for _ in range(SMALL_REPS):
                pkg.append(wall(lambda: codec.encode(small)))
                egr.append(wall(eager))
                egr.append(wall(eager))
                pkg.append(wall(lambda: codec.encode(small)))
            r[f"{size >> 20} MiB"] = {
                "package_s": median(pkg), "eager_s": median(egr),
                "package_all_s": pkg, "eager_all_s": egr}
        r["graphs"] = len(codec._graphs)
        out[f"diff={d}"] = r
        del codec
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(os.path.abspath(argv[1]))), flush=True)
        return 0
    roots = argv or [os.path.dirname(os.path.dirname(SCRIPT))]
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, SCRIPT, "--worker", root],
                              capture_output=True, text=True, timeout=600)
        sys.stderr.write(proc.stderr)
        if proc.returncode:
            print(proc.stdout, flush=True)
            raise SystemExit(f"{root}: exit {proc.returncode}")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    print(json.dumps({"runs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
