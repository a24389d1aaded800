"""Time the designs of the two FGK kernels (``csrc/fgk.cu``) beside the
package's own, in one process on one card:

    python3 kernel_variants/time_fgk_variants.py            # every variant
    python3 kernel_variants/time_fgk_variants.py warp chain  # some of them

Needs a CUDA card and nvcc. Every variant is a source of this directory
built with the package's nvcc flags and its own -D flags, all builds at
once, into ``build/kernel_variants/``; the registers ptxas reports are
printed beside each, and the shared-memory loads of the package's kernels
as cuobjdump lists them (LDS, or generic LD where the compiler lost the
address space). The variants: ``warp`` (``fgk_warp.cu``, the first design:
a warp a chunk, the successor by a warp minimum at every level), ``chain``
(``fgk_chain.cu`` with no flag: the package's design without its
read-ahead), and from it ``chain_blocks`` (the successor from block
records), ``chain_two`` (the code and the update climbed apart) and
``chain_uniform`` (every lane runs the chain).

Four workloads: one sharded step of ``chip_smoke.py`` (256 chunks of 64
KiB of its seeded input, MNP-5 streams, diff on and off) and the v1 chain
of its first 256 KiB at C = 1 (diff off, the v1 default, and on). Each
encode is timed on the workload's streams, each decode on the package
encoder's words. Times are queued device times
(``chip_smoke.cuda_ms(queued=True)``), and ``equal`` says whether the
variant's output equals the package kernel's. Clocks a tree level: the
time at the card's largest SM clock over the longest chain's code bits
(a code bit is one tree level, which the code or walk and the update both
visit). The last line is one JSON object of every time.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import CS, STEP, cuda_ms, gradient_input  # noqa: E402
from huffman_codec_tpu_torch.native import runtime  # noqa: E402
from huffman_codec_tpu_torch.ops import _build  # noqa: E402
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.ops.fgk import n_words_for  # noqa: E402
from huffman_codec_tpu_torch.ops.rle import rle_max_encoded_len  # noqa: E402

HERE = os.path.join(ROOT, "kernel_variants")
OUT = os.path.join(ROOT, "build", "kernel_variants")
V1_BYTES = 1 << 18

# name: (source, -D flags)
VARIANTS = {
    "warp": ("fgk_warp.cu", ()),
    "chain": ("fgk_chain.cu", ()),
    "chain_blocks": ("fgk_chain.cu", ("BLOCKS",)),
    "chain_two": ("fgk_chain.cu", ("TWO_CLIMBS",)),
    "chain_uniform": ("fgk_chain.cu", ("UNIFORM",)),
}


def build(variants: dict) -> dict:
    """Compile every variant at once; return {name: (encode, decode)} of
    those built, as ctypes functions."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (src, flags) in variants.items():
        out = os.path.join(OUT, f"fgk_{name}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS,
               *[f"-D{f}" for f in flags], "-o", out, os.path.join(HERE, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    fns = {}
    for name, (proc, out) in procs.items():
        text, _ = proc.communicate()
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        print(name, "build rc", proc.returncode, regs, flush=True)
        if proc.returncode:
            print(text[-3000:], flush=True)
            continue
        lib = ctypes.CDLL(out)
        enc, dec = lib.fgk_encode_launch, lib.fgk_decode_launch
        enc.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        dec.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        enc.restype = dec.restype = ctypes.c_int
        fns[name] = (enc, dec)
    return fns


def shared_loads() -> dict:
    """Shared-memory loads in the package's FGK kernels, by opcode, from
    cuobjdump's SASS (empty where the toolkit has no cuobjdump)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    _build.library("fgk")
    sass = subprocess.run([tool, "-sass", str(_build._target("fgk"))],
                          capture_output=True, text=True, timeout=120).stdout
    counts = {}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?P\w+\s+)?([A-Z]+)",
                         sass):
        if m.group(1) in ("LDS", "LD", "STS", "ST"):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def sm_clock_hz() -> float:
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def rows_of(streams: list) -> tuple:
    """Byte streams -> (rows (R, n) uint8, lengths (R,) int32) on the card."""
    n = max(len(s) for s in streams)
    rows = np.zeros((len(streams), n), np.uint8)
    for i, s in enumerate(streams):
        rows[i, :len(s)] = np.frombuffer(s, np.uint8)
    lens = np.array([len(s) for s in streams], np.int32)
    return torch.from_numpy(rows).cuda(), torch.from_numpy(lens).cuda()


def workloads(x: np.ndarray) -> dict:
    """name -> (rows, lengths) on the card: the sharded step's MNP-5
    streams, diff on and off, and the 256 KiB v1 chain, off and on."""
    dev = torch.device("cuda")
    step = torch.from_numpy(x[:STEP * CS].copy()).to(dev).view(STEP, CS)
    full = torch.full((STEP,), CS, dtype=torch.int32, device=dev)
    car = torch.cat([step.new_zeros(1), step[:-1, -1]])
    cap = rle_max_encoded_len(CS)
    out = {}
    for diff in (True, False):
        st, rl = K.rle_diff_encode(step, full, car, diff, cap)
        out[f"step_diff_{'on' if diff else 'off'}"] = (st, rl)
    v1 = x[:V1_BYTES]
    for diff in (False, True):
        src = v1.copy()
        if diff:
            src[1:] -= v1[:-1]
        out[f"v1_256k_diff_{'on' if diff else 'off'}"] = rows_of(
            [runtime.rle_encode(src.tobytes())])
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    pick = set(argv)
    fns = build({k: v for k, v in VARIANTS.items() if not pick or k in pick})
    print("package fgk kernels' loads and stores:", shared_loads(),
          flush=True)
    clock = sm_clock_hz()
    sid = torch.cuda.current_stream().cuda_stream
    res = {"card": card, "sm_clock_hz": clock}
    for wname, (rows, lens) in workloads(gradient_input(STEP * CS,
                                                        1234)).items():
        C, n = rows.shape
        nw = n_words_for(n)
        words, bits = K.fgk_encode(rows, lens, nw)
        dec = K.fgk_decode(words, lens, n)
        valid = torch.arange(n, device=rows.device)[None, :] < lens[:, None]
        if not torch.equal(dec, torch.where(valid, rows, 0)):
            raise AssertionError(f"{wname}: the package's round trip failed")
        max_bits = int(bits.max())
        reps = 3 if C > 1 else 2
        entry = {"rows": C, "symbols": int(lens.sum()),
                 "bits": int(bits.sum()), "longest_bits": max_bits}

        def timed(label, run):
            ms = cuda_ms(run, reps=reps, warm=1, queued=True)
            clocks = ms * 1e-3 * clock / max_bits
            entry[label] = {"ms": ms, "clocks_a_level": clocks}
            return ms, clocks

        ms_e, cl_e = timed("package_encode",
                           lambda: K.fgk_encode(rows, lens, nw))
        ms_d, cl_d = timed("package_decode",
                           lambda: K.fgk_decode(words, lens, n))
        print(f"{wname}: {C} rows, {entry['symbols']} symbols, "
              f"{entry['bits']} bits, longest {max_bits}; package encode "
              f"{ms_e:.4f} ms ({cl_e:.1f} clocks a level), decode "
              f"{ms_d:.4f} ms ({cl_d:.1f})", flush=True)
        for name, (fe, fd) in fns.items():
            w = torch.empty_like(words)
            b = torch.empty_like(bits)
            o = torch.empty_like(dec)

            def enc(fe=fe, w=w, b=b, name=name):
                err = fe(rows.data_ptr(), lens.data_ptr(), w.data_ptr(),
                         b.data_ptr(), C, n, nw, sid)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            def dcd(fd=fd, o=o, name=name):
                err = fd(words.data_ptr(), lens.data_ptr(), o.data_ptr(), C,
                         words.shape[1], n, sid)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            enc()
            dcd()
            torch.cuda.synchronize()
            ok = torch.equal(w, words) and torch.equal(b, bits) and \
                torch.equal(o, dec)
            me, ce = timed(f"{name}_encode", enc)
            md, cd = timed(f"{name}_decode", dcd)
            entry[name] = {"equal": ok}
            print(f"  {name:14s} encode {me:.4f} ms ({ce:.1f} clocks a "
                  f"level)  decode {md:.4f} ms ({cd:.1f})  equal {ok}",
                  flush=True)
        res[wname] = entry
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
