"""The benchmark of the PyTorch/CUDA port (``huffman_codec_tpu_torch``).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout, on
the card(s) of the machine it starts on: set-up (the kernels' and the host
runtime's builds on a checkout's first run, the traffic made from the
seed, every object encoded once), then a closed loop of one caller for
``--seconds``, then the comparison with the plain reference. It prints the
cell's bpc and the numbers compared on standard error and, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared with its limit.

It exits non-zero and prints no result where no card is found, where the
cell asks for more cards than there are, where the program is missing, and
where JAX or the JAX package has been loaded by the time the window has
closed. ``--control lsb`` runs the control (the lowest bit of every input
byte cleared before the encode), which has to come out not correct.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "huffman_codec_tpu")


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that must not be, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _caches() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the port's own builds go to ``build/torch_kernels`` and
    ``build/torch_native`` there already)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("lsb",), default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _caches()
    # the checkout's root, in place of this script's folder, whose
    # subfolders' names are too plain to sit first on the path
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.core import cells, result

    cell = cells.find_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line, notes = result.run(cell, args.seed, args.seconds, bool(args.trace),
                             device="cuda", control=args.control,
                             t_start=START)
    bad = loaded_forbidden()
    if bad:
        print(f"modules that must not be loaded: {bad}", file=sys.stderr)
        return 3
    for note in notes:
        print(note, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
