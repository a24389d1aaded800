"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level names (the port's own name begins with the
JAX package's), and the reference loads nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark.core import cells

FORBIDDEN = {"jax", "jaxlib", "flax", "huffman_codec_tpu"}
METRICS = sorted({m["name"] for k in ("end_to_end", "per_layer")
                  for m in cells.load_benchmark()[k]})
# the modules found by name: request kinds, systems under test, data models
MODULES = sorted(f"benchmark.{d}.{p.stem}" for d in ("requests", "codecs",
                                                     "data")
                 for p in (cells.BENCH_DIR / d).glob("*.py")
                 if p.stem != "__init__")


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    prog = (f"import sys\nsys.path.insert(0, {str(cells.ROOT)!r})\n{code}\n"
            "import json\nprint(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, cwd=cells.ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    code = "\n".join([
        "import benchmark.run",
        "from benchmark.core import cells, judge, loop, mesh, result",
        "from benchmark.core import readers, trace, traffic",
        "import benchmark.reference",
        "import huffman_codec_tpu_torch, huffman_codec_tpu_torch.parallel."
        "mesh, huffman_codec_tpu_torch.utils.profiling",
        *[f"cells.metric_reader({m!r})" for m in METRICS],
        *[f"import {m}" for m in MODULES]])
    got = _loaded(code)
    assert "huffman_codec_tpu_torch" in got
    assert not got & FORBIDDEN, got & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    got = _loaded("import benchmark.reference\n"
                  "from benchmark.reference import canonical, container, "
                  "fgk, stream, v1, v3_fgk")
    assert not got & (FORBIDDEN | {"huffman_codec_tpu_torch"}), got


def test_the_run_names_what_it_finds():
    from benchmark.run import loaded_forbidden

    sys.modules.setdefault("huffman_codec_tpu_torch_fake", sys)
    try:
        assert "huffman_codec_tpu" not in loaded_forbidden()
    finally:
        sys.modules.pop("huffman_codec_tpu_torch_fake", None)
