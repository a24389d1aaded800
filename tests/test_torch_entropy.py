"""The entropy seam of the port (``huffman_codec_tpu_torch/models/
entropy.py``), on the CPU.

* The guard, read with ``ast`` (nothing imported): no module of the port
  but the seam compares a value with an entropy name (``"canonical"``,
  ``"fgk"``), with a wire code of ``formats.py`` or with an ``entropy``
  field; none but the seam and ``formats.py`` reads those codes; and an
  entropy name stands as a plain value only where it is a default (of a
  parameter, of a dataclass field, of ``cli.py``'s option) or, in
  ``ops/``, a kernel library's name (``csrc/fgk.cu``).
* The lookup: both coders by name and by wire code, from
  ``formats.ENTROPY``; unknown ones raise.
* Each coder at odd chunk sizes and lanes: rows of symbols, some cut
  short and one empty, go through the seam's encode, what a step keeps,
  the payload wave, the manifest, a container, its parse, the decode
  staging and the decode, and come back equal.
* Each coder through the codec at chunk 1000 and lane 100: the sharded
  step pipeline (3 steps, the last short) and FGK's global candidate
  byte-equal to the JAX package's ``TPUCodec``, and each decoding the
  other's container.
* ``utils/dump.py`` tells the two containers apart through the seam.
"""

import ast
import dataclasses
import io
import zlib
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from huffman_codec_tpu.models import chunked as jch  # noqa: E402
from huffman_codec_tpu_torch import (  # noqa: E402
    CodecConfig, TorchCodec, config_from_fields)
from huffman_codec_tpu_torch.formats import ENTROPY  # noqa: E402
from huffman_codec_tpu_torch.models import entropy  # noqa: E402
from huffman_codec_tpu_torch.utils.dump import dump_v3_tables  # noqa: E402

PKG = Path(__file__).resolve().parents[1] / "huffman_codec_tpu_torch"
SEAM = "models/entropy.py"
NAMES = {"canonical", "fgk"}
CODES = {"ENTROPY", "ENTROPY_FGK", "ENTROPY_CANONICAL"}
MODULES = sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py"))


def _names_entropy(node) -> bool:
    """An expression that stands for an entropy mode: an entropy name, a
    wire code of ``formats.py``, an ``entropy`` variable, attribute or
    field, or a tuple, list or set holding one."""
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return any(_names_entropy(e) for e in node.elts)
    if isinstance(node, ast.Constant):
        return node.value in NAMES
    if isinstance(node, ast.Name):
        return node.id in CODES | {"entropy"}
    if isinstance(node, ast.Attribute):
        return node.attr in CODES | {"entropy"}
    if isinstance(node, ast.Subscript):
        return (isinstance(node.slice, ast.Constant)
                and node.slice.value == "entropy")
    return False


def _defaults(tree) -> set[int]:
    """ids of the constants that are a parameter's or a class field's
    default."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.arguments):
            out.update(id(d) for d in node.defaults + node.kw_defaults
                       if d is not None)
        elif isinstance(node, ast.ClassDef):
            out.update(id(s.value) for s in node.body
                       if isinstance(s, ast.AnnAssign) and s.value)
    return out


def _faults(mod: str, src: str | None = None) -> list[str]:
    """The guard's findings in module ``mod`` of the port (its text
    ``src``, read from the package if None)."""
    tree = ast.parse((PKG / mod).read_text() if src is None else src)
    faults = []
    defaults = _defaults(tree)
    for node in ast.walk(tree):
        line = getattr(node, "lineno", 0)
        if isinstance(node, ast.Compare) and any(
                _names_entropy(x) for x in (node.left, *node.comparators)):
            faults.append(f"{mod}:{line} compares an entropy mode")
        elif (isinstance(node, ast.Name) and node.id in CODES
              and mod != "formats.py"):
            faults.append(f"{mod}:{line} reads {node.id}")
        elif (isinstance(node, ast.Constant) and node.value in NAMES
              and id(node) not in defaults
              and mod not in ("formats.py", "cli.py")
              and not mod.startswith("ops/")):
            faults.append(f"{mod}:{line} names {node.value!r}")
    return faults


@pytest.mark.parametrize("mod", [m for m in MODULES if m != SEAM])
def test_no_module_but_the_seam_branches_on_the_entropy(mod):
    assert _faults(mod) == []


def test_the_guard_finds_each_spelling():
    """The three spellings the seam replaced, and a code looked up in
    ``formats.ENTROPY``, are each found."""
    src = ('if cfg.entropy == "canonical": pass\n'
           'if hdr["entropy"] != ENTROPY_FGK: pass\n'
           'if name(hdr) == "fgk": pass\n'
           'b = ENTROPY[cfg.entropy]\n'
           'def f(entropy="fgk"): return lookup(entropy)\n')
    got = sorted(_faults("models/probe.py", src))
    assert got == [
        "models/probe.py:1 compares an entropy mode",
        "models/probe.py:1 names 'canonical'",
        "models/probe.py:2 compares an entropy mode",
        "models/probe.py:2 reads ENTROPY_FGK",
        "models/probe.py:3 compares an entropy mode",
        "models/probe.py:3 names 'fgk'",
        "models/probe.py:4 reads ENTROPY"], got


def test_lookup_by_name_and_by_code():
    for name, code in ENTROPY.items():
        coder = entropy.lookup(name)
        assert (coder.name, coder.code) == (name, code)
        assert entropy.by_code(code) is coder
        assert entropy.has_tables(code) == (coder is entropy.CANONICAL)
    assert TorchCodec(CodecConfig(entropy="fgk"),
                      device="cpu").entropy is entropy.lookup("fgk")
    with pytest.raises(ValueError, match="unknown entropy mode huffman"):
        entropy.lookup("huffman")
    with pytest.raises(ValueError, match="unknown entropy mode 7 in"):
        entropy.by_code(7)
    assert not entropy.has_tables(7)  # reads as chunk bits; decode refuses


def _rows(C: int, L: int, seed: int):
    """(C, L) uint8 rows of skewed symbols and their lengths: full rows,
    rows cut short, an empty row and a row of one symbol."""
    rng = np.random.default_rng(seed)
    rows = np.minimum(rng.geometric(0.2, (C, L)), 255).astype(np.uint8)
    rows[1] = rng.integers(0, 256, L)  # incompressible
    lens = np.full(C, L, np.int32)
    lens[2], lens[3], lens[-1] = L // 3 + 1, 0, 7
    rows[4] = 42
    return torch.from_numpy(rows), torch.from_numpy(lens)


@pytest.mark.parametrize("name", ["canonical", "fgk"])
@pytest.mark.parametrize("cs,lane", [(1000, 100), (1000, 8)])
def test_rows_round_trip_through_the_seam(name, cs, lane):
    ent = entropy.lookup(name)
    codec = TorchCodec(CodecConfig(layout="sharded", chunk_size=cs,
                                   lane=lane, entropy=name), device="cpu")
    L = ent.cap(cs, lane)
    rows, lens = _rows(6, L, cs + lane)
    a, meta, tables = ent.encode(rows, lens, lane)
    assert (tables is None) == (name == "fgk")
    kept = ent.keep(a, meta)
    xf = codec._xfer
    (pay,), landed = ent.payloads(xf, [kept], [meta], [meta])
    xf.wait_host(landed)
    cols = [meta.numpy()] + ([] if tables is None else [tables.numpy()])
    chunk_bits, tab, lw = ent.manifest(*cols)
    assert (tab is None, lw is None) == ((name == "fgk"),) * 2
    carries = np.zeros(6, np.uint8)
    blob = codec._container(ent.wire(pay), 6 * cs,
                            int(lens.sum()), chunk_bits, tab, lw,
                            (lens.numpy(), carries), zlib.crc32(b""))
    hdr = TorchCodec._parse(blob)
    assert hdr["entropy"] == ent.code and hdr["chunk_bits"] == chunk_bits
    assert codec._check_supported(hdr) is ent
    st = codec._stage_step(blob, hdr, 0, 6, 6)
    got = ent.decode(hdr, st, st["rl"], L)
    for c in range(6):
        n = int(lens[c])
        assert torch.equal(got[c, :n], rows[c, :n]), c
        assert not got[c, n:].any(), c


CS, LANE = 1000, 100
N = 4 * CS + 321  # 5 chunks, the last partial: steps of 2, 2 and 1


def _input() -> bytes:
    rng = np.random.default_rng(22)
    i = np.arange(N)
    x = ((i // 50) * 3 + (i % 50) // 4 + rng.integers(-2, 3, N)) & 255
    x[CS: CS + 400] = rng.integers(0, 256, 400)
    x[3 * CS - 100: 3 * CS + 200] = 17  # a run across a chunk border
    return x.astype(np.uint8).tobytes()


DATA = _input()
JAX_CASES = {"canonical-sharded": ("canonical", dict(layout="sharded",
                                                     step_chunks=2)),
             "fgk-sharded": ("fgk", dict(layout="sharded", step_chunks=2)),
             "fgk-global": ("fgk", dict())}


def _jcfg(case):
    name, kw = JAX_CASES[case]
    return jch.CodecConfig(use_diff=True, chunk_size=CS, lane=LANE,
                           entropy=name, **kw)


def _encode(codec, case):
    if JAX_CASES[case][1]:
        return codec.encode(DATA)
    # the global layout's one FGK candidate, without the v1 race
    return codec._encode_global(DATA, None, False)


@pytest.fixture(scope="module")
def jax_blobs():
    return {case: _encode(jch.TPUCodec(_jcfg(case)), case)
            for case in JAX_CASES}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_codec_through_the_seam_equals_jax(jax_blobs, case):
    port = TorchCodec(config_from_fields(dataclasses.asdict(_jcfg(case))),
                      device="cpu")
    assert port.entropy is entropy.lookup(JAX_CASES[case][0])
    blob = _encode(port, case)
    assert blob == jax_blobs[case]
    assert port.decode(jax_blobs[case]) == DATA


def test_jax_decodes_the_ported_fgk_steps():
    case = "fgk-sharded"
    port = TorchCodec(config_from_fields(dataclasses.asdict(_jcfg(case))),
                      device="cpu")
    assert jch.TPUCodec(_jcfg(case)).decode(port.encode(DATA)) == DATA


@pytest.mark.parametrize("name", ["canonical", "fgk"])
def test_dump_tells_the_coders_apart(name):
    codec = TorchCodec(CodecConfig(layout="sharded", chunk_size=CS,
                                   lane=LANE, entropy=name), device="cpu")
    out = io.StringIO()
    dump_v3_tables(codec.encode(DATA), out=out, max_chunks=2)
    text = out.getvalue()
    if name == "fgk":
        assert text.startswith("v3 container uses FGK entropy")
    else:
        assert text.startswith("chunk 0: ") and "chunk 1: " in text
