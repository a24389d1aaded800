"""The port's command line (``huffman_codec_tpu_torch.cli``) against the
JAX package's (``huffman_codec_tpu.cli``), both run in this process on the
CPU: the port's as ``main(argv, device="cpu")`` (its device paths on the
plain PyTorch versions), the JAX one under ``JAX_PLATFORMS=cpu``.

- every error case of ``tests/test_cli.py`` (exit codes 1-15) gives the
  same exit code and the same stderr bytes, and so do an unknown format,
  an unknown backend and a v3 config that breaks two rules: once on each
  package's default v1 backend (the port's ``torch``, the device
  ``V1Codec``; JAX's ``native``), once with ``--backend=native`` on both;
- ``--backend torch`` and ``--backend pyref`` give the host runtime's
  code and line on the broken v1 blobs;
- v3 containers (sharded with and without diff, FGK, and the default
  layout, which returns a v1 blob on small inputs in both packages) are
  byte-equal, decode across the packages, and ``--stats`` and
  ``--dump-tables`` print the same;
- v2 containers are byte-equal and decode across the packages;
- without a GPU the shell's entry point refuses v3 and v1 (whose
  default backend is ``torch``) with "no CUDA device" and writes nothing; importing the port's
  command line loads neither JAX nor the JAX package.

Inputs are made from a numpy seed; every comparison is exact. The JAX
v3 configs are four, in this module only (the XLA:CPU crash note in
``tests/conftest.py``).
"""

import contextlib
import io
import json
import os
import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from huffman_codec_tpu import cli as jcli  # noqa: E402

from huffman_codec_tpu_torch import cli as tcli  # noqa: E402
from huffman_codec_tpu_torch.edge_cases import (  # noqa: E402
    adapt_v1_blob,
    broken_adapt_v1_blobs,
)

REPO = str(pathlib.Path(__file__).resolve().parent.parent)


def _call(main, argv, **kw):
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    return rc, err.getvalue().encode()


def jax_cli(argv):
    return _call(jcli.main, argv)


def port_cli(argv):
    return _call(tcli.main, argv, device="cpu")


BLOBS = {
    "short": b"abc",  # 8: truncated Huffman header
    "bad": bytes([255, 0, 0, 0, 0, 0, 0, 0, 0, 0]),  # 9: bitstream underrun
    "adapt10": adapt_v1_blob(b"\x01\x02\x03four"),  # 10: W/H/bs cut short
    "adapt11": adapt_v1_blob(struct.pack(">QQQ", 512, 512, 8)),  # 11: no dirs
    # 13: a tile overshoots, 14: a tile runs short, 15: bytes left over
    **{f"adapt{code}": blob
       for code, (blob, _) in broken_adapt_v1_blobs().items()},
}


@pytest.fixture()
def files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # b.out, the default output, lands here
    paths = {"sample": bytes(range(256)) * 8, "odd": b"x" * 100,
             "tiny": b"x" * 12, **BLOBS}
    for name, data in paths.items():
        (tmp_path / name).write_bytes(data)
    return {name: str(tmp_path / name) for name in paths} | {
        "nope": str(tmp_path / "nope"),
        "nodir": str(tmp_path / "no_such_dir" / "x.bin")}


# (expected exit code, argv with {file} names from the fixture)
ERROR_CASES = {
    "1-missing-argument": (1, ["-i"]),
    "2-unknown-option": (2, ["-x"]),
    "3-no-input": (3, ["-c"]),
    "4-zero-width": (4, ["-c", "-w", "0", "-i", "{sample}"]),
    "5-no-such-input": (5, ["-c", "-i", "{nope}"]),
    "6-size-not-width-multiple": (6, ["-c", "-a", "-w", "512",
                                      "-i", "{odd}"]),
    "7-unwritable-output": (7, ["-c", "-i", "{sample}", "-o", "{nodir}"]),
    "8-short-header": (8, ["-d", "-i", "{short}"]),
    "9-underrun": (9, ["-d", "-i", "{bad}"]),
    "10-adapt-header-cut": (10, ["-d", "-i", "{adapt10}"]),
    "11-adapt-dirs-missing": (11, ["-d", "-i", "{adapt11}"]),
    "12-too-small": (12, ["-c", "-a", "-w", "4", "-i", "{tiny}"]),
    "13-tile-overshoot": (13, ["-d", "-i", "{adapt13}"]),
    "14-tile-short": (14, ["-d", "-i", "{adapt14}"]),
    "15-leftover": (15, ["-d", "-i", "{adapt15}"]),
    "2-unknown-format": (2, ["-c", "--format=v9", "-i", "{sample}"]),
    # a v3 config breaking two rules: both packages check the lane first
    "9-v3-two-rules": (9, ["-c", "--format=v3", "--layout=bogus",
                           "--chunk-size=1000", "-i", "{sample}"]),
}


def _argv(template, files):
    return [a.format(**files) for a in template]


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_exit_codes_and_stderr_equal_jax(case, files):
    code, template = ERROR_CASES[case]
    argv = _argv(template, files)
    want = jax_cli(argv)
    assert want[0] == code, want
    assert port_cli(argv) == want


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_exit_codes_and_stderr_native_backend_equal_jax(case, files):
    """The port's host runtime, asked for, against JAX's default one."""
    code, template = ERROR_CASES[case]
    argv = ["--backend=native", *_argv(template, files)]
    want = jax_cli(argv)
    assert want[0] == code, want
    assert port_cli(argv) == want


@pytest.mark.parametrize("name", ["short", "bad", "adapt10", "adapt11",
                                  "adapt13", "adapt14", "adapt15"])
@pytest.mark.parametrize("backend", ["torch", "pyref"])
def test_v1_backends_on_broken_blobs_equal_native(backend, name, files):
    """The host runtime's code and line; the JAX command line's ``--backend
    jax`` is no oracle here (it exits 0, 0 and 9 on the 13-15 blobs)."""
    want = port_cli(["-d", "--backend=native", "-i", files[name]])
    assert want[0] in (8, 9, 10, 11, 13, 14, 15), want
    assert port_cli(["-d", f"--backend={backend}", "-i", files[name]]) == want


def test_unknown_backend_either_way(files):
    """``jax`` is no backend of the port, nor ``torch`` of the JAX one."""
    rc, err = port_cli(["-c", "--backend=jax", "-i", files["sample"]])
    assert (rc, err) == (2, b"ERROR: unrecognized backend\n")
    assert jax_cli(["-c", "--backend=torch", "-i", files["sample"]]) == \
        (rc, err)


def _gradient(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    base = ((i // 512) * 3 + (i % 512) * 2) // 5
    return ((base + rng.integers(-2, 3, n)) & 255).astype(np.uint8).tobytes()


def _stats(err: bytes) -> dict:
    line = [ln for ln in err.decode().splitlines() if ln.startswith("{")][-1]
    return json.loads(line)


V3_CASES = {
    "sharded-m": ["-m", "--layout=sharded", "--chunk-size=4096"],
    "sharded": ["--layout=sharded", "--chunk-size=4096"],
    "sharded-fgk-m": ["-m", "--layout=sharded", "--chunk-size=4096",
                      "--entropy=fgk"],
    # the default layout: a v1 blob on a small input, in both packages
    "global-m": ["-m"],
}


@pytest.mark.parametrize("case", list(V3_CASES))
def test_v3_bytes_stats_and_dump_equal_jax(case, tmp_path):
    data = _gradient(3 * 4096 + 100, 11)
    src = tmp_path / "in.raw"
    src.write_bytes(data)
    flags = ["--format=v3", *V3_CASES[case]]
    blobs, stats = {}, {}
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        out = tmp_path / f"{name}.v3"
        rc, err = cli(["-c", *flags, "--stats", "-i", str(src),
                       "-o", str(out)])
        assert rc == 0, err
        blobs[name], stats[name] = out.read_bytes(), _stats(err)
    assert blobs["port"] == blobs["jax"]
    assert (blobs["port"][:6] == b"HCTPU\x03") == (case != "global-m")
    assert stats["port"].keys() == stats["jax"].keys()
    for key in ("input_bytes", "output_bytes", "n_chunks", "bpc"):
        assert stats["port"][key] == stats["jax"][key], key
    # each names its own default v1 backend
    assert stats["port"]["extra"] == {**stats["jax"]["extra"],
                                      "backend": "torch"}
    assert stats["port"]["input_bytes"] == len(data)
    # each package decodes the other's container, dumping its tables
    dec = tmp_path / "dec.raw"
    runs = {}
    for name, cli, blob in (("jax", jax_cli, "port"),
                            ("port", port_cli, "jax")):
        runs[name] = cli(["-d", "--format=v3", "--dump-tables",
                          "-i", str(tmp_path / f"{blob}.v3"),
                          "-o", str(dec)])
        assert runs[name][0] == 0, runs[name]
        assert dec.read_bytes() == data
    assert runs["port"] == runs["jax"]
    text = runs["port"][1].decode()
    assert ("FGK tree after" in text if case == "global-m" else
            "uses FGK entropy" in text if "fgk" in case else
            "chunk 0:" in text and " code " in text)


@pytest.mark.parametrize("flags", [[], ["-m", "-a", "-w", "64"]],
                         ids=["none", "am"])
def test_v2_bytes_equal_jax_and_cross_decode(flags, tmp_path):
    data = _gradient(64 * 200, 12)
    src = tmp_path / "in.raw"
    src.write_bytes(data)
    argv = ["--format=v2", "--chunk-size=4096", *flags]
    for name, cli in (("jax", jax_cli), ("port", port_cli)):
        rc, err = cli(["-c", *argv, "-i", str(src),
                       "-o", str(tmp_path / f"{name}.v2")])
        assert rc == 0, err
    assert (tmp_path / "port.v2").read_bytes() == \
        (tmp_path / "jax.v2").read_bytes()
    for cli, blob in ((jax_cli, "port"), (port_cli, "jax")):
        dec = tmp_path / f"{blob}.dec"
        rc, err = cli(["-d", "--format=v2", "-i", str(tmp_path / f"{blob}.v2"),
                       "-o", str(dec)])
        assert rc == 0, err
        assert dec.read_bytes() == data


def _module(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "huffman_codec_tpu_torch",
                           *args], capture_output=True, cwd=cwd, env=env)


@pytest.mark.parametrize("flags", [["-c", "--format=v3"],
                                   ["-c", "--backend=torch"],
                                   ["-d", "--format=v3"],
                                   ["-c"], ["-d"]],
                         ids=["v3-encode", "torch-encode", "v3-decode",
                              "v1-default-encode", "v1-default-decode"])
def test_entry_point_refuses_without_gpu(flags, tmp_path):
    """The shell's entry point runs on the card: without one it exits
    non-zero, says so and writes nothing (no fallback to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("checks the entry point on a machine without a GPU")
    src = tmp_path / "in.raw"
    src.write_bytes(bytes(range(256)) * 8)
    r = _module([*flags, "-i", str(src), "-o", str(tmp_path / "out")],
                tmp_path)
    assert r.returncode != 0
    assert b"no CUDA device" in r.stderr
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.raw"]


def test_entry_point_help(tmp_path):
    r = _module(["-h"], tmp_path)
    assert r.returncode == 0
    assert b"USAGE" in r.stdout and b"--backend {native,torch,pyref}" in \
        r.stdout


def test_command_line_imports_no_jax():
    code = ("import sys\n"
            "import huffman_codec_tpu_torch.__main__\n"
            "import huffman_codec_tpu_torch.cli\n"
            "import huffman_codec_tpu_torch.pyref\n"
            "import huffman_codec_tpu_torch.utils\n"
            "import huffman_codec_tpu_torch.utils.dump\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'huffman_codec_tpu')))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_utils_metrics_timer_and_trace(tmp_path):
    """``CodecMetrics`` prints JAX's JSON; ``StageTimer`` keeps its stages;
    ``device_trace`` writes a Chrome trace of what ran (CPU activity here,
    CUDA too on a card)."""
    from huffman_codec_tpu.utils.metrics import CodecMetrics as JaxMetrics

    from huffman_codec_tpu_torch.utils import (
        CodecMetrics,
        StageTimer,
        device_trace,
    )

    fields = dict(input_bytes=2048, output_bytes=777, encode_s=0.25,
                  n_chunks=2, extra={"format": "v3"})
    assert CodecMetrics(**fields).to_json() == JaxMetrics(**fields).to_json()
    x = torch.arange(4096, dtype=torch.float32)
    with StageTimer() as t:
        with t.stage("sum", sync=x):
            x.sum()
    assert set(t.stages) == {"sum", "total"} and "sum" in t.report()
    with device_trace(str(tmp_path / "trace")) as path:
        (x * 2).sum()
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and e["name"] == "aten::mul"
               for e in events)
