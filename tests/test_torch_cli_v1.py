"""The v1 format through the port's command line, on the CPU: its three
backends (``native``, the host C++ runtime; ``torch``, the device
``V1Codec`` on the plain PyTorch versions; ``pyref``) write the bytes of
the JAX command line's ``native`` backend in the four pipeline configs,
and every blob decodes through each backend of both command lines.

The input is a 512 x 64 stepped gradient with two rows of noise (32 KiB),
made from a numpy seed: its runs keep the transformed stream short, since
the plain FGK loop behind ``--backend torch`` on the CPU runs once a
symbol. Every comparison is exact.
"""

import contextlib
import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from huffman_codec_tpu import cli as jcli  # noqa: E402

from huffman_codec_tpu_torch import cli as tcli  # noqa: E402


def _run(main, argv, **kw):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv, **kw)
    assert rc == 0, err.getvalue()


def _image() -> bytes:
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0:64, 0:512]
    img = (y // 4) * 9 + (x // 32) * 5
    img[30:32] += rng.integers(-2, 3, (2, 512))
    return (img & 255).astype(np.uint8).tobytes()


@pytest.mark.parametrize("flags", [[], ["-m"], ["-a", "-w", "512"],
                                   ["-a", "-m"]],
                         ids=["none", "m", "a", "am"])
def test_v1_backends_equal_jax_native(flags, tmp_path):
    data = _image()
    src = tmp_path / "in.raw"
    src.write_bytes(data)
    ref = tmp_path / "jax-native.v1"
    _run(jcli.main, ["-c", *flags, "-i", str(src), "-o", str(ref)])
    for backend in ("native", "torch", "pyref"):
        out = tmp_path / f"{backend}.v1"
        _run(tcli.main, ["-c", *flags, f"--backend={backend}",
                         "-i", str(src), "-o", str(out)], device="cpu")
        assert out.read_bytes() == ref.read_bytes(), backend
    dec = tmp_path / "dec.raw"
    for main, backends, kw in ((tcli.main, ("native", "torch", "pyref"),
                                {"device": "cpu"}),
                               (jcli.main, ("native", "jax", "pyref"), {})):
        for backend in backends:
            _run(main, ["-d", f"--backend={backend}", "-i", str(ref),
                        "-o", str(dec)], **kw)
            assert dec.read_bytes() == data, backend
