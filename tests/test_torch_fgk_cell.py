"""The ``sharded-fgk-m`` configuration through the port's normal path on
the CPU (the plain versions of the kernels), held to the benchmark's plain
reference (``benchmark/reference/v3_fgk``), and the FGK path's spans and
counters (``TorchCodec.timer``).

The codec is built from the configuration file's fields, as the benchmark
builds it, cut to 1 KiB chunks and steps of 2 chunks: the plain FGK loop
runs once a symbol. The input is the bulk mix's data (a gradient with
noise and a random block of a chunk), 7 chunks less a short tail, so 4
steps.

* The container is judged 0 by ``v3_fgk`` with every chunk judged, and
  the ``lsb`` control (the lowest input bit cleared) more than 0.
* The decode equals the input.
* ``fgk code bits`` of an encode and of a decode equal the container's
  code bits (``v3_fgk.sizes``); an encode records ``fgk strip``; both
  count their ``fgk steps``.
* The canonical codec of the same configuration records the spans and
  counters it did before FGK had any, and no ``fgk`` name.
* On a card, a decode records the device span ``fgk rows``, and both
  count ``fgk steps side by side``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmark import reference  # noqa: E402
from benchmark.codecs.torch_codec import fields  # noqa: E402
from benchmark.core import cells, loop, traffic  # noqa: E402
from benchmark.reference import v3_fgk  # noqa: E402
from huffman_codec_tpu_torch import CodecConfig, TorchCodec  # noqa: E402
from huffman_codec_tpu_torch.utils.profiling import StageTimer  # noqa: E402

CELL = "sharded-fgk-m.bulk"
CHUNK = 1024
N_CHUNKS = 7
SEED = 2**31 + 4321

ENCODE = {"host staging", "payload", "crc32", "container"}
DECODE = {"parse", "parse copied bytes", "host staging", "bytes", "crc32"}
FGK = {"fgk strip", "fgk code bits", "fgk steps"}
STEPS = 4


def _cfg(entropy: str = "fgk") -> dict:
    cfg = fields(cells.find_cell(CELL).config)
    assert cfg["entropy"] == "fgk" and cfg["layout"] == "sharded"
    cfg.update(chunk_size=CHUNK, step_chunks=2, entropy=entropy)
    return cfg


def _timed(codec, fn, *args):
    codec.timer = StageTimer()
    try:
        out = fn(*args)
        codec.timer.resolve()
        return out, codec.timer
    finally:
        codec.timer = None


@pytest.fixture(scope="module")
def made():
    """(config, input, codec, container, the encode's timer)."""
    cell = cells.find_cell(CELL)
    mix = cell.mix
    mix["objects"].update(min_bytes=N_CHUNKS * CHUNK,
                          max_bytes=N_CHUNKS * CHUNK, tail_short=300)
    mix["data"][0]["random_block_max"] = CHUNK
    x = traffic.build(mix, SEED, CHUNK, "cpu").objects[-1]
    assert len(x) == N_CHUNKS * CHUNK - 300
    cfg = _cfg()
    codec = TorchCodec(CodecConfig(**cfg), device="cpu")
    blob, t = _timed(codec, codec.encode, x.tobytes())
    return cfg, x, codec, blob, t


def _judge(blob, x, cfg):
    got = reference.judge_encode(blob, x, cfg, "cpu",
                                 rng=np.random.default_rng(SEED),
                                 name=cells.find_cell(CELL).config[
                                     "reference"])
    assert got["bad_tables"] == 0 and got["v1"] == 0
    return got["bad_bytes"]


@pytest.mark.parametrize("control", [None, "lsb"])
def test_container_judged_by_the_reference(made, control):
    cfg, x, codec, blob, _ = made
    assert v3_fgk.chunks_judged(N_CHUNKS, np.random.default_rng(1)) == list(
        range(N_CHUNKS))  # every chunk judged, the short tail too
    if control is None:
        assert _judge(blob, x, cfg) == 0
    else:
        assert _judge(loop.Lossy(codec).encode(x.tobytes()), x, cfg) > 0


def test_decode_equals_input(made):
    _, x, codec, blob, _ = made
    assert codec.decode(blob) == x.tobytes()


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_code_bits_counter(made, kind):
    _, x, codec, blob, t = made
    if kind == "decode":
        out, t = _timed(codec, codec.decode, blob)
        assert out == x.tobytes()
    assert "fgk code bits" in t.counters
    assert t.stages["fgk code bits"] == v3_fgk.sizes(blob)["code_bits"] > 0


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_fgk_spans_recorded(made, kind):
    _, x, codec, blob, t = made
    if kind == "decode":
        _, t = _timed(codec, codec.decode, blob)
        # "fgk rows" is a device span: CUDA events, so not on the CPU
        assert set(t.stages) == DECODE | {"fgk code bits", "fgk steps"}
    else:
        assert set(t.stages) == ENCODE | FGK
        assert t.stages["fgk strip"] > 0
    assert t.stages["fgk steps"] == STEPS
    assert t.counters == ({"fgk code bits", "fgk steps"} if kind == "encode"
                          else {"fgk code bits", "fgk steps",
                                "parse copied bytes"})


@pytest.mark.parametrize("kind", ["encode", "decode"])
def test_canonical_records_no_fgk_name(made, kind):
    _, x, _, _, _ = made
    codec = TorchCodec(CodecConfig(**_cfg("canonical")), device="cpu")
    blob, t = _timed(codec, codec.encode, x.tobytes())
    if kind == "decode":
        out, t = _timed(codec, codec.decode, blob)
        assert out == x.tobytes()
    assert set(t.stages) == (ENCODE if kind == "encode" else DECODE)
    assert not [n for n in t.stages if n.startswith("fgk")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fgk_rows_on_the_card(made, cuda):
    cfg, x, _, _, _ = made
    codec = TorchCodec(CodecConfig(**cfg), device=cuda)
    blob, t = _timed(codec, codec.encode, x.tobytes())
    assert _judge(blob, x, cfg) == 0
    side = "fgk steps side by side"
    assert set(t.stages) == ENCODE | FGK | {"device", side}
    assert t.stages["fgk steps"] == t.stages[side] == STEPS
    out, t = _timed(codec, codec.decode, blob)
    assert out == x.tobytes()
    assert set(t.stages) == DECODE | {"device", "fgk rows", "fgk code bits",
                                      "fgk steps", side}
    assert t.stages["fgk steps"] == t.stages[side] == STEPS
    assert t.stages["fgk rows"] > 0
    assert t.stages["fgk code bits"] == v3_fgk.sizes(blob)["code_bits"]
