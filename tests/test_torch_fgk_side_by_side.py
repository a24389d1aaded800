"""The FGK steps of one request side by side (``models/pipeline.py``:
``SideBySide``, ``side_by_side_width``; the FGK coder's schedule,
``models/entropy.py``, in ``TorchCodec.dispatch_sharded`` and
``_run_decode``). Imports no JAX, so the card tests run on a machine with
a card:

    python -m pytest -o addopts="" -q tests/test_torch_fgk_side_by_side.py

* The width rule: as many steps as the card holds the FGK kernels' blocks
  of, at least one (CPU).
* On a card (skipped without one): an FGK sharded input of 10 steps with
  a random block and a short last chunk encodes to the same bytes side
  by side as with the width forced to 1, decodes exactly either way, and
  counts every step side by side; ten back-to-back round trips of
  differing sizes stay exact (the side streams' allocator lifetimes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from huffman_codec_tpu_torch import CodecConfig, TorchCodec  # noqa: E402
from huffman_codec_tpu_torch.models.entropy import FGK  # noqa: E402
from huffman_codec_tpu_torch.models.pipeline import (  # noqa: E402
    side_by_side_width)
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.utils.profiling import StageTimer  # noqa: E402

CS, S = 65536, 8
STEPS = 10
N = (STEPS * S - 5) * CS + 1234  # 76 chunks, the last of 1,234 bytes
SIDE = "fgk steps side by side"


@pytest.mark.parametrize("resident,S_,width", [
    (3432, 256, 13),  # an H100's 26 blocks an SM x 132 SMs at 256 chunks
    (100, 256, 1),  # a step wider than the card: one at a time
    (0, 256, 1),  # no occupancy read: still one
    (3432, 8, 429)])
def test_width_rule(resident, S_, width):
    assert side_by_side_width(resident, S_) == width


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _input(n: int, seed: int) -> bytes:
    """A gradient with noise and a random block of 100,000 bytes."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    x = ((i // 97 + (i % 4096) // 16 + rng.integers(-3, 4, n)) & 255)
    at = int(rng.integers(0, max(1, n - 100_000)))
    x[at: at + 100_000] = rng.integers(0, 256, min(100_000, n - at))
    return x.astype(np.uint8).tobytes()


def _codec(dev):
    return TorchCodec(CodecConfig(layout="sharded", chunk_size=CS, lane=512,
                                  step_chunks=S, use_diff=True,
                                  entropy="fgk"), device=dev)


def _one_at_a_time(fn, *args):
    """``fn(*args)`` with the FGK steps' width forced to 1: every step on
    one stream."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FGK, "width", staticmethod(lambda xf, S_: 1))
        return fn(*args)


@pytest.mark.cuda
def test_side_by_side_equals_one_at_a_time(cuda):
    codec = _codec(cuda)
    data = _input(N, 21)
    assert K.fgk_resident_blocks(torch.cuda.current_device()) >= S * STEPS
    codec.timer = StageTimer()
    blob = codec.encode(data)
    codec.timer.resolve()
    enc = codec.timer.stages
    assert enc["fgk steps"] == enc[SIDE] == STEPS
    assert enc["device"] > 0
    codec.timer = StageTimer()
    assert codec.decode(blob) == data
    codec.timer.resolve()
    dec = codec.timer.stages
    assert dec["fgk steps"] == dec[SIDE] == STEPS
    codec.timer = None
    assert _one_at_a_time(codec.encode, data) == blob
    hdr, staged = codec.stage_decode_steps(blob)
    flat = _one_at_a_time(codec._run_decode, hdr, staged)
    assert flat[:N].cpu().numpy().tobytes() == data


@pytest.mark.cuda
def test_back_to_back_round_trips_stay_exact(cuda):
    codec = _codec(cuda)
    sizes = [N, 3 * CS + 7, N // 2, S * CS, 1, 2 * S * CS + 1,
             N - 4 * CS, 5 * CS, N // 3, 17 * CS + 4095]
    datas = [_input(n, 100 + k) for k, n in enumerate(sizes)]
    blobs = [codec.encode(d) for d in datas]
    outs = [codec.decode(b) for b in blobs]
    assert outs == datas
    assert [_one_at_a_time(codec.encode, d) for d in datas] == blobs
