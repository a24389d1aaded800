"""The port's step pipeline on the sharded stream path, on the CPU.

* The fixed-shape payload strip (``_strip_payload``: a scatter at offsets
  from a cumsum, no host synchronisation) against the boolean-mask strip
  it replaced, on seeded lane words: all-zero chunks, full lanes, one
  chunk, lane 8.
* The pipelined ``TorchCodec.encode`` (every step dispatched before any
  fetch, the two-wave fetch) byte-equal to the JAX package's ``TPUCodec``
  at ``step_chunks`` None, 1, 2 and 3 on an input whose last step is
  short and whose last chunk is partial, diff on and off, canonical and
  FGK entropy; each package decodes the other's containers.
* The order: every step is dispatched before the first fetch, in the
  encode and in the decode; the global layout fetches both candidates'
  manifests before either payload.

On the CPU the same loop runs eagerly on the plain versions: no pinned
memory, streams or CUDA graphs. Integer codec: every comparison is exact.
The JAX shapes are kept few (one chunk geometry; tests/conftest.py's
note on XLA:CPU).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from huffman_codec_tpu.models import chunked as jch  # noqa: E402
from huffman_codec_tpu_torch import TorchCodec, config_from_fields  # noqa: E402
from huffman_codec_tpu_torch.models import chunked as tch  # noqa: E402
from huffman_codec_tpu_torch.ops.kernels import lane_words_cap  # noqa: E402
from huffman_codec_tpu_torch.utils.profiling import StageTimer  # noqa: E402

CS, LANE = 512, 64
# 7 chunks, the last of 345 bytes: step_chunks 2 and 3 end on a short step
N = 6 * CS + 345


def _input() -> bytes:
    rng = np.random.default_rng(10)
    i = np.arange(N)
    x = (((i // 64) * 3 + (i % 64) // 2 + rng.integers(-2, 3, N))
         & 255).astype(np.uint8)
    x[2 * CS: 3 * CS] = rng.integers(0, 256, CS)  # an incompressible chunk
    x[4 * CS + 50: 4 * CS + 450] = 9  # a long run
    return x.tobytes()


DATA = _input()


def _mask_strip(buf, lw):
    col = torch.arange(buf.shape[2])
    return buf[col[None, None, :] < lw[:, :, None]]


def _lane_words(C, nl, W, seed):
    """Seeded lane words: random lengths, an all-zero chunk, full lanes
    (W - 1 words, the lane pack's most, and W) and empty lanes."""
    rng = np.random.default_rng(seed)
    lw = rng.integers(0, W + 1, (C, nl)).astype(np.int32)
    lw[:, 0] = W - 1
    lw[:, -1] = W
    if nl > 2:
        lw[:, 1] = 0
    if C > 1:
        lw[1] = 0
    return lw


@pytest.mark.parametrize("C,nl,lane", [(5, 4, 512), (1, 3, 512),
                                       (4, 16, 8), (1, 1, 8)])
def test_fixed_shape_strip_equals_mask_strip(C, nl, lane):
    W = lane_words_cap(lane)
    rng = np.random.default_rng(C * 100 + nl)
    buf = torch.from_numpy(rng.integers(-2**31, 2**31, (C, nl, W),
                                        dtype=np.int64).astype(np.int32))
    lw = torch.from_numpy(_lane_words(C, nl, W, C + nl))
    got = tch._strip_payload(buf, lw)
    want = _mask_strip(buf, lw)
    k = int(lw.sum())
    assert got.shape == (C * nl * W,) and got.dtype == torch.int32
    assert torch.equal(got[:k], want)
    assert not got[k:].any()


def _jcfg(step_chunks, use_diff, entropy):
    return jch.CodecConfig(use_diff=use_diff, chunk_size=CS, lane=LANE,
                           layout="sharded", step_chunks=step_chunks,
                           entropy=entropy)


def _port(jcfg):
    return TorchCodec(config_from_fields(dataclasses.asdict(jcfg)),
                      device="cpu")


CASES = [(s, d, e) for e in ("canonical", "fgk") for d in (False, True)
         for s in (None, 1, 2, 3)]
IDS = [f"{e}-{'diff' if d else 'nodiff'}-S{s}" for s, d, e in CASES]


@pytest.mark.parametrize("step_chunks,use_diff,entropy", CASES, ids=IDS)
def test_pipelined_encode_byte_equal_to_jax_and_cross_decodes(
        step_chunks, use_diff, entropy):
    jcfg = _jcfg(step_chunks, use_diff, entropy)
    jc, tc = jch.TPUCodec(jcfg), _port(jcfg)
    got = tc.encode(DATA)
    want = jc.encode(DATA)
    assert got == want
    assert tc.decode(want) == DATA
    assert jc.decode(got) == DATA
    assert tc._graphs == {}  # the CPU runs eagerly


def _logged(log, name, fn):
    def wrapped(*a, **k):
        log.append(name)
        return fn(*a, **k)
    return wrapped


@pytest.mark.parametrize("entropy", ["canonical", "fgk"])
def test_every_step_dispatched_before_the_first_fetch(monkeypatch, entropy):
    tc = _port(_jcfg(2, True, entropy))
    want = tc.encode(DATA)
    log = []
    monkeypatch.setattr(tch, "_encode_step",
                        _logged(log, "step", tch._encode_step))
    monkeypatch.setattr(tc._xfer, "fetch",
                        _logged(log, "fetch", tc._xfer.fetch))
    assert tc.encode(DATA) == want
    assert log.count("step") == 4
    assert log.index("fetch") > max(i for i, e in enumerate(log)
                                    if e == "step")

    log.clear()
    monkeypatch.setattr(tc, "_stage_step",
                        _logged(log, "stage", tc._stage_step))
    monkeypatch.setattr(tc, "_decode_step",
                        _logged(log, "decode", tc._decode_step))
    assert tc.decode(want) == DATA
    assert log.count("stage") == log.count("decode") == 4
    last = {e: max(i for i, f in enumerate(log) if f == e) for e in log}
    assert last["stage"] < log.index("decode")
    assert last["decode"] < log.index("fetch")


def test_global_candidates_fetched_in_two_waves(monkeypatch):
    tc = TorchCodec(config_from_fields(dataclasses.asdict(
        jch.CodecConfig(chunk_size=CS, lane=LANE))), device="cpu")
    want = tc.encode(DATA)
    log = []
    for name in ("_start_fetch", "_presplice_payload", "_assemble_global"):
        monkeypatch.setattr(tc, name, _logged(log, name, getattr(tc, name)))
    assert tc.encode(DATA) == want
    assert log == ["_start_fetch"] * 2 + ["_presplice_payload"] * 2 + [
        "_assemble_global"] * 2


def test_stage_split_names_on_the_cpu():
    tc = _port(_jcfg(2, False, "canonical"))
    tc.timer = StageTimer()
    blob = tc.encode(DATA)
    assert tc.decode(blob) == DATA
    tc.timer.resolve()
    # the device stages are CUDA events: none on the CPU
    assert set(tc.timer.stages) == {"host staging", "payload", "crc32",
                                    "container", "parse", "bytes",
                                    "parse copied bytes"}


@pytest.mark.parametrize("entropy", ["canonical", "fgk"])
def test_fgk_steps_counted_on_the_cpu(entropy):
    """A multi-step FGK encode and decode count their ``fgk steps`` and no
    step side by side (the CPU has no streams; each step runs in place),
    with the container unchanged; a canonical round trip counts no
    ``fgk steps``."""
    jcfg = _jcfg(2, True, entropy)
    tc = _port(jcfg)
    tc.timer = StageTimer()
    blob = tc.encode(DATA)
    assert blob == jch.TPUCodec(jcfg).encode(DATA)
    enc = tc.timer.stages
    tc.timer = StageTimer()
    assert tc.decode(blob) == DATA
    for st in (enc, tc.timer.stages):
        assert not st.get("fgk steps side by side")
        assert st.get("fgk steps") == (4 if entropy == "fgk" else None)
