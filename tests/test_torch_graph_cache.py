"""The sharded stream encode's step geometries, on the CPU.

``encode_step_chunks`` is the policy that bounds a ``TorchCodec``'s CUDA
graphs (one per encode step geometry, ``step_graph_bound``) whatever the
sizes of its inputs: an input of a step or more runs full steps, a
shorter one a step of its chunk count rounded up to a power of two, the
chunks past the input zero-padded. The policy runs on every device, so
the containers here, made on the CPU's plain path at the policy's edges
(``step_chunks`` 8: one to nine chunks, each input ending in a partial
chunk), must be byte-equal to the JAX package's ``TPUCodec`` and decode
both ways.

The JAX side encodes and decodes at ``step_chunks`` 1: its containers do
not depend on the step, and one step geometry keeps the XLA:CPU compiles
few (tests/conftest.py's note). Integer codec: every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from huffman_codec_tpu.models import chunked as jch  # noqa: E402
from huffman_codec_tpu_torch import TorchCodec, config_from_fields  # noqa: E402
from huffman_codec_tpu_torch.models.chunked import (  # noqa: E402
    encode_step_chunks, step_graph_bound)

CS, LANE, STEP = 1024, 128, 8


@pytest.mark.parametrize("step_chunks", [256, 16, 8, 3, 1, None])
def test_step_geometries_stay_within_the_bound(step_chunks):
    """For every input of 1 to 1024 chunks: the step covers the input in
    as few steps as before, a short input's step is a power of two below
    twice its chunks, and the distinct step geometries number exactly
    ``step_graph_bound`` (none with ``step_chunks`` None, which runs
    each input as a step of its own count, eagerly)."""
    geometries = set()
    for n in range(1, 1025):
        S = encode_step_chunks(n, step_chunks)
        steps = -(-n // S)
        assert (steps - 1) * S < n <= steps * S
        if step_chunks is None:
            assert S == n
            continue
        if n >= step_chunks:
            assert S == step_chunks
        else:
            assert n <= S < 2 * n and (S & (S - 1) == 0 or S == step_chunks)
        geometries.add(S)
    if step_chunks is None:
        assert step_graph_bound(None) == 0
    else:
        assert len(geometries) == step_graph_bound(step_chunks)
        assert max(geometries) == step_chunks
    if step_chunks == 256:
        assert step_graph_bound(256) == 9


def _input(n_chunks: int, seed: int) -> bytes:
    """A seeded gradient of ``n_chunks`` chunks, the last partial (one
    kind of data: each lane stride or code-length bucket the JAX decode
    meets is one more XLA:CPU compile)."""
    rng = np.random.default_rng(seed)
    n = (n_chunks - 1) * CS + int(rng.integers(1, CS))
    i = np.arange(n)
    return (((i // 64) * 3 + (i % 64) // 2 + rng.integers(-3, 4, n))
            & 255).astype(np.uint8).tobytes()


@pytest.fixture(scope="module")
def jax_codecs():
    return {d: jch.TPUCodec(jch.CodecConfig(
        use_diff=d, chunk_size=CS, lane=LANE, layout="sharded",
        step_chunks=1)) for d in (False, True)}


@pytest.mark.parametrize("use_diff", [False, True],
                         ids=["nodiff", "diff"])
@pytest.mark.parametrize("n_chunks", [1, 2, 3, 4, 5, 8, 9])
def test_padded_steps_byte_equal_to_jax_and_cross_decode(
        jax_codecs, n_chunks, use_diff):
    jc = jax_codecs[use_diff]
    cfg = dataclasses.replace(
        config_from_fields(dataclasses.asdict(jc.config)), step_chunks=STEP)
    tc = TorchCodec(cfg, device="cpu")
    data = _input(n_chunks, 100 + n_chunks)
    outs = tc.dispatch_sharded(data)
    S = encode_step_chunks(n_chunks, STEP)
    assert [o[1].shape[0] for o in outs] == [S] * -(-n_chunks // S)
    got = tc.fetch_sharded(data, outs)
    assert got == tc.encode(data)
    want = jc.encode(data)
    assert got == want
    assert tc.decode(want) == data
    assert jc.decode(got) == data
    assert tc._graphs == {}  # the CPU runs eagerly
