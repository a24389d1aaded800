"""The port's multi-GPU layer (``huffman_codec_tpu_torch.parallel.mesh``)
against the JAX package's mesh functions, on the CPU.

Worker processes run the port's five step functions over a gloo group
of 1, 2 and 4 ranks (one process a rank, the device the CPU, so every
kernel wrapper runs its plain version) and write each rank's gathered
outputs to an ``.npz``. This process runs the JAX functions on
``default_mesh(W)`` (the conftest's virtual CPU devices) on the same
numpy inputs, made from fixed seeds, and every array must be equal:
tolerance zero, these are integers and bytes. Every decode must return
the input at every W. A decoded chunk past its decoded length is the one
place the two packages differ by design (zero in the port, the last byte
repeated in JAX's with the diff model on): no caller reads those bytes,
so the stream decodes are held to JAX's up to the input's length, at
every W.

The ranks must agree with each other, and the container assembled from
the mesh outputs (diff on) must equal ``TPUCodec``'s and
``TorchCodec``'s bytes. Each worker has its own timeout; a worker that
fails fails the tests. The JAX shapes are few and all in this module
(the XLA:CPU crash note of ``tests/conftest.py``).
"""

import os
import pathlib
import socket
import subprocess
import sys
import zlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from huffman_codec_tpu.models import CodecConfig as JCodecConfig  # noqa: E402
from huffman_codec_tpu.models import TPUCodec  # noqa: E402
from huffman_codec_tpu.models.chunked import _n_words_for  # noqa: E402
from huffman_codec_tpu.parallel import mesh as jmesh  # noqa: E402
from huffman_codec_tpu_torch import CodecConfig, TorchCodec  # noqa: E402
from huffman_codec_tpu_torch.models.entropy import (  # noqa: E402
    CANONICAL, _strip_payload)

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLDS = (1, 2, 4)
WORKER_TIMEOUT = 150  # seconds a worker may take, the slowest (FGK) included

# name -> (chunk_size, n_chunks, lane, tail bytes cut, use_diff, entropy)
STREAM_CASES = {
    "canonical-64": (64, 4, 64, 0, True, "canonical"),
    "canonical-1024-diff": (1024, 8, 128, 301, True, "canonical"),
    "canonical-1024": (1024, 8, 128, 301, False, "canonical"),
    "fgk-256-diff": (256, 4, 64, 37, True, "fgk"),
}
# the adaptive case: width, band_h, bs, n_bands, lane
ADAPT = (128, 16, 8, 4, 64)


def _inputs() -> dict:
    """Seeded inputs: small-alphabet noise for the stream cases (as
    tests/test_multiprocess.py uses), a noisy gradient with runs for the
    adaptive one."""
    out = {}
    for i, (name, (cs, nc, _, cut, _, _)) in enumerate(STREAM_CASES.items()):
        raw = np.random.default_rng(7 + i).integers(0, 8, cs * nc,
                                                    dtype=np.uint8)
        raw[cs * nc - cut:] = 0
        out[name] = raw
    w, bh, _, nb, _ = ADAPT
    rng = np.random.default_rng(13)
    i = np.arange(nb * bh * w)
    g = (((i // w) + (i % w)) // 3 + rng.integers(-1, 2, i.size)) & 255
    g[500:1700] = 9
    out["adapt"] = g.astype(np.uint8)
    return out


WORKER = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[5])
from huffman_codec_tpu_torch.parallel import distributed as D
from huffman_codec_tpu_torch.parallel import mesh as M
from huffman_codec_tpu_torch.models.entropy import lookup
from huffman_codec_tpu_torch.ops.fgk import n_words_for

rank, world, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                             int(sys.argv[3]), sys.argv[4])
if world > 1:
    assert D.init_distributed(f"localhost:{port}", world, rank,
                              device="cpu")
else:  # init_distributed leaves a single process alone, as JAX's does
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=1,
        rank=0)
mesh = M.default_mesh(world, device="cpu")
assert (mesh.rank, mesh.size, mesh.backend) == (rank, world, "gloo")
inp = np.load(f"{outdir}/inputs.npz")
cases = %(cases)r
out = {}
for name, (cs, nc, lane, cut, diff, ent) in cases.items():
    data = torch.from_numpy(inp[name].copy())
    n = cs * nc - cut
    nw = n_words_for(lookup(ent).cap(cs, lane))
    enc = M.distributed_encode_step(data, n, mesh, cs, nw, use_diff=diff,
                                    entropy=ent, lane=lane)
    for k, a in zip(("a", "meta", "tables", "rle_lens", "carries"), enc):
        if a is not None:
            out[f"{name}.{k}"] = a.numpy()
    words = enc[0].reshape(nc, -1)
    out[f"{name}.decoded"] = M.distributed_decode_step(
        words, enc[3], enc[4], mesh, cs, tables=enc[2], lane_words=enc[1],
        use_diff=diff, entropy=ent, lane=lane).numpy()
w, bh, bs, nb, lane = %(adapt)r
x = torch.from_numpy(inp["adapt"].copy())
out["adapt.scores"] = M.distributed_adapt_search(x, mesh, w, bh).numpy()
enc = M.distributed_adapt_encode_step(x, mesh, w, bh, bs, True,
                                      "canonical", lane)
for k, a in zip(("buf", "lw", "tables", "totals", "dirs", "tile_lens",
                 "carries"), enc):
    out[f"adapt.{k}"] = a.numpy()
buf, lw, tables, totals, dirs, tl, car = enc
out["adapt.decoded"] = M.distributed_adapt_decode_step(
    buf.reshape(nb, -1), totals, tl, dirs, car, tables, lw, mesh, w, bh,
    bs, True, lane).numpy()
# no fallback: a CUDA device without a GPU raises
try:
    M.default_mesh(world)
    out["cuda_raises"] = np.array(torch.cuda.is_available())
except RuntimeError:
    out["cuda_raises"] = np.array(not torch.cuda.is_available())
# a block count that does not divide over the ranks raises, as JAX's does
try:
    M.distributed_encode_step(torch.zeros(3 * 64, dtype=torch.uint8), 192,
                              mesh, 64, 0, entropy="canonical", lane=64)
    out["odd_blocks_raise"] = np.array(world == 1)
except ValueError:
    out["odd_blocks_raise"] = np.array(world > 1)
np.savez(f"{outdir}/w{world}_r{rank}.npz", **out)
torch.distributed.destroy_process_group()
print("OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Workers:
    """Every world's workers, started together; ``runs()`` waits for them
    (once) and returns {world: [each rank's outputs]}, so a test can
    compile its JAX side while they run."""

    def __init__(self, d, inputs):
        self.d, self.inputs, self._runs = d, inputs, None
        np.savez(d / "inputs.npz", **inputs)
        script = d / "worker.py"
        script.write_text(WORKER % {"cases": STREAM_CASES, "adapt": ADAPT})
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = []
        for world in WORLDS:
            port = _free_port()
            self.procs += [(world, r, subprocess.Popen(
                [sys.executable, str(script), str(r), str(world), str(port),
                 str(d), str(REPO)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env))
                for r in range(world)]

    def runs(self) -> dict:
        if self._runs is None:
            try:
                for world, r, p in self.procs:
                    try:
                        out, err = p.communicate(timeout=WORKER_TIMEOUT)
                    except subprocess.TimeoutExpired:
                        pytest.fail(f"mesh worker {r} of {world} timed out "
                                    f"after {WORKER_TIMEOUT} s")
                    if p.returncode or "OK" not in out:
                        pytest.fail(f"mesh worker {r} of {world} exited "
                                    f"{p.returncode}:\n{err[-3000:]}")
            finally:
                self.close()
            self._runs = {w: [dict(np.load(self.d / f"w{w}_r{r}.npz"))
                              for r in range(w)] for w in WORLDS}
        return self._runs

    def close(self):
        for _, _, p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    w = _Workers(tmp_path_factory.mktemp("mesh"), _inputs())
    yield w
    w.close()


def _jax_encode(name, inp, world):
    cs, nc, lane, cut, diff, ent = STREAM_CASES[name]
    nw = _n_words_for(jmesh.sharded_cap(cs, ent, lane), ent, lane)
    return jmesh.distributed_encode_step(
        jnp.asarray(inp), jnp.int32(cs * nc - cut), jmesh.default_mesh(world),
        cs, nw, use_diff=diff, entropy=ent, lane=lane)


def _same(got, want, what):
    want = np.asarray(want)
    got = np.asarray(got)
    if want.dtype == np.uint32 and got.dtype == np.int32:
        got = got.view(np.uint32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_stream_encode_matches_jax(workers, name, world):
    """``distributed_encode_step`` at W ranks: every gathered output
    equals JAX's on default_mesh(W), zero carries without diff
    included."""
    enc = _jax_encode(name, workers.inputs[name], world)
    got = workers.runs()[world][0]
    for k, want in zip(("a", "meta", "tables", "rle_lens", "carries"), enc):
        if want is None:
            assert f"{name}.{k}" not in got
            continue
        _same(got[f"{name}.{k}"], want, f"{name}.{k} at world {world}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_stream_decode_returns_input(workers, name, world):
    """``distributed_decode_step`` at W ranks returns the input, zero
    past each chunk's decoded length, the same bytes at every W."""
    inputs, runs = workers.inputs, workers.runs()
    cs, nc, _, cut, _, _ = STREAM_CASES[name]
    n = cs * nc - cut
    dec = runs[world][0][f"{name}.decoded"]
    assert dec.shape == (cs * nc,)
    assert dec[:n].tobytes() == inputs[name][:n].tobytes()
    assert not dec[n:].any()
    _same(dec, runs[1][0][f"{name}.decoded"], f"{name} at {world} vs 1")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(STREAM_CASES))
def test_stream_decode_matches_jax(workers, name, world):
    """The decode at W ranks against JAX's on default_mesh(W), up to the
    input's length (past it JAX's repeats the last byte with the diff
    model on; the port writes zeros)."""
    cs, nc, lane, cut, diff, ent = STREAM_CASES[name]
    n = cs * nc - cut
    buf, meta, tables, rle_lens, carries = _jax_encode(
        name, workers.inputs[name], world)
    jdec = jmesh.distributed_decode_step(
        buf.reshape(nc, -1), rle_lens.astype(jnp.int32), carries,
        jmesh.default_mesh(world), cs, tables=tables, lane_words=meta,
        use_diff=diff, entropy=ent, lane=lane)
    dec = workers.runs()[world][0][f"{name}.decoded"]
    assert dec.shape == jdec.shape
    _same(dec[:n], np.asarray(jdec)[:n], f"{name}.decoded at world {world}")


@pytest.mark.parametrize("world", WORLDS)
def test_adapt_steps_match_jax(workers, world):
    """The adaptive search (its scores depend on the world size, so JAX
    runs at the same W), encode and decode at W ranks against JAX's."""
    w, bh, bs, nb, lane = ADAPT
    mesh = jmesh.default_mesh(world)
    x = jnp.asarray(workers.inputs["adapt"])
    scores = jmesh.distributed_adapt_search(x, mesh, w, bh, True)
    enc = jmesh.distributed_adapt_encode_step(x, mesh, w, bh, bs, True,
                                              "canonical", lane)
    got = workers.runs()[world][0]
    _same(got["adapt.scores"], scores, f"adapt.scores at world {world}")
    for k, want in zip(("buf", "lw", "tables", "totals", "dirs",
                        "tile_lens", "carries"), enc):
        _same(got[f"adapt.{k}"], want, f"adapt.{k} at world {world}")
    buf, lw, tables, totals, dirs, tl, car = enc
    jdec = jmesh.distributed_adapt_decode_step(
        buf.reshape(nb, -1), totals, tl, dirs, car, tables, lw, mesh, w, bh,
        bs, True, lane)
    _same(got["adapt.decoded"], jdec, f"adapt.decoded at world {world}")
    assert got["adapt.decoded"].tobytes() == workers.inputs["adapt"].tobytes()


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree(workers, world):
    """Every rank returns the same gathered outputs, replicated; a block
    count that does not divide over the ranks raises, and so does a mesh
    on a CUDA device where there is none."""
    ranks = workers.runs()[world]
    for r, other in enumerate(ranks[1:], 1):
        assert other.keys() == ranks[0].keys()
        for k in ranks[0]:
            _same(other[k], ranks[0][k], f"{k}: rank {r} of {world}")
    assert all(bool(o["odd_blocks_raise"]) for o in ranks)
    assert all(bool(o["cuda_raises"]) for o in ranks)


def _assemble(codec, got, name, raw, n):
    """The v3 sharded container from a mesh encode's gathered canonical
    columns, as ``TorchCodec.encode`` assembles its steps."""
    buf, lw, tables, rl, car = (got[f"{name}.{k}"] for k in
                                ("a", "meta", "tables", "rle_lens",
                                 "carries"))
    payload = CANONICAL.wire(_strip_payload(torch.from_numpy(buf),
                                            torch.from_numpy(lw))[
                                                : int(lw.sum())])
    return codec._container(payload, n, int(rl.sum()),
                            (lw.sum(axis=1, dtype=np.int64) * 32).tolist(),
                            tables, lw, (rl, car), zlib.crc32(raw[:n]))


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_container_equals_codecs(workers, world):
    """The container assembled from W ranks' encode (diff on, a partial
    tail chunk) equals ``TPUCodec.encode`` and ``TorchCodec.encode`` byte
    for byte, and both packages decode it."""
    name = "canonical-1024-diff"
    cs, nc, lane, cut, diff, ent = STREAM_CASES[name]
    n = cs * nc - cut
    raw = workers.inputs[name]
    kw = dict(use_diff=diff, chunk_size=cs, lane=lane, entropy=ent,
              layout="sharded")
    jcodec = TPUCodec(JCodecConfig(**kw))
    want = jcodec.encode(raw[:n].tobytes())
    codec = TorchCodec(CodecConfig(**kw), device="cpu")
    blob = _assemble(codec, workers.runs()[world][0], name, raw, n)
    assert blob == want
    assert blob == codec.encode(raw[:n].tobytes())
    assert codec.decode(blob) == raw[:n].tobytes()
    assert jcodec.decode(blob) == raw[:n].tobytes()
