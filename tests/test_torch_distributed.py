"""The port's process-group glue and elastic re-dispatch
(``huffman_codec_tpu_torch.parallel.distributed``) against the JAX
package's (``huffman_codec_tpu.parallel.distributed``), on the CPU: the
chunk plans and recovery sets are the same, a single process is left
alone, the backend is the caller's, and a host's lost chunk range
re-encoded alone splices into a container byte-equal to both packages'
``encode``. A fresh interpreter importing the subpackage loads no JAX.
"""

import pathlib
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from huffman_codec_tpu.models import CodecConfig as JCodecConfig  # noqa: E402
from huffman_codec_tpu.models import TPUCodec  # noqa: E402
from huffman_codec_tpu.parallel import distributed as jdist  # noqa: E402
from huffman_codec_tpu_torch import CodecConfig, TorchCodec  # noqa: E402
from huffman_codec_tpu_torch.models.entropy import lookup  # noqa: E402
from huffman_codec_tpu_torch.parallel import distributed as tdist  # noqa: E402
from huffman_codec_tpu_torch.parallel import mesh as tmesh  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def _fields(plan):
    return [(r.host, r.start, r.stop) for r in plan]


@pytest.mark.parametrize("n_chunks,n_hosts", [
    (10, 3), (2, 4), (8, 2), (0, 3), (1024, 4), (7, 7), (1, 1)])
def test_plan_chunk_ranges_matches_jax(n_chunks, n_hosts):
    got = tdist.plan_chunk_ranges(n_chunks, n_hosts)
    assert _fields(got) == _fields(jdist.plan_chunk_ranges(n_chunks, n_hosts))
    assert all(isinstance(r, tdist.ChunkRange) for r in got)


@pytest.mark.parametrize("n_chunks,done", [
    (5, {0, 2, 4}), (3, {0, 1, 2}), (8, set()), (4, {3})])
def test_missing_chunks_matches_jax(n_chunks, done):
    assert (tdist.missing_chunks(n_chunks, done)
            == jdist.missing_chunks(n_chunks, done))


def test_init_distributed_single_process(monkeypatch):
    """Without a coordinator, or with one process, nothing is initialised
    and both packages return False."""
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    assert tdist.init_distributed() is jdist.init_distributed() is False
    assert tdist.init_distributed("localhost:1", 1, 0) is False
    assert jdist.init_distributed("localhost:1", 1, 0) is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist.init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_backend_is_the_callers():
    """An unknown backend, nccl on the CPU, and nccl without a GPU raise
    before any group is made; nothing falls back to another backend."""
    with pytest.raises(ValueError, match="unknown backend"):
        tdist.init_distributed("localhost:1", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="nccl runs on CUDA"):
        tdist.init_distributed("localhost:1", 2, 0, device="cpu",
                               backend="nccl")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nccl would start a group")
    with pytest.raises(RuntimeError, match="nccl needs a CUDA device"):
        tdist.init_distributed("localhost:1", 2, 0)
    assert not torch.distributed.is_initialized()


def test_default_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.default_mesh(device="cpu")


def test_sharded_cap_matches_jax():
    from huffman_codec_tpu.parallel.mesh import sharded_cap

    for cs, ent, lane in [(65536, "canonical", 512), (1024, "canonical", 128),
                          (1000, "canonical", 100), (256, "fgk", 64),
                          (65536, "fgk", 512)]:
        assert lookup(ent).cap(cs, lane) == sharded_cap(cs, ent, lane)


def test_elastic_redispatch_roundtrip():
    """The recovery drill of tests/test_distributed.py on the port: host
    1 of 2 is lost before it reports, ``missing_chunks`` names its range,
    which host 0 re-encodes alone (``encode_chunk_range``, restartable
    through its carry byte) and splices in. The container equals
    ``TPUCodec.encode``'s and ``TorchCodec.encode``'s bytes and decodes
    in both packages."""
    cs, n_chunks = 1024, 8
    rng = np.random.default_rng(11)
    raw = bytes(rng.integers(0, 12, cs * n_chunks - 301, dtype=np.uint8))
    kw = dict(use_diff=True, chunk_size=cs, lane=128, entropy="canonical",
              layout="sharded")
    codec = TorchCodec(CodecConfig(**kw), device="cpu")

    plan = tdist.plan_chunk_ranges(n_chunks, 2)
    done: set[int] = set()
    parts: dict[int, tuple] = {}
    for r in plan:
        if r.host == 1:
            continue  # host 1 dies before reporting
        parts[r.start] = codec.encode_chunk_range(raw, r.start, r.stop)
        done.update(range(r.start, r.stop))
    todo = tdist.missing_chunks(n_chunks, done)
    assert todo == list(range(plan[1].start, plan[1].stop))
    parts[todo[0]] = codec.encode_chunk_range(raw, todo[0], todo[-1] + 1)

    # (lane_buf, lane_words, tables, rle_lens, carries), in chunk order
    buf, lw, tables, rle_lens, carries = (
        np.concatenate([parts[k][i].numpy() for k in sorted(parts)])
        for i in range(5))
    col = np.arange(buf.shape[2])
    payload = b"".join(
        buf[c].view(np.uint32).astype(">u4")[col[None, :] < lw[c][:, None]]
        .tobytes() for c in range(n_chunks))
    blob = codec._container(
        payload, len(raw), int(rle_lens.sum()),
        (lw.sum(axis=1, dtype=np.int64) * 32).tolist(), tables, lw,
        (rle_lens, carries), zlib.crc32(raw))
    jcodec = TPUCodec(JCodecConfig(**kw))
    assert blob == jcodec.encode(raw), "recovered container != JAX's"
    assert blob == codec.encode(raw), "recovered container != the port's"
    assert codec.decode(blob) == raw
    assert jcodec.decode(blob) == raw


def test_import_loads_no_jax():
    """The subpackage stands alone: a fresh interpreter that imports it
    has no ``jax`` and no module of the JAX package loaded."""
    code = (
        "import sys\n"
        "import huffman_codec_tpu_torch.parallel\n"
        "import huffman_codec_tpu_torch.parallel.distributed\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith('jax.') or m == 'huffman_codec_tpu'"
        " or m.startswith('huffman_codec_tpu.'))\n"
        "print(','.join(bad) or 'CLEAN')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "CLEAN", r.stdout
