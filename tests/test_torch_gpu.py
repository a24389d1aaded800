"""The port's CUDA kernels and codec on a GPU, held against the plain
PyTorch versions. Imports no JAX, so it runs on a machine with a card:

    python -m pytest -o addopts="" -q tests/test_torch_gpu.py

Every test needs a CUDA device and skips without one. Integer codec:
every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from huffman_codec_tpu_torch import CodecConfig, TorchCodec  # noqa: E402
from huffman_codec_tpu_torch.ops import canonical as tcan  # noqa: E402
from huffman_codec_tpu_torch.ops import kernels as K  # noqa: E402
from huffman_codec_tpu_torch.ops import rle as trle  # noqa: E402

CS, LANE, CAP = 4096, 512, 8192
NL = CAP // LANE


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(dev):
    rng = np.random.default_rng(8)
    i = np.arange(CS)
    rows = [rng.integers(0, 256, CS), ((i // 64) * 3 + i % 64) & 255,
            np.r_[np.full(259, 7), np.full(516, 9), np.full(CS - 775, 1)],
            np.full(CS, 65), rng.integers(0, 2, CS), np.zeros(CS)]
    lens = [CS, CS, CS, CS, 1000, 0]
    return (torch.from_numpy(np.stack(rows).astype(np.uint8)).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev),
            torch.tensor([0, 1, 255, 65, 3, 0], dtype=torch.uint8, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("use_diff", [False, True])
def test_kernels_match_plain(cuda, use_diff):
    chunks, lens, carries = _rows(cuda)
    s, ln = K.rle_diff_encode(chunks, lens, carries, use_diff, CAP)
    ps, pln = K.rle_diff_encode_plain(chunks, lens, carries, use_diff, CAP)
    assert torch.equal(s, ps) and torch.equal(ln, pln)
    counts = K.histogram256(s, ln)
    assert torch.equal(counts, K.histogram256_plain(s, ln))
    lt = tcan.build_lengths_pm(counts)
    tables = (tcan.assign_codes(lt) | (lt << 26)).to(torch.int32)
    w, b = K.lane_pack(s, ln, tables, LANE)
    pw, pb = K.lane_pack_plain(s, ln, tables, LANE)
    assert torch.equal(w, pw) and torch.equal(b, pb)
    lw = ((b + 31) >> 5).to(torch.int32)
    col = torch.arange(w.shape[2], device=cuda)
    flat = w[col[None, None, :] < lw[:, :, None]].contiguous()
    wb = max(8, -(-int(lw.max()) // 16) * 16)
    r = K.repad_words(flat, lw, wb)
    assert torch.equal(r, K.repad_words_plain(flat, lw, wb))
    buf = r.view(-1, NL, wb)
    lt8 = lt.to(torch.uint8)
    d = K.lane_decode(buf, lt8, ln, LANE, 31)
    assert torch.equal(d, K.lane_decode_plain(buf, lt8, ln, LANE, 31))
    assert torch.equal(d, s)
    ic = trle.rle_classify(d, ln)
    o = K.rle_expand(d, ic, ln, carries, CS, use_diff)
    assert torch.equal(o, K.rle_expand_plain(d, ic, ln, carries, CS,
                                             use_diff))


@pytest.mark.cuda
def test_wrappers_count_launches(cuda):
    chunks, lens, carries = _rows(cuda)
    K.reset_launches()
    K.rle_diff_encode(chunks, lens, carries, False, CAP)
    K.histogram256(chunks, lens)
    assert K.launch_counts()["rle_diff_encode"] == 1
    assert K.launch_counts()["histogram256"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("use_diff", [False, True])
def test_gpu_container_equals_cpu_plain_path(cuda, use_diff):
    chunks, _, _ = _rows("cpu")
    data = chunks.numpy().tobytes()[: 5 * CS + 123]
    cfg = CodecConfig(use_diff=use_diff, chunk_size=CS, lane=LANE,
                      layout="sharded", step_chunks=2)
    gpu, cpu = TorchCodec(cfg), TorchCodec(cfg, device="cpu")
    blob = gpu.encode(data)
    assert blob == cpu.encode(data)
    assert gpu.decode(blob) == data
    assert gpu.decode_range(blob, CS - 7, 20) == data[CS - 7: CS + 13]
    assert gpu.encode(b"") == cpu.encode(b"")
