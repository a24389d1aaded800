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
from huffman_codec_tpu_torch.ops import adapt as tad  # noqa: E402
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


def _fat_lanes(dev, lane, nl):
    """Chunks of ``nl`` fat lanes packed and re-padded for the decoders: a
    full random chunk, a partial last lane, an empty chunk, a one-symbol
    table, two symbols one byte short of full."""
    rng = np.random.default_rng(9)
    L = nl * lane
    i = np.arange(L)
    rows = [rng.integers(0, 256, L), ((i // 512) * 2 + i % 512 // 3) & 255,
            np.zeros(L), np.full(L, 65), rng.integers(0, 2, L)]
    lens = [L, L - lane + 1000, 0, L, L - 1]
    chunks = torch.from_numpy(np.stack(rows).astype(np.uint8)).to(dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    lt = tcan.build_lengths_pm(K.histogram256(chunks, ln))
    tables = (tcan.assign_codes(lt) | (lt << 26)).to(torch.int32)
    w, b = K.lane_pack(chunks, ln, tables, lane)
    lw = ((b + 31) >> 5).to(torch.int32)
    col = torch.arange(w.shape[2], device=dev)
    flat = w[col[None, None, :] < lw[:, :, None]].contiguous()
    wb = max(8, -(-int(lw.max()) // 16) * 16)
    buf = K.repad_words(flat, lw, wb).view(len(rows), nl, wb)
    return chunks, ln, buf, lt.to(torch.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("lane,nl", [(8192, 2), (8192, 1), (4224, 3)])
def test_lanemajor_kernel_matches_plain(cuda, lane, nl):
    chunks, ln, buf, lt8 = _fat_lanes(cuda, lane, nl)
    K.reset_launches()
    d = K.lane_decode_lanemajor(buf, lt8, ln, lane, 31)
    assert K.launch_counts()["lane_decode_lanemajor"] == 1
    assert torch.equal(d, K.lane_decode_lanemajor_plain(buf, lt8, ln, lane,
                                                         31))
    assert torch.equal(d, K.lane_decode(buf, lt8, ln, lane, 31))
    valid = torch.arange(nl * lane, device=cuda)[None, :] < ln[:, None]
    assert torch.equal(d, torch.where(valid, chunks, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("use_diff", [False, True])
@pytest.mark.parametrize("n", [1 << 18, (1 << 18) + 4321])
def test_gpu_global_container_equals_cpu_plain_path(cuda, use_diff, n):
    i = np.arange(n)
    rng = np.random.default_rng(10)
    data = (((i // 512) * 3 + (i % 512) * 2) // 5
            + rng.integers(-2, 3, n) & 255).astype(np.uint8).tobytes()
    cfg = CodecConfig(use_diff=use_diff)
    gpu = TorchCodec(cfg)
    K.reset_launches()
    blob = gpu.encode(data)
    assert blob == TorchCodec(cfg, device="cpu").encode(data)
    assert gpu.decode(blob) == data
    assert blob[:6] == b"HCTPU\x03"  # too large for the v1 race
    hdr = gpu._parse(blob)
    fat = hdr["n_chunks"] == 1 and hdr["lane"] > 4096
    assert K.launch_counts()["lane_decode_lanemajor"] == int(fat)


def _image(rows, width, seed):
    rng = np.random.default_rng(seed)
    i = np.arange(rows * width)
    x = ((((i // width) * 3 + (i % width) * 2) // 5
          + rng.integers(-1, 2, i.size)) & 255).astype(np.uint8)
    x[1000:4000] = 5  # a run across many tiles
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 1024, 4096])
def test_tile_mode_kernel_matches_plain(cuda, tile):
    rng = np.random.default_rng(11)
    rows = np.stack([_image(8, 512, 12), rng.integers(0, 256, CS),
                     np.full(CS, 7), rng.integers(0, 2, CS),
                     np.r_[np.full(258, 3), np.full(259, 4),
                           np.zeros(CS - 517)]]).astype(np.uint8)
    chunks = torch.from_numpy(rows).to(cuda)
    lens = torch.tensor([CS, CS, CS, 1000, CS], dtype=torch.int32,
                        device=cuda)
    zero = torch.zeros(5, dtype=torch.uint8, device=cuda)
    K.reset_launches()
    s, ln = K.rle_diff_encode(chunks, lens, zero, False, CAP, tile=tile)
    counts = K.launch_counts()
    assert counts[K.TILE_MODE] == 1 and counts["rle_diff_encode"] == 0
    ps, pln = K.rle_diff_encode_plain(chunks, lens, zero, False, CAP, tile)
    assert torch.equal(ln, pln) and torch.equal(s, ps)
    with pytest.raises(ValueError):
        K.rle_diff_encode(chunks, lens, zero, True, CAP, tile=tile)


@pytest.mark.cuda
def test_group_walk_kernel_matches_plain(cuda):
    x = torch.from_numpy(_image(72, 64, 13)).to(cuda)
    stream, total, _, tl = tad.adapt_encode_fixed(x, 64, 72, 8,
                                                  with_header=False)
    offs = (torch.cumsum(tl, 0) - tl)[:: tad.GROUP_K].to(torch.int32)
    sizes = torch.zeros(2 * tad.GROUP_K, dtype=torch.int32, device=cuda)
    sizes[:72] = 64
    cap = tad.GROUP_K * trle.rle_max_encoded_len(64)
    K.reset_launches()
    got = K.group_tile_lens(stream, offs.contiguous(), sizes, int(total), cap)
    assert K.launch_counts()["group_tile_lens"] == 1
    assert torch.equal(got, K.group_tile_lens_plain(stream, offs, sizes,
                                                    int(total), cap))
    assert torch.equal(got[:72], tl) and not got[72:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("use_diff", [False, True])
@pytest.mark.parametrize("layout", ["sharded", "global"])
def test_gpu_adaptive_container_equals_cpu_plain_path(cuda, layout, use_diff):
    # 69 rows in bands of 16: four full bands (the tile-mode kernel) and a
    # 5-row tail (the torch-op tile encode)
    rows, width = (69, 64) if layout == "sharded" else (512, 512)
    data = _image(rows, width, 14).tobytes()
    cfg = CodecConfig(use_adapt=True, use_diff=use_diff, width=width,
                      chunk_size=16 * width if layout == "sharded" else 65536,
                      lane=64 if layout == "sharded" else 512, layout=layout)
    gpu = TorchCodec(cfg)
    K.reset_launches()
    blob = gpu.encode(data)
    assert K.launch_counts()[K.TILE_MODE] == int(layout == "sharded")
    assert blob == TorchCodec(cfg, device="cpu").encode(data)
    assert gpu.decode(blob) == data
    if layout == "sharded":
        assert gpu.decode_range(blob, 1000, 2000) == data[1000:3000]
    else:
        walks = K.launch_counts()["group_tile_lens"]
        v3 = gpu._encode_global(data, 8, True)  # 4096 tiles: grouped
        assert gpu._parse(v3)["flags"] & 0x10
        assert v3 == TorchCodec(cfg, device="cpu")._encode_global(data, 8,
                                                                  True)
        assert gpu.decode(v3) == data
        assert K.launch_counts()["group_tile_lens"] == walks + 1
