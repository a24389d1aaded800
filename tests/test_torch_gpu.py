"""The port's CUDA kernels and codec on a GPU, held against the plain
PyTorch versions. Imports no JAX, so it runs on a machine with a card:

    python -m pytest -o addopts="" -q tests/test_torch_gpu.py

Every test needs a CUDA device and skips without one. Integer codec:
every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from huffman_codec_tpu_torch import CodecConfig, TorchCodec, V1Codec  # noqa: E402
from huffman_codec_tpu_torch.edge_cases import (  # noqa: E402
    ODD_CONFIGS, broken_adapt_v1_blobs, fgk_deep_row, fgk_edge_rows,
    fgk_successor_streams, lane_edge_rows, match_plain_rows,
    odd_config_input, pack_edge_rows, pack_lane_rows, rle_edge_rows,
    rle_encode_edge_rows, walk_edge_streams, walk_serial)
from huffman_codec_tpu_torch.native import runtime  # noqa: E402
from huffman_codec_tpu_torch.ops.fgk import n_words_for  # noqa: E402
from huffman_codec_tpu_torch.ops.pack import chunk_bytes  # noqa: E402
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
    return tuple(torch.from_numpy(a).to(dev) for a in match_plain_rows())


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
    o = K.rle_expand(d, ln, carries, CS, use_diff)
    assert torch.equal(o, K.rle_expand_plain(d, ln, carries, CS, use_diff))
    valid = torch.arange(CS, device=cuda)[None, :] < lens[:, None]
    assert torch.equal(torch.where(valid, o, 0), torch.where(valid, chunks, 0))


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


@pytest.mark.cuda
@pytest.mark.parametrize("out_len", [128, 4096, 12288])
@pytest.mark.parametrize("use_diff", [False, True])
def test_rle_expand_edge_streams(cuda, use_diff, out_len):
    s, ln, car = (torch.from_numpy(a).to(cuda)
                  for a in rle_edge_rows(8192, 41))
    K.reset_launches()
    got = K.rle_expand(s, ln, car, out_len, use_diff)
    assert K.launch_counts()["rle_expand"] == 1
    assert torch.equal(got, K.rle_expand_plain(s, ln, car, out_len,
                                               use_diff))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,out_len", [
    (4096, 21849, 16384), (4096, 89, 64), (40960, 89, 64),
    (1, 349529, 262144), (10, 349529, 262144)])
def test_rle_expand_tile_row_geometries(cuda, rows, n, out_len):
    # the adaptive decodes' tile rows: run-heavy streams of a 3-letter
    # alphabet, lengths anywhere up to the row
    rng = np.random.default_rng(rows + n)
    s = torch.from_numpy(rng.integers(0, 3, (rows, n), dtype=np.int64)
                         .astype(np.uint8)).to(cuda)
    ln = torch.from_numpy(rng.integers(0, n + 1, rows).astype(np.int32)
                          ).to(cuda)
    zero = torch.zeros(rows, dtype=torch.uint8, device=cuda)
    got = K.rle_expand(s, ln, zero, out_len, False)
    assert torch.equal(got, K.rle_expand_plain(s, ln, zero, out_len, False))


@pytest.mark.cuda
@pytest.mark.parametrize("lane,nl", [(512, 4), (2048, 3), (4096, 2)])
@pytest.mark.parametrize("max_len", [31, 8])
def test_lane_decode_edge_rows(cuda, lane, nl, max_len):
    # a 26-bit-deep code decoded at the max_len 31 bucket, and at 8, where
    # its long codes are no codes; partial and empty lanes
    sy, ln, lt = (torch.from_numpy(a).to(cuda)
                  for a in lane_edge_rows(lane, nl, 43))
    buf = pack_lane_rows(sy, ln, lt, lane)
    K.reset_launches()
    d = K.lane_decode(buf, lt, ln, lane, max_len)
    assert K.launch_counts()["lane_decode"] == 1
    assert torch.equal(d, K.lane_decode_plain(buf, lt, ln, lane, max_len))
    if max_len == 31:
        valid = torch.arange(nl * lane, device=cuda)[None, :] < ln[:, None]
        assert torch.equal(d, torch.where(valid, sy, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("lane", [100, 36])
def test_lane_decode_lanes_off_16(cuda, lane):
    # lanes that do not divide by 16 and a stride that does not divide by
    # 4, packed by the plain versions on the host
    sy, ln, lt = (torch.from_numpy(a) for a in lane_edge_rows(lane, 5, 44))
    buf = pack_lane_rows(sy, ln, lt, lane, wb_pad=3).to(cuda)
    lt, ln = lt.to(cuda), ln.to(cuda)
    d = K.lane_decode(buf, lt, ln, lane, 31)
    assert torch.equal(d, K.lane_decode_plain(buf, lt, ln, lane, 31))
    valid = torch.arange(5 * lane, device=cuda)[None, :] < ln[:, None]
    assert torch.equal(d, torch.where(valid, sy.to(cuda), 0))


@pytest.mark.cuda
@pytest.mark.parametrize("use_diff,tile", [(False, 0), (True, 0), (False, 64),
                                           (False, 4096), (False, 16384)])
def test_rle_encode_edge_rows(cuda, use_diff, tile):
    # lengths at and around the kernel's 16-byte and 4096-byte borders,
    # runs of 257-5000 bytes across tile borders, runs ending at the last
    # two positions, carries 0, 255 and equal to the first byte
    ch, ln, car = (torch.from_numpy(a).to(cuda)
                   for a in rle_encode_edge_rows(16384, 61))
    if tile:
        car = torch.zeros_like(car)
    cap = 16384 + 16384 // 3 + 4 + 9  # rows not 16-byte aligned
    K.reset_launches()
    s, l = K.rle_diff_encode(ch, ln, car, use_diff, cap, tile=tile)
    counts = K.launch_counts()
    assert counts[K.TILE_MODE if tile else "rle_diff_encode"] == 1
    ps, pl = K.rle_diff_encode_plain(ch, ln, car, use_diff, cap, tile)
    assert torch.equal(l, pl) and torch.equal(s, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("lane,nl", [(512, 8), (2048, 3), (32768, 2),
                                     (4224, 2), (48, 7)])
def test_lane_pack_edge_rows(cuda, lane, nl):
    # codes of depth 26 and 31 (the shared 26-bit field), empty, one-symbol
    # and partial lanes; the narrow shape (a team of threads a lane) and
    # the fat one (a block a lane, pieces of 4096 symbols)
    sy, ln, tables, _ = (torch.from_numpy(a).to(cuda)
                         for a in pack_edge_rows(lane, nl, 62))
    K.reset_launches()
    w, b = K.lane_pack(sy, ln, tables, lane)
    assert K.launch_counts()["lane_pack"] == 1
    pw, pb = K.lane_pack_plain(sy, ln, tables, lane)
    assert torch.equal(b, pb) and torch.equal(w, pw)


@pytest.mark.cuda
def test_rle_encode_launcher_refuses_short_scratch(cuda):
    # the scratch holds a status word a kernel tile and the tile counter;
    # one word short, the launcher returns an error and launches nothing
    from huffman_codec_tpu_torch.ops import _build
    C, n, cap = 3, 3 * K.RLE_TILE, 3 * K.RLE_TILE * 2
    ch = torch.zeros((C, n), dtype=torch.uint8, device=cuda)
    ln = torch.full((C,), n, dtype=torch.int32, device=cuda)
    car = torch.zeros(C, dtype=torch.uint8, device=cuda)
    st = torch.full((C, cap), 7, dtype=torch.uint8, device=cuda)
    ol = torch.full((C,), -1, dtype=torch.int32, device=cuda)
    fn = _build.bind("rle_encode", "rle_encode_launch", 6, 6)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    words = C * (n // K.RLE_TILE) + 1
    for size, ok in ((words - 1, False), (words, True)):
        scratch = torch.empty(size, dtype=torch.int64, device=cuda)
        err = fn(ch.data_ptr(), ln.data_ptr(), car.data_ptr(), st.data_ptr(),
                 ol.data_ptr(), scratch.data_ptr(), size, C, n, cap, 0, 0,
                 stream)
        torch.cuda.synchronize()
        assert (err == 0) == ok
        assert bool((ol == -1).all()) != ok


# -- shapes the JAX package encodes, which the wrappers once refused --------


def _rows_off_16(dev, n):
    """match_plain_rows cut to ``n`` columns, with lengths n, n - 1, 17,
    1000 and 0 among them."""
    chunks, _, carries = match_plain_rows()
    ch = np.ascontiguousarray(chunks[:, :n])
    ln = np.array([n, n - 1, n, 17, min(1000, n), 0], np.int32)
    return (torch.from_numpy(ch).to(dev), torch.from_numpy(ln).to(dev),
            torch.from_numpy(carries).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1003])
@pytest.mark.parametrize("use_diff", [False, True])
def test_encode_kernels_rows_off_16(cuda, use_diff, n):
    # kernels 1 and 2 on rows whose length does not divide by 16 (a
    # chunk_size of 1000), into streams of an odd cap
    ch, ln, car = _rows_off_16(cuda, n)
    cap = trle.rle_max_encoded_len(n) + 3
    K.reset_launches()
    s, l = K.rle_diff_encode(ch, ln, car, use_diff, cap)
    ps, pl = K.rle_diff_encode_plain(ch, ln, car, use_diff, cap)
    assert torch.equal(l, pl) and torch.equal(s, ps)
    for data, lens in ((s, l), (ch, ln)):
        assert torch.equal(K.histogram256(data, lens),
                           K.histogram256_plain(data, lens))
    counts = K.launch_counts()
    assert counts["rle_diff_encode"] == 1 and counts["histogram256"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("lane,nl", [(100, 10), (8, 25), (4100, 2)])
def test_lane_pack_ragged_lanes(cuda, lane, nl):
    # lanes that do not divide by 16: a thread's 16 symbols stop at its
    # lane's end; lane 4100 is the fat shape (pieces of 4096 symbols)
    sy, ln, tables, _ = (torch.from_numpy(a).to(cuda)
                         for a in pack_edge_rows(lane, nl, 64))
    K.reset_launches()
    w, b = K.lane_pack(sy, ln, tables, lane)
    assert K.launch_counts()["lane_pack"] == 1
    pw, pb = K.lane_pack_plain(sy, ln, tables, lane)
    assert torch.equal(b, pb) and torch.equal(w, pw)


@pytest.mark.cuda
@pytest.mark.parametrize("lane", [6, 50, 4098, 4100])
def test_lane_decode_lanes_off_4(cuda, lane):
    # lanes that do not divide by 4 (stored a byte a thread), and lanes
    # over 4096 that do not divide by 128, which the codec sends to
    # kernel 5 rather than kernel 7
    nl = 5 if lane < 4096 else 2
    sy, ln, lt = (torch.from_numpy(a).to(cuda)
                  for a in lane_edge_rows(lane, nl, 45))
    buf = pack_lane_rows(sy, ln, lt, lane)
    K.reset_launches()
    d = tcan.canonical_decode_batch(
        buf.view(len(ln), -1), lt, torch.zeros((len(ln), nl),
                                              dtype=torch.int32, device=cuda),
        ln, lane=lane, out_len=nl * lane)
    counts = K.launch_counts()
    assert counts["lane_decode"] == 1 and counts["lane_decode_lanemajor"] == 0
    assert torch.equal(d, K.lane_decode_plain(buf, lt, ln, lane, 31))
    valid = torch.arange(nl * lane, device=cuda)[None, :] < ln[:, None]
    assert torch.equal(d, torch.where(valid, sy, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("out_len", [1000, 1003, 8191])
@pytest.mark.parametrize("use_diff", [False, True])
def test_rle_expand_out_len_off_16(cuda, use_diff, out_len):
    s, ln, car = (torch.from_numpy(a).to(cuda)
                  for a in rle_edge_rows(8192, 46))
    K.reset_launches()
    got = K.rle_expand(s, ln, car, out_len, use_diff)
    assert K.launch_counts()["rle_expand"] == 1
    assert got.is_contiguous()
    assert torch.equal(got, K.rle_expand_plain(s, ln, car, out_len,
                                               use_diff))


@pytest.mark.cuda
@pytest.mark.parametrize("out_len", [1 << 16, 1 << 25])
def test_rle_expand_rows_past_2_23(cuda, out_len):
    # a row of more than 2^23 stream bytes (the kernel's old limit), cut
    # short of its decoded length and decoded whole
    rng = np.random.default_rng(47)
    n = (1 << 23) + 100
    s = torch.from_numpy(rng.integers(0, 3, (1, n), dtype=np.int64)
                         .astype(np.uint8)).to(cuda)
    ln = torch.tensor([n - 7], dtype=torch.int32, device=cuda)
    car = torch.tensor([5], dtype=torch.uint8, device=cuda)
    got = K.rle_expand(s, ln, car, out_len, True)
    assert torch.equal(got, K.rle_expand_plain(s, ln, car, out_len, True))


@pytest.mark.cuda
@pytest.mark.parametrize("use_diff", [False, True])
@pytest.mark.parametrize("name", list(ODD_CONFIGS))
def test_gpu_odd_configs_equal_cpu_plain_path(cuda, name, use_diff):
    cfg = CodecConfig(use_diff=use_diff, **ODD_CONFIGS[name])
    data = odd_config_input(name)
    gpu, cpu = TorchCodec(cfg), TorchCodec(cfg, device="cpu")
    K.reset_launches()
    if cfg.layout == "sharded":
        blobs = [gpu.encode(data)]
        assert blobs[0] == cpu.encode(data)
    else:  # the v3 candidates: encode() would keep the smaller v1 blob
        blobs = [gpu._encode_global(data, None, w)
                 for w in gpu.global_candidates(len(data))]
        assert blobs == [cpu._encode_global(data, None, w)
                         for w in cpu.global_candidates(len(data))]
    for blob in blobs:
        assert gpu.decode(blob) == data
    counts = K.launch_counts()
    names = ["histogram256", "lane_pack", "repad_words", "lane_decode"]
    if cfg.layout == "sharded":
        names += ["rle_diff_encode", "rle_expand"]
    assert all(counts[k] for k in names), counts


@pytest.mark.cuda
def test_lanemajor_fat_edge_rows_match_plain(cuda):
    # lane 32768: random bytes, a fixed 7-bit code, windows with no code,
    # codes of 20-31 bits across sub-sequence borders, a chain past the
    # lane's last word, a partial lane; all in one call of the plain
    # version (its loop runs once per symbol of the lane)
    from huffman_codec_tpu_torch.edge_cases import fat_lane_rows
    lane = 32768
    buf, lt, ln, _, _ = fat_lane_rows(lane, 48, cuda)
    K.reset_launches()
    d = K.lane_decode_lanemajor(buf, lt, ln, lane, 31)
    assert K.launch_counts()["lane_decode_lanemajor"] == 1
    assert torch.equal(d, K.lane_decode_lanemajor_plain(buf, lt, ln, lane,
                                                         31))


@pytest.mark.cuda
@pytest.mark.parametrize("row", range(7))
def test_lanemajor_fat_edge_rows_match_lane_decode(cuda, row):
    # each case alone at its own max_len bucket, against kernel 5
    from huffman_codec_tpu_torch.edge_cases import fat_lane_rows
    lane = 32768
    buf, lt, ln, buckets, names = fat_lane_rows(lane, 48, cuda)
    b, t, n = (a[row:row + 1].clone() for a in (buf, lt, ln))
    d = K.lane_decode_lanemajor(b, t, n, lane, buckets[row])
    assert torch.equal(d, K.lane_decode(b, t, n, lane, buckets[row])), \
        names[row]


@pytest.mark.cuda
@pytest.mark.parametrize("C,nl,wb", [(1, 112, 6592), (7, 45, 64),
                                     (3, 45, 37), (256, 172, 64)])
def test_repad_geometries_match_plain(cuda, C, nl, wb):
    # the whole-file chunk (one chunk of 112 fat lanes), lane counts that
    # are not a multiple of 32, a stride that does not divide by 4, and
    # the sharded step; empty and full lanes among random ones
    rng = np.random.default_rng(C * nl + wb)
    lw = rng.integers(0, wb + 1, (C, nl)).astype(np.int32)
    lw.reshape(-1)[:: 7] = 0
    lw.reshape(-1)[3:: 11] = wb
    lw = torch.from_numpy(lw).to(cuda)
    flat = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, int(lw.sum()))
                            .astype(np.int32)).to(cuda)
    K.reset_launches()
    got = K.repad_words(flat, lw, wb)
    assert K.launch_counts()["repad_words"] == 1
    assert torch.equal(got, K.repad_words_plain(flat, lw, wb))


@pytest.mark.cuda
def test_repad_launcher_refuses_short_scratch(cuda):
    # the scratch holds a status word a block of REPAD_SPAN slots, tagged
    # with the launch's number; one word short, the launcher launches
    # nothing. Words of an earlier launch left in it change nothing
    from huffman_codec_tpu_torch.ops import _build
    C, nl, wb = 2, 40, 512
    lw = torch.full((C, nl), wb, dtype=torch.int32, device=cuda)
    fn = _build.bind("repad", "repad_launch", 4, 6)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    words = K.repad_scratch_words(C, nl, wb)
    scratch = torch.zeros(words, dtype=torch.int64, device=cuda)
    for size, ok, epoch, fill in ((words - 1, False, 1, 1), (words, True, 1, 1),
                                  (words, True, 2, 3), (words, False, 0, 1)):
        flat = torch.full((C * nl * wb,), fill, dtype=torch.int32,
                          device=cuda)
        out = torch.zeros(C * nl * wb, dtype=torch.int32, device=cuda)
        err = fn(flat.data_ptr(), lw.data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), size, C, nl, wb, flat.numel(), epoch,
                 stream)
        torch.cuda.synchronize()
        assert (err == 0) == ok
        assert bool((out == fill).all()) == ok


@pytest.mark.cuda
def test_repad_replayed_in_a_cuda_graph(cuda):
    # a captured launch replays its launch number: the words of the last
    # replay must not count in the next one, whatever its inputs
    C, nl, wb = 64, 45, 64
    rng = np.random.default_rng(49)
    lw = torch.zeros((C, nl), dtype=torch.int32, device=cuda)
    flat = torch.zeros(C * nl * wb, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        K.repad_words(flat, lw, wb)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.repad_words(flat, lw, wb)
    for _ in range(3):
        new_lw = torch.from_numpy(rng.integers(0, wb + 1, (C, nl))
                                  .astype(np.int32)).to(cuda)
        n = int(new_lw.sum())
        lw.copy_(new_lw)
        flat[:n] = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n)
                                    .astype(np.int32)).to(cuda)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, K.repad_words_plain(flat[:n], lw, wb))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 256])
def test_fgk_kernels_match_plain_on_edge_rows(cuda, C):
    # empty, one- and two-symbol rows, all 256 symbols, run-heavy streams,
    # lengths off every word and the kernels' 1024-symbol stage, the
    # deepest tree for the length; C = 1 takes the all-symbols row
    x, ln = fgk_edge_rows(2100, 71)
    pick = np.resize(np.arange(len(ln)), C) if C > 1 else np.array([3])
    x = torch.from_numpy(x[pick]).to(cuda)
    ln = torch.from_numpy(ln[pick]).to(cuda)
    nw = n_words_for(2100)
    K.reset_launches()
    w, b = K.fgk_encode(x, ln, nw)
    d = K.fgk_decode(w, ln, 2100)
    counts = K.launch_counts()
    assert counts["fgk_encode"] == 1 and counts["fgk_decode"] == 1
    pw, pb = K.fgk_encode_plain(x, ln, nw)
    assert torch.equal(b, pb) and torch.equal(w, pw)
    assert torch.equal(d, K.fgk_decode_plain(w, ln, 2100))
    valid = torch.arange(2100, device=cuda)[None, :] < ln[:, None]
    assert torch.equal(d, torch.where(valid, x, 0))


@pytest.mark.cuda
def test_fgk_kernels_codes_past_32_bits(cuda):
    # fresh symbols 33 bits deep: the encoder's high word. MNP-5 leaves the
    # row as it is, so its v1 body is its FGK stream
    row = fgk_deep_row(72)
    n = row.size
    x = torch.from_numpy(row).to(cuda)[None, :]
    ln = torch.tensor([n], dtype=torch.int32, device=cuda)
    w, b = K.fgk_encode(x, ln, n_words_for(n))
    v1 = runtime.v1_compress(row.tobytes())
    assert chunk_bytes(w, b).cpu().numpy().tobytes() == v1[9:]
    assert torch.equal(K.fgk_decode(w, ln, n), x)


FGK_PLAIN_CUT = 800  # symbols of a row the plain loop (once a symbol) runs


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pair", "round_robin", "fibonacci"])
def test_fgk_kernels_on_successor_streams(cuda, name):
    # the successor's cases: a leaf whose successor is its parent, long
    # runs of one weight, fresh codes past 32 bits. Each stream MNP-5 coded
    # by the host runtime, as the v1 format codes it, so the encoder's
    # words are the runtime's v1 body
    streams = fgk_successor_streams(5)[name]
    coded = [runtime.rle_encode(s.tobytes()) for s in streams]
    n = max(len(c) for c in coded)
    rows = np.zeros((len(coded), n), np.uint8)
    for i, c in enumerate(coded):
        rows[i, :len(c)] = np.frombuffer(c, np.uint8)
    x = torch.from_numpy(rows).to(cuda)
    ln = torch.tensor([len(c) for c in coded], dtype=torch.int32,
                      device=cuda)
    w, b = K.fgk_encode(x, ln, n_words_for(n))
    for i, s in enumerate(streams):
        assert chunk_bytes(w[i:i + 1], b[i:i + 1]).cpu().numpy().tobytes() \
            == runtime.v1_compress(s.tobytes())[9:], i
    valid = torch.arange(n, device=cuda)[None, :] < ln[:, None]
    assert torch.equal(K.fgk_decode(w, ln, n), torch.where(valid, x, 0))
    # both kernels against their plain versions on the rows' heads
    cut = ln.clamp(max=FGK_PLAIN_CUT)
    head = x[:, :FGK_PLAIN_CUT].contiguous()
    nw = n_words_for(FGK_PLAIN_CUT)
    w, b = K.fgk_encode(head, cut, nw)
    pw, pb = K.fgk_encode_plain(head, cut, nw)
    assert torch.equal(b, pb) and torch.equal(w, pw)
    assert torch.equal(K.fgk_decode(w, cut, FGK_PLAIN_CUT),
                       K.fgk_decode_plain(w, cut, FGK_PLAIN_CUT))


def _fgk_input(name):
    rng = np.random.default_rng(73)
    if name.startswith("sharded-adapt") or name.startswith("global-adapt"):
        y, x = np.mgrid[0:80, 0:64]
        img = ((x // 3 + y // 5) % 256 + rng.integers(0, 2, (80, 64)))
        return img.astype(np.uint8).tobytes()
    return (np.cumsum(rng.integers(-2, 3, 3000)) & 255).astype(
        np.uint8).tobytes()


FGK_CONFIGS = {
    "sharded": CodecConfig(layout="sharded", chunk_size=1024,
                           entropy="fgk", step_chunks=2),
    "sharded-diff": CodecConfig(layout="sharded", chunk_size=1000,
                                use_diff=True, entropy="fgk"),
    "global-diff": CodecConfig(chunk_size=512, use_diff=True, entropy="fgk"),
    "global-adapt": CodecConfig(use_adapt=True, width=64, chunk_size=512,
                                entropy="fgk"),
    "sharded-adapt": CodecConfig(use_adapt=True, width=64, chunk_size=1024,
                                 layout="sharded", entropy="fgk"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FGK_CONFIGS))
def test_gpu_fgk_container_equals_cpu_plain_path(cuda, name):
    cfg, data = FGK_CONFIGS[name], _fgk_input(name)
    gpu, cpu = TorchCodec(cfg), TorchCodec(cfg, device="cpu")
    if cfg.layout == "sharded":
        K.reset_launches()
        g, c = gpu.encode(data), cpu.encode(data)
        assert K.launch_counts()["fgk_encode"] >= 1
    else:  # the v3 candidate, not the v1 race's pick
        bs = None
        if cfg.use_adapt:
            x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
            bs = tad.adapt_search_best_v3(x, 64, len(data) // 64)
        g, c = (k._encode_global(data, bs, False) for k in (gpu, cpu))
    assert g == c
    K.reset_launches()
    assert gpu.decode(c) == data
    assert K.launch_counts()["fgk_decode"] >= 1


@pytest.mark.cuda
def test_gpu_decodes_jax_shaped_fgk_container(cuda):
    # a container as the JAX package writes it (the CPU plain path writes
    # the same bytes: tests/test_torch_fgk.py), decoded on the card, then a
    # range across a chunk border
    cfg = CodecConfig(layout="sharded", chunk_size=512, use_diff=True,
                      entropy="fgk")
    data = _fgk_input("sharded")
    blob = TorchCodec(cfg, device="cpu").encode(data)
    gpu = TorchCodec(cfg)
    assert gpu.decode(blob) == data
    assert gpu.decode_range(blob, 500, 40) == data[500:540]


@pytest.mark.cuda
@pytest.mark.parametrize("use_diff,use_adapt",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_gpu_v1codec_equals_native(cuda, use_diff, use_adapt):
    data = _fgk_input("global-adapt")
    codec = V1Codec(CodecConfig(use_diff=use_diff, use_adapt=use_adapt,
                                width=64))
    blob = codec.encode(data)
    assert blob == runtime.v1_compress(data, use_diff, use_adapt, 64)
    assert codec.decode(blob) == data
    assert runtime.v1_decompress(blob) == data


BROKEN_V1 = broken_adapt_v1_blobs()


@pytest.mark.cuda
@pytest.mark.parametrize("code", list(BROKEN_V1))
def test_gpu_v1codec_broken_adaptive_payloads_raise(cuda, code):
    blob, message = BROKEN_V1[code]
    K.reset_launches()
    with pytest.raises(ValueError, match=message):
        V1Codec().decode(blob)
    assert K.launch_counts()["group_tile_lens"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [0, 3])
def test_group_walk_decoded_sizes_match_plain(cuda, cut):
    x = torch.from_numpy(_image(72, 64, 13)).to(cuda)
    stream, total, _, tl = tad.adapt_encode_fixed(x, 64, 72, 8,
                                                  with_header=False)
    total = int(total) - cut
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    sizes = torch.from_numpy(tad._tile_geom_arrays(64, 72, 8)).to(cuda)
    got = K.group_tile_lens(stream, zero, sizes, total, total,
                            with_decoded=True)
    want = K.group_tile_lens_plain(stream, zero, sizes, total, total,
                                   with_decoded=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(got[1], sizes) == (cut == 0)


WALK_EDGE = walk_edge_streams(0)


def _walk_both(args, cuda):
    """The walk kernel's two instances on ``args`` (CPU tensors and ints)
    against the plain version run on the CPU; one launch each."""
    dev_args = [a.to(cuda) if torch.is_tensor(a) else a for a in args]
    want = K.group_tile_lens_plain(*args, with_decoded=True)
    K.reset_launches()
    got = K.group_tile_lens(*dev_args)
    got_d = K.group_tile_lens(*dev_args, with_decoded=True)
    assert K.launch_counts()["group_tile_lens"] == 2
    assert torch.equal(got.cpu(), want[0])
    assert torch.equal(got_d[0].cpu(), want[0])
    assert torch.equal(got_d[1].cpu(), want[1])
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(WALK_EDGE))
def test_group_walk_kernel_on_edge_streams(cuda, name):
    stream, offs, sizes, total, cap = WALK_EDGE[name]
    want = _walk_both((torch.from_numpy(stream), torch.from_numpy(offs),
                       torch.from_numpy(sizes), total, cap), cuda)
    ref = walk_serial(stream, offs, sizes, total, cap)
    assert np.array_equal(want[0].numpy(), ref[0])
    assert np.array_equal(want[1].numpy(), ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [8, 16])
def test_group_walk_kernel_grouped_manifests(cuda, bs):
    # a 512 x 512 image walked as the grouped manifest does: 64 tiles a
    # group, 64 groups at block size 8 and 16 at 16
    x = torch.from_numpy(_image(512, 512, 15)).to(cuda)
    stream, total, _, tl = tad.adapt_encode_fixed(x, 512, 512, bs,
                                                  with_header=False)
    offs = (torch.cumsum(tl, 0) - tl)[:: tad.GROUP_K].to(torch.int32)
    sizes = torch.full((tl.shape[0],), bs * bs, dtype=torch.int32)
    cap = tad.GROUP_K * trle.rle_max_encoded_len(bs * bs)
    want = _walk_both((stream.cpu(), offs.cpu(), sizes, int(total), cap),
                      cuda)
    assert torch.equal(want[0], tl.cpu().to(torch.int32))
    assert torch.equal(want[1], sizes)


@pytest.mark.cuda
def test_group_walk_kernel_one_group_of_4096_tiles(cuda):
    # V1Codec's walk: one group of every tile of a 512 x 512 image at block
    # size 8, flat tiles (a run each) among noisy ones, and the same stream
    # cut short inside a tile
    rng = np.random.default_rng(16)
    img = np.kron(rng.integers(0, 4, (64, 64)),
                  np.ones((8, 8), np.int64)).astype(np.uint8)
    noisy = np.kron(rng.random((64, 64)) < 0.1,
                    np.ones((8, 8), bool)).astype(bool)
    img[noisy] = rng.integers(0, 256, int(noisy.sum()))
    img = img.reshape(-1)
    stream, total, _, tl = tad.adapt_encode_fixed(
        torch.from_numpy(img), 512, 512, 8, with_header=False)
    stream = stream[: int(total)].clone()
    sizes = torch.from_numpy(tad._tile_geom_arrays(512, 512, 8))
    zero = torch.zeros(1, dtype=torch.int32)
    for cut in (0, 37):
        n = int(total) - cut
        want = _walk_both((stream[:n].clone(), zero, sizes, n, n), cuda)
        assert torch.equal(want[0], tl.to(torch.int32)) == (cut == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3])
@pytest.mark.parametrize("L", [0, 1, 15, 16, 17, 4099, 65536 + 7,
                               (1 << 23) + 100])
def test_histogram_few_rows_matches_plain(cuda, C, L):
    # rows of L not a multiple of 16 start off the 16-byte lines; lengths
    # from the whole row down to 0 and 1
    rng = np.random.default_rng(C * 1000 + L % 997)
    data = torch.from_numpy(rng.integers(0, 256, (C, L), dtype=np.int64)
                            .astype(np.uint8)).to(cuda)
    if L > 100:
        data[:, 50:L // 2] = 7  # one bin takes most of the row
    lens = torch.tensor([L, max(L - 1, 0), min(L, 1)][:C],
                        dtype=torch.int32, device=cuda)
    K.reset_launches()
    got = K.histogram256(data, lens)
    assert K.launch_counts()["histogram256"] == 1
    assert torch.equal(got, K.histogram256_plain(data, lens))


@pytest.mark.cuda
def test_histogram_split_replayed_in_a_cuda_graph(cuda):
    # one row, cut into slices: the memset and the kernel replay together,
    # and a replay's counts never carry into the next
    L = (5 << 19) + 3
    rng = np.random.default_rng(52)
    data = torch.zeros((1, L), dtype=torch.uint8, device=cuda)
    lens = torch.full((1,), L, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        K.histogram256(data, lens)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    K.reset_launches()
    with torch.cuda.graph(graph):
        out = K.histogram256(data, lens)
    assert K.launch_counts()["histogram256"] == 1
    for n in (L, 12345, 0):
        data.copy_(torch.from_numpy(rng.integers(0, 256, (1, L),
                                                 dtype=np.int64)
                                    .astype(np.uint8)))
        lens.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, K.histogram256_plain(data, lens))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    ["--format=v3", "-m", "--layout=sharded", "--chunk-size=8192"],
    ["--format=v3", "--layout=sharded", "--chunk-size=8192",
     "--entropy=fgk"],
    ["--backend=torch", "-m"],
    ["--backend=torch", "-a", "-w", "64"],
    ["-a", "-m", "-w", "64"]],
    ids=["v3-sharded-m", "v3-sharded-fgk", "torch-m", "torch-a",
         "v1-default-am"])
def test_gpu_cli_equals_cpu_run(cuda, flags, tmp_path):
    """The command line on the card (device left at its default) writes
    the bytes of its run on the plain versions, and decodes them."""
    from huffman_codec_tpu_torch import cli

    data = _image(100, 64, 21).tobytes()
    src = tmp_path / "in.raw"
    src.write_bytes(data)
    out = {}
    for name, device in (("gpu", None), ("cpu", "cpu")):
        out[name] = tmp_path / f"{name}.bin"
        assert cli.main(["-c", *flags, "-i", str(src), "-o",
                         str(out[name])], device=device) == 0
    assert out["gpu"].read_bytes() == out["cpu"].read_bytes()
    K.reset_launches()
    dec = tmp_path / "dec.raw"
    assert cli.main(["-d", *flags, "-i", str(out["gpu"]), "-o",
                     str(dec)]) == 0
    assert dec.read_bytes() == data
    assert sum(K.launch_counts().values()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("code", list(BROKEN_V1))
def test_gpu_cli_default_backend_on_broken_blobs(cuda, code, tmp_path):
    """v1's default backend (``torch``) on the card gives the host
    runtime's exit code and stderr line on the broken adaptive blobs."""
    import contextlib
    import io

    from huffman_codec_tpu_torch import cli

    blob, message = BROKEN_V1[code]
    src = tmp_path / "bad.v1"
    src.write_bytes(blob)
    runs = []
    for pick in ([], ["--backend=native"]):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["-d", *pick, "-i", str(src), "-o",
                           str(tmp_path / "out")])
        runs.append((rc, err.getvalue()))
    assert runs[0] == runs[1] == (code, f"ERROR: {message}\n")


MESH_CASES = {  # name -> (use_diff, entropy)
    "canonical-diff": (True, "canonical"),
    "canonical": (False, "canonical"),
    "fgk-diff": (True, "fgk"),
}


@pytest.fixture
def nccl_world1(cuda):
    """An NCCL group of one rank in this process, its mesh on the card."""
    import socket

    import torch.distributed as dist

    from huffman_codec_tpu_torch.parallel import mesh as M

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield M.default_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MESH_CASES))
def test_mesh_world1_nccl_equals_cpu_plain_path(nccl_world1, name):
    """``distributed_encode_step`` on NCCL at world 1 (chunk 1024, lane
    128, 8 chunks, a partial tail) equals the single-process stage run
    on the CPU's plain versions (zero carries without diff, as the JAX
    mesh has them), and ``distributed_decode_step`` returns the input."""
    from huffman_codec_tpu_torch.models.chunked import encode_sharded_stage
    from huffman_codec_tpu_torch.models.entropy import lookup
    from huffman_codec_tpu_torch.parallel import mesh as M

    use_diff, ent = MESH_CASES[name]
    cs, nc, lane = 1024, 8, 128
    raw = _image(64, 128, 31)
    n = raw.size - 301
    nw = n_words_for(lookup(ent).cap(cs, lane))
    mesh = nccl_world1
    K.reset_launches()
    got = M.distributed_encode_step(torch.from_numpy(raw).to(mesh.device),
                                    n, mesh, cs, nw, use_diff, ent, lane)
    a, meta, tab, rl, car = encode_sharded_stage(
        torch.from_numpy(raw), n, 0, use_diff, cs, nc, lane, lookup(ent),
        nw)
    if not use_diff:
        car = torch.zeros_like(car)
    for g, w in zip(got, (a, meta, tab, rl, car)):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.is_cuda and torch.equal(g.cpu(), w)
    dec = M.distributed_decode_step(got[0].view(nc, -1), got[3], got[4],
                                    mesh, cs, got[2], got[1], use_diff, ent,
                                    lane)
    assert dec[:n].cpu().numpy().tobytes() == raw[:n].tobytes()
    counts = K.launch_counts()
    assert counts["rle_diff_encode"] and counts["rle_expand"]


@pytest.mark.cuda
def test_mesh_adapt_world1_nccl_equals_cpu_plain_path(nccl_world1):
    """The adaptive search, encode and decode on NCCL at world 1 against
    the single-process functions on the CPU's plain versions."""
    from huffman_codec_tpu_torch.models.chunked import (
        encode_sharded_adapt_stage)
    from huffman_codec_tpu_torch.models.entropy import CANONICAL
    from huffman_codec_tpu_torch.ops.diff import diff_apply
    from huffman_codec_tpu_torch.parallel import mesh as M

    w, bh, lane = 128, 16, 64
    raw = _image(64, w, 33)
    mesh = nccl_world1
    x = torch.from_numpy(raw)
    scores = M.distributed_adapt_search(x, mesh, w, bh)
    want = torch.stack([tad._adapt_score_v3(diff_apply(x), w, 64, b)
                        for b in tad.candidate_sizes(w, bh)])
    assert torch.equal(scores.cpu(), want.to(torch.int32))
    bs = 8
    got = M.distributed_adapt_encode_step(x, mesh, w, bh, bs, True,
                                          "canonical", lane)
    bands = x.view(-1, w * bh)
    car = torch.cat([torch.zeros(1, dtype=torch.uint8), bands[:-1, -1]])
    ref = encode_sharded_adapt_stage(bands, car, True, w, bh, bs,
                                     CANONICAL.cap(w * bh, lane), lane)
    for g, r in zip(got, (*ref, car)):
        assert torch.equal(g.cpu(), r)
    buf, lw, tab, tot, dirs, tl, c = got
    dec = M.distributed_adapt_decode_step(buf.view(buf.shape[0], -1), tot,
                                          tl, dirs, c, tab, lw, mesh, w, bh,
                                          bs, True, lane)
    assert dec.cpu().numpy().tobytes() == raw.tobytes()


# -- the step pipeline: CUDA graphs, no hidden synchronisation ---------------

PIPE_CONFIGS = {
    # the main path's step (256 x 64 KiB), two steps and a short third
    "main": (dict(layout="sharded", step_chunks=256), 2 * (16 << 20) + 12345),
    # chunk 1000 / lane 100 and lane 8: three steps, the last short
    **{k: (dict(v, step_chunks=2), 5 * v["chunk_size"] + 123)
       for k, v in ODD_CONFIGS.items() if v.get("layout") == "sharded"},
}


def _pipe_input(name, n):
    if name == "main":
        rng = np.random.default_rng(77)
        i = np.arange(n)
        return (((i // 512) * 2 + (i % 512) // 3 + rng.integers(-2, 3, n))
                & 255).astype(np.uint8).tobytes()
    return odd_config_input(name, n)


@pytest.mark.cuda
@pytest.mark.parametrize("use_diff", [False, True])
@pytest.mark.parametrize("name", list(PIPE_CONFIGS))
def test_step_graphs_equal_eager_steps(cuda, name, use_diff):
    """Every output of a replayed encode step equals the same step run
    launch by launch, each decode step written into its slice of the
    decode's result equals the step run alone, and the pipelined
    container equals the CPU plain path's. The codec keeps one graph, the
    encode step's (the decode runs launch by launch)."""
    from huffman_codec_tpu_torch.models import chunked as tch
    from huffman_codec_tpu_torch.models.entropy import CANONICAL

    kw, n = PIPE_CONFIGS[name]
    cfg = CodecConfig(use_diff=use_diff, **kw)
    data = _pipe_input(name, n)
    codec = TorchCodec(cfg)
    blob = codec.encode(data)  # the warm-up and the capture, then replays
    assert codec.decode(blob) == data
    S, cs = cfg.step_chunks, cfg.chunk_size
    assert list(codec._graphs) == [S]
    assert codec._graphs[S].graph is not None
    arr = np.frombuffer(data, np.uint8)
    for k in range(-(-n // (S * cs))):
        base = codec._upload_step(arr, k * S, (k + 1) * S)
        got = codec._run_encode_step(base, S)
        want = tch._encode_step(base, S, cs, cfg.lane, use_diff, CANONICAL)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    hdr, staged = codec.stage_decode_steps(blob)
    for got, st in zip(codec.run_decode_steps(hdr, staged), staged):
        assert torch.equal(got, codec._decode_step(hdr, st))
    if name != "main":
        assert blob == TorchCodec(cfg, device="cpu").encode(data)


@pytest.mark.cuda
@pytest.mark.parametrize("use_diff", [False, True])
def test_dispatch_halves_never_synchronise(cuda, use_diff):
    """The dispatch halves of the pipelined encode and decode raise
    nothing under ``torch.cuda.set_sync_debug_mode("error")`` once the
    graphs are captured (a capture synchronises the device once)."""
    kw, n = PIPE_CONFIGS["main"]
    data = _pipe_input("main", n)
    codec = TorchCodec(CodecConfig(use_diff=use_diff, **kw))
    blob = codec.encode(data)
    hdr = codec._parse(blob)
    codec._run_decode(hdr, codec.stage_decode_steps(blob, hdr)[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = codec.dispatch_sharded(data)
        flat = codec._run_decode(hdr, codec.stage_decode_steps(blob, hdr)[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert codec.fetch_sharded(data, outs) == blob
    assert flat[:n].cpu().numpy().tobytes() == data


@pytest.mark.cuda
def test_launch_counts_equal_with_and_without_graphs(cuda):
    """A pipelined round trip counts the launches a step-by-step eager
    round trip makes: each replay adds what its capture recorded, and the
    capture counts nothing."""
    kw, n = PIPE_CONFIGS["main"]
    cfg = CodecConfig(use_diff=True, **kw)
    data = _pipe_input("main", n)
    codec = TorchCodec(cfg)
    arr = np.frombuffer(data, np.uint8)
    S = cfg.step_chunks
    counts = []
    for _ in range(2):  # the capturing run, then replays only
        K.reset_launches()
        blob = codec.encode(data)
        assert codec.decode(blob) == data
        counts.append(K.launch_counts())
    K.reset_launches()
    for k in range(-(-n // (S * cfg.chunk_size))):
        codec.encode_chunk_range(arr, k * S, (k + 1) * S)
    hdr, staged = codec.stage_decode_steps(blob)
    for st in staged:
        codec._decode_step(hdr, st)
    torch.cuda.synchronize()
    eager = K.launch_counts()
    assert counts[0] == counts[1] == eager
    assert all(eager[k] == 3 for k in ("rle_diff_encode", "histogram256",
                                       "lane_pack", "repad_words",
                                       "lane_decode", "rle_expand"))


def _held_bytes() -> int:
    """Device bytes of live tensors and live graphs' pools: what
    ``memory_reserved()`` reads once the allocator's free blocks are
    released."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved()


def _long_lived_pass(seed: int, counts, cs: int) -> list:
    """Inputs of the given chunk counts (partial last chunks), seeded
    gradients at one of four noise amplitudes with a block of random
    bytes, so that the sizes, lane strides and code-length buckets vary."""
    rng = np.random.default_rng(seed)
    out = []
    for c in counts:
        n = (c - 1) * cs + int(rng.integers(1, cs))
        i = np.arange(n)
        amp = int(rng.choice([0, 2, 8, 32]))
        x = (((i // 512) * 3 + (i % 512) // 2
              + rng.integers(-amp, amp + 1, n)) & 255).astype(np.uint8)
        m = int(rng.integers(1, n // 4 + 2))
        at = int(rng.integers(0, n - m + 1))
        x[at: at + m] = rng.integers(0, 256, m, dtype=np.uint8)
        out.append(x.tobytes())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("use_diff", [False, True])
def test_long_lived_codec_graphs_and_memory_bounded(cuda, use_diff):
    """One codec round-trips two passes of inputs of varied sizes and
    data, each input twice. It never keeps more graphs than
    ``step_graph_bound`` allows, and the device memory held after the
    second pass (new sizes and data, no new step geometry) is within one
    2 MiB segment of the allocator (a small scratch may move to a new
    one) of what it held after the first."""
    from huffman_codec_tpu_torch.models.chunked import step_graph_bound

    cs, step = 4096, 16
    codec = TorchCodec(CodecConfig(use_diff=use_diff, chunk_size=cs,
                                   lane=512, layout="sharded",
                                   step_chunks=step))
    bound = step_graph_bound(step)
    assert bound == 5
    held = []
    # a count in every power-of-two class up to a step, and past it
    for seed, counts in ((51, (1, 2, 3, 7, 12, 16, 23, 40)),
                         (52, (2, 4, 5, 9, 14, 19, 33, 11))):
        for data in _long_lived_pass(seed, counts, cs):
            for _ in range(2):
                assert codec.decode(codec.encode(data)) == data
            assert len(codec._graphs) <= bound
        held.append(_held_bytes())
    assert sorted(codec._graphs) == [1, 2, 4, 8, 16]
    assert held[1] - held[0] <= 2 << 20


@pytest.mark.cuda
@pytest.mark.parametrize("out_len", [CS, 1000])
def test_rle_expand_writes_into_out(cuda, out_len):
    """``rle_expand(..., out=)`` writes the rows into ``out`` (directly
    when out_len is a multiple of 16), returns it, launches once, and
    equals the call without ``out``."""
    chunks, lens, carries = _rows(cuda)
    lens = lens.clamp(max=out_len)
    s, ln = K.rle_diff_encode(chunks[:, :out_len].contiguous(), lens,
                              carries, True, CAP)
    want = K.rle_expand(s, ln, carries, out_len, True)
    out = torch.full((s.shape[0], out_len), 7, dtype=torch.uint8,
                     device=cuda)
    K.reset_launches()
    got = K.rle_expand(s, ln, carries, out_len, True, out=out)
    assert K.launch_counts()["rle_expand"] == 1
    assert got.data_ptr() == out.data_ptr() and torch.equal(out, want)
    with pytest.raises(ValueError):
        K.rle_expand(s, ln, carries, out_len, True, out=out[:, :-1])


@pytest.mark.cuda
def test_gpu_one_chunk_fgk_forms_launch_kernels(cuda):
    """``fgk_encode_chunk`` / ``fgk_decode_chunk`` on a CUDA row launch the
    FGK kernels once each and give the host runtime's v1 body."""
    from huffman_codec_tpu_torch.ops.fgk import (fgk_decode_chunk,
                                                 fgk_encode_chunk)
    x = match_plain_rows()[0][0].tobytes()
    stream = runtime.rle_encode(x)  # v1 codes the RLE stream of its input
    ln = len(stream)
    row = torch.frombuffer(bytearray(stream), dtype=torch.uint8).to(cuda)
    K.reset_launches()
    w, b = fgk_encode_chunk(row, ln, n_words_for(ln))
    back = fgk_decode_chunk(w, ln, out_len=ln)
    counts = K.launch_counts()
    assert counts["fgk_encode"] == 1 and counts["fgk_decode"] == 1
    v1 = runtime.v1_compress(x)
    assert int.from_bytes(v1[:8], "little") == ln
    assert chunk_bytes(w[None], b[None]).cpu().numpy().tobytes() == v1[9:]
    assert torch.equal(back, row)
    with pytest.raises(ValueError):
        fgk_decode_chunk(w, ln, out_len=0)


@pytest.mark.cuda
def test_gpu_code_lengths_equal_cpu(cuda):
    """The exact and Kraft code lengths on the card equal their CPU runs, and
    package-merge's cost equals the exact one's on every row."""
    chunks, lens, carries = _rows(cuda)
    s, ln = K.rle_diff_encode(chunks, lens, carries, True, CAP)
    counts = K.histogram256(s, ln).to(torch.int64)
    for name in ("build_lengths_exact", "build_lengths_kraft"):
        fn = getattr(tcan, name)
        assert torch.equal(fn(counts).cpu(), fn(counts.cpu()))
    ex, pm = tcan.build_lengths_exact(counts), tcan.build_lengths_pm(counts)
    assert torch.equal((ex * counts).sum(1), (pm * counts).sum(1))
