"""Adaptive block RLE as batched PyTorch ops.

The W x H byte matrix is split into bs x bs tiles (clamped at the
borders), every tile is MNP-5 encoded in row-major and in column-major
scan order and the smaller stream kept (horizontal wins a tie: direction
bit 1), and the block size is searched over 8, 16, ... 1024. The payload
is the winning tile streams one after the other; the reference's in-band
header ``[W u64 BE][H u64 BE][bs u64 BE][direction bits MSB-first]`` goes
before them only in the v1 format, the v3 container keeps a manifest.

W, H and bs are plain integers, so every tile's geometry (clamped
extents, scan-order index maps) is a numpy constant. Where bs divides
both sides the reorder is a reshape and a transpose; otherwise it is one
gather through the index maps. Every function that takes a matrix also
takes a batch of them, (B, H * W): the bands of the sharded layout.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from huffman_codec_tpu_torch.formats import GROUP_K
from huffman_codec_tpu_torch.ops import kernels
from huffman_codec_tpu_torch.ops.canonical import build_lengths_pm, histogram
from huffman_codec_tpu_torch.ops.rle import (
    _emissions,
    rle_concat,
    rle_encode,
    rle_encoded_size,
    rle_max_encoded_len,
)

INIT_RLE_BLOCK_SIZE = 8
MAX_RLE_DOUBLING_STEPS = 7
ADAPT_HEADER_BYTES = 24  # three big-endian u64s


def candidate_sizes(width: int, height: int) -> list[int]:
    """The reference's search schedule: 8 always (after the minimum
    check), then doublings while they fit both sides."""
    if min(width, height) < INIT_RLE_BLOCK_SIZE:
        raise ValueError("too small 2D data dimensions")
    sizes, bs = [], INIT_RLE_BLOCK_SIZE
    for step in range(MAX_RLE_DOUBLING_STEPS + 1):
        if step > 0 and (bs > width or bs > height):
            break
        sizes.append(bs)
        bs *= 2
    return sizes


@functools.lru_cache(maxsize=16)
def _tile_maps(width: int, height: int, bs: int):
    """Per-tile scan-order index maps: (hor_idx, ver_idx) int64
    (n_tiles, bs * bs) flat matrix indices of position j of tile t in
    row-major and column-major order (positions past a clamped tile's
    sx * sy point at the tile's base and are masked by the valid length),
    and the valid lengths int32 (n_tiles,)."""
    bpl = -(-width // bs)
    t = np.arange(bpl * -(-height // bs), dtype=np.int64)[:, None]
    bx, by = (t % bpl) * bs, (t // bpl) * bs
    sx = np.minimum(bs, width - bx)
    sy = np.minimum(bs, height - by)
    j = np.arange(bs * bs, dtype=np.int64)[None, :]
    valid = j < sx * sy
    base = by * width + bx
    hor = np.where(valid, (by + j // sx) * width + bx + j % sx, base)
    ver = np.where(valid, (by + j % sy) * width + bx + j // sy, base)
    return hor, ver, (sx * sy)[:, 0].astype(np.int32)


def _aligned(width: int, height: int, bs: int) -> bool:
    return width % bs == 0 and height % bs == 0


def _tiles_fast(flat: torch.Tensor, width: int, height: int, bs: int):
    """The tile reorder where bs divides both sides: a reshape and a
    transpose. Tiles in (by, bx) row-major order; position j of a
    horizontal tile is y * bs + x, of a vertical one x * bs + y."""
    lead = flat.shape[:-1]
    k = len(lead)
    m = flat.reshape(*lead, height // bs, bs, width // bs, bs)
    pre = list(range(k))
    hor = m.permute(*pre, k, k + 2, k + 1, k + 3).reshape(*lead, -1, bs * bs)
    ver = m.permute(*pre, k, k + 2, k + 3, k + 1).reshape(*lead, -1, bs * bs)
    return hor, ver


def _gather_tiles(flat: torch.Tensor, width: int, height: int, bs: int):
    """(..., H * W) uint8 -> the tiles in both scan orders, each
    (..., n_tiles, bs * bs), and their valid lengths (n_tiles,) int32."""
    dev = flat.device
    if _aligned(width, height, bs):
        hor, ver = _tiles_fast(flat, width, height, bs)
        return hor, ver, torch.full((hor.shape[-2],), bs * bs,
                                    dtype=torch.int32, device=dev)
    hor_idx, ver_idx, lens = _tile_maps(width, height, bs)
    return (flat[..., torch.from_numpy(hor_idx).to(dev)],
            flat[..., torch.from_numpy(ver_idx).to(dev)],
            torch.from_numpy(lens).to(dev))


def _tile_sizes(flat: torch.Tensor, width: int, height: int, bs: int):
    """(hor_sizes, ver_sizes, lens): every tile's encoded size in both scan
    orders, nothing materialised."""
    hor, ver, lens = _gather_tiles(flat, width, height, bs)
    return rle_encoded_size(hor, lens), rle_encoded_size(ver, lens), lens


def adapt_search_sizes(matrix: torch.Tensor, width: int,
                       height: int) -> torch.Tensor:
    """The reference's block-size search: the v1 adaptive payload's bytes
    (its in-band header included) for every candidate block size, int64
    on the device. The caller takes the first minimum, so a tie keeps the
    smaller block."""
    flat = matrix.reshape(-1)
    totals = []
    for bs in candidate_sizes(width, height):
        h, v, _ = _tile_sizes(flat, width, height, bs)
        nt = h.shape[0]
        totals.append(ADAPT_HEADER_BYTES + (nt + 7) // 8
                      + torch.minimum(h, v).sum())
    return torch.stack(totals)


def grouped_manifest(nt: int, bs: int, est_payload: int) -> bool:
    """Use the grouped manifest when per-tile lengths would cost more than
    about 1.5% of the estimated payload (many tiles at a small bs)."""
    per_tile = nt * tile_len_width(bs)
    return nt > GROUP_K and per_tile > max(64, est_payload // 64)


def _tile_geom_arrays(width: int, height: int, bs: int) -> np.ndarray:
    """Per-tile decoded sizes sx * sy (border tiles clamped)."""
    bpl = -(-width // bs)
    t = np.arange(bpl * -(-height // bs))
    sx = np.minimum(bs, width - (t % bpl) * bs)
    sy = np.minimum(bs, height - (t // bpl) * bs)
    return (sx * sy).astype(np.int32)


def adapt_group_tile_lens(stream: torch.Tensor, group_offs: torch.Tensor,
                          total: int, width: int, height: int, bs: int,
                          group_cap: int) -> torch.Tensor:
    """Per-tile stream lengths from a grouped manifest. ``group_offs``
    (int32 (n_groups,)) are the byte offsets of every GROUP_K-th tile in
    the concatenated tile stream of ``total`` bytes; inside a group the
    borders are found again by walking the decoder FSM and cutting where
    the output reaches the tile's geometric size. Returns int32
    (n_groups * GROUP_K,) lengths, zero past the last tile."""
    sizes_np = _tile_geom_arrays(width, height, bs)
    sizes = np.zeros(group_offs.shape[0] * GROUP_K, np.int32)
    sizes[: sizes_np.shape[0]] = sizes_np
    return kernels.group_tile_lens(
        stream, group_offs, torch.from_numpy(sizes).to(stream.device),
        int(total), group_cap)


def tile_len_width(bs: int) -> int:
    """Manifest bytes per tile length: a tile's stream is at most
    rle_max_encoded_len(bs * bs) bytes, so u16 is enough through bs 181."""
    return 2 if rle_max_encoded_len(bs * bs) <= 0xFFFF else 4


def _emission_histogram(vals: torch.Tensor, n_invalid) -> torch.Tensor:
    """(256,) int64 counts of the emitted bytes. ``vals`` holds each
    position's emission with the positions that emit nothing as 0; the
    caller says how many of those there are and bucket 0 is corrected by
    that number, so the histogram runs dense over rows of 8192 with no
    compaction pass."""
    L2 = 8192
    flat = vals.reshape(-1)
    pad = -flat.shape[0] % L2
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    rows = flat.view(-1, L2)
    full = torch.full((rows.shape[0],), L2, dtype=torch.int32,
                      device=rows.device)
    counts = histogram(rows, full).sum(dim=0, dtype=torch.int64)
    counts[0] -= n_invalid + pad
    return counts


def _scan_emissions(tiles: torch.Tensor, lens: torch.Tensor):
    """One scan order of the score: every tile's encoded size (n_tiles,)
    and each position's emission value (its literal, else its count byte,
    else 0) as (n_tiles, bs * bs) uint8."""
    emit_lit, emit_cnt, q = _emissions(tiles, lens)
    size = emit_lit.sum(dim=1) + emit_cnt.sum(dim=1)
    cnt_val = ((q - 2) & 255).to(torch.uint8)
    zero = torch.zeros((), dtype=torch.uint8, device=tiles.device)
    return size, torch.where(emit_lit, tiles,
                             torch.where(emit_cnt, cnt_val, zero))


def _adapt_score_v3(matrix: torch.Tensor, width: int, height: int,
                    bs: int) -> torch.Tensor:
    """Estimated final v3 container bytes of one candidate block size,
    nothing materialised: per-tile sizes in both scan orders from the
    closed-form emission rule, the entropy estimate from a histogram of
    the winning direction's emission values, plus the tile manifest. A
    position that emits both its literal and a count byte adds only the
    literal to the histogram while both bytes count as emitted; the
    JAX package's score has the same arithmetic, and the block size
    chosen must be the same. Returns an int64 scalar on the device."""
    hor, ver, lens = _gather_tiles(matrix.reshape(-1), width, height, bs)
    nt, T = hor.shape
    h_sz, h_vals = _scan_emissions(hor, lens)
    v_sz, v_vals = _scan_emissions(ver, lens)
    dirs = (h_sz <= v_sz)[:, None]  # horizontal wins ties
    vals = torch.where(dirs, h_vals, v_vals)
    emitted = torch.minimum(h_sz, v_sz).sum()
    counts = _emission_histogram(vals, nt * T - emitted)
    bit_lens = build_lengths_pm(counts[None, :])[0]
    est = (counts * bit_lens).sum() // 8
    manifest = torch.full_like(est, nt * tile_len_width(bs))
    if nt > GROUP_K:  # grouped_manifest's rule on the estimate
        manifest = torch.where(manifest > (est // 64).clamp(min=64),
                               -(-nt // GROUP_K) * 4, manifest)
    return est + manifest + (nt + 7) // 8


def adapt_search_best_v3(matrix: torch.Tensor, width: int, height: int,
                         max_height: int | None = None) -> int:
    """The v3 block-size search: the candidate with the least estimated
    final container bytes (entropy-coded payload plus tile manifest, not
    the raw RLE size the reference minimises). The first minimum wins, so
    a tie keeps the smaller block. ``max_height`` bounds the candidates
    (a band's height) while the score runs over the whole matrix. Each
    candidate's tensors are freed before the next is scored; the scores
    are fetched together."""
    cands = candidate_sizes(width, min(height, max_height or height))
    scores = torch.stack([_adapt_score_v3(matrix, width, height, b)
                          for b in cands])
    return cands[int(np.argmin(scores.cpu().numpy()))]


def _be64(v: int) -> np.ndarray:
    return np.frombuffer(int(v).to_bytes(8, "big"), np.uint8)


def adapt_encode_bands(bands: torch.Tensor, width: int, height: int, bs: int,
                       out_len: int):
    """Adaptive payload of each (B, H * W) uint8 matrix at one block size,
    without the in-band header. Returns (streams (B, out_len) uint8 zero
    past each end, totals (B,) int32, dirs (B, n_tiles) bool, tile_lens
    (B, n_tiles) int32)."""
    B = bands.shape[0]
    hor, ver, lens = _gather_tiles(bands, width, height, bs)
    nt, T = hor.shape[1:]
    cap = rle_max_encoded_len(T)
    rep = lens.repeat(B)
    hor_s, hor_n = rle_encode(hor.reshape(B * nt, T), rep, cap)
    ver_s, ver_n = rle_encode(ver.reshape(B * nt, T), rep, cap)
    dirs = hor_n <= ver_n  # horizontal wins ties
    tile_s = torch.where(dirs[:, None], hor_s, ver_s).view(B, nt, cap)
    tile_n = torch.minimum(hor_n, ver_n).view(B, nt)
    streams, totals = rle_concat(tile_s, tile_n, out_len)
    return streams, totals, dirs.view(B, nt), tile_n


def adapt_encode_fixed(matrix: torch.Tensor, width: int, height: int, bs: int,
                       out_len: int | None = None, with_header: bool = True):
    """The adaptive payload of one matrix at one block size. Returns
    (stream uint8 (out_len,), total length, dirs bool (n_tiles,),
    tile_lens int32 (n_tiles,)). With ``with_header`` the stream starts
    with the reference's in-band header and is its v1 payload bit for
    bit; the v3 container passes False (the manifest replaces the
    header) and the tile data start at offset 0."""
    nt = -(-width // bs) * -(-height // bs)
    n_dir_bytes = (nt + 7) // 8
    header_len = ADAPT_HEADER_BYTES + n_dir_bytes if with_header else 0
    if out_len is None:
        out_len = header_len + nt * rle_max_encoded_len(bs * bs)
    body, totals, dirs, tile_n = adapt_encode_bands(
        matrix.reshape(1, -1), width, height, bs, out_len - header_len)
    body, dirs, tile_n = body[0], dirs[0], tile_n[0]
    total = totals[0] + header_len
    if not with_header:
        return body, total, dirs, tile_n
    hdr = np.concatenate([_be64(width), _be64(height), _be64(bs)])
    dir_bytes = np.packbits(dirs.cpu().numpy().astype(np.uint8))
    hdr = torch.from_numpy(np.concatenate([hdr, dir_bytes])).to(body.device)
    return torch.cat([hdr, body]), total, dirs, tile_n


def _cut_tile_rows(streams: torch.Tensor, tile_lens: torch.Tensor, bs: int):
    """Every tile's stream cut out of (B, L) concatenated tile data as a
    row of its own: ((B * n_tiles, rle_max_encoded_len(bs * bs)) uint8,
    zero past each tile's length, and the lengths (B * n_tiles,) int32)."""
    B, L = streams.shape
    nt = tile_lens.shape[1]
    cap = rle_max_encoded_len(bs * bs)
    tl = tile_lens.to(torch.int64)
    off = torch.cumsum(tl, dim=1) - tl
    j = torch.arange(cap, device=streams.device)
    gidx = (off[:, :, None] + j).clamp(0, max(L - 1, 0))
    enc = torch.gather(streams, 1, gidx.view(B, nt * cap)).view(B, nt, cap)
    enc = torch.where(j < tl[:, :, None], enc, 0)
    return enc.view(B * nt, cap), tile_lens.reshape(-1).to(torch.int32)


def _place_tiles(tiles: torch.Tensor, dirs: torch.Tensor, width: int,
                 height: int, bs: int):
    """Decoded tiles (B * n_tiles, bs * bs) in their scan orders ``dirs``
    (B, n_tiles) back to (B, H * W) matrix order: the inverse transpose
    where bs divides both sides, else a scatter through the index maps."""
    B, nt = dirs.shape
    dev = tiles.device
    T = bs * bs
    if _aligned(width, height, bs):
        t = tiles.view(B, height // bs, width // bs, bs, bs)
        t = torch.where(dirs.view(B, height // bs, width // bs, 1, 1),
                        t, t.transpose(3, 4))
        return t.permute(0, 1, 3, 2, 4).reshape(B, height * width)
    hor_idx, ver_idx, lens = _tile_maps(width, height, bs)
    idx = torch.where(dirs[:, :, None], torch.from_numpy(hor_idx).to(dev),
                      torch.from_numpy(ver_idx).to(dev))
    valid = (torch.arange(T, device=dev)[None, :]
             < torch.from_numpy(lens).to(dev)[:, None])
    # positions past a clamped tile's size land in one spare slot
    idx = torch.where(valid, idx, width * height)
    out = torch.zeros((B, width * height + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, idx.view(B, nt * T), tiles.view(B, nt * T))
    return out[:, : width * height]


def adapt_decode_bands(streams: torch.Tensor, tile_lens: torch.Tensor,
                       dirs: torch.Tensor, width: int, height: int, bs: int):
    """Inverse of ``adapt_encode_bands`` given the per-tile manifest:
    (B, L) uint8 streams of concatenated tile data, tile_lens and dirs
    (B, n_tiles) -> (B, H * W) uint8. Every tile's stream is cut out as a
    row of its own, the rows are decoded together (the ``rle_expand``
    kernel on a GPU), and the tiles go back to matrix order by the
    inverse reorder."""
    enc, rows_len = _cut_tile_rows(streams, tile_lens, bs)
    tiles = kernels.rle_expand(
        enc, rows_len,
        torch.zeros(enc.shape[0], dtype=torch.uint8, device=enc.device),
        bs * bs, False)
    return _place_tiles(tiles, dirs, width, height, bs)


def adapt_decode_tiled(stream: torch.Tensor, tile_lens: torch.Tensor,
                       dirs: torch.Tensor, width: int, height: int,
                       bs: int) -> torch.Tensor:
    """Parallel adaptive decode of one matrix given the per-tile manifest.
    ``stream`` holds only the concatenated tile data (no header). Returns
    the matrix flat, uint8 (H * W,)."""
    return adapt_decode_bands(stream[None, :], tile_lens[None, :],
                              dirs[None, :], width, height, bs)[0]
