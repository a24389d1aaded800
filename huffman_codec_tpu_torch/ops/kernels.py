"""The hand-written CUDA kernels of the port: the seven of the sharded
and the global canonical round trips, the tile mode of the first (the
adaptive band stage), the group walk of the grouped adaptive manifest and
the FGK encode and decode.

Each kernel has three parts here:

* a wrapper that launches the kernel for CUDA tensors, at every shape a
  ``CodecConfig`` of the JAX package admits, and adds one to its
  ``launches`` count per launch. Given CPU tensors it runs the plain
  version instead (that is the only case it does: no CUDA tensor ever
  takes a plain version); any other device, a wrong dtype, shape or
  layout raises;
* the plain PyTorch version of the same function, vectorised so that it
  also runs at full size on the card, where ``chip_smoke.py`` holds the
  kernel against it;
* the launch count.

The kernels' sources are ``csrc/<name>.cu``; each says which TPU kernel
it replaces, what bounds it on the H100 and what its design does about
that. Words of the canonical bitstream are u32 on the wire; tensors carry
them as int32 holding the same bits.
"""

from __future__ import annotations

import threading

import torch

from huffman_codec_tpu_torch.ops import _build
from huffman_codec_tpu_torch.ops import fgk as _fgk
from huffman_codec_tpu_torch.ops import rle as _rle
from huffman_codec_tpu_torch.ops.diff import diff_apply, diff_revert
from huffman_codec_tpu_torch.ops.pack import to_i32_bits

N_SYM = 256
MASK26 = (1 << 26) - 1


def lane_words_cap(lane: int) -> int:
    """Output words per lane: codes are <= 31 bits, rounded to a
    128-word multiple (the v3 wire's worst-case lane stride)."""
    return -(-(lane * 31 // 32 + 1) // 128) * 128


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------


def _check_cuda(name: str, *specs):
    """specs: (tensor, dtype, ndim). All on one CUDA device, contiguous."""
    dev = specs[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU (plain "
                         f"version) or a CUDA device, got {dev}")
    for t, dtype, ndim in specs:
        if t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name}: expected a {ndim}-d {dtype} tensor, "
                             f"got {t.dim()}-d {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")
    return dev


def _launch(src: str, symbol: str, ptrs, ints, dev):
    fn = _build.bind(src, symbol, len(ptrs), len(ints))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*[None if t is None else t.data_ptr() for t in ptrs],
             *[int(i) for i in ints], stream)
    if err:
        raise RuntimeError(f"{symbol}: CUDA error {err} at launch")


# ---------------------------------------------------------------------------
# 1. fused diff + MNP-5 RLE encode; 1b. its tile mode
# ---------------------------------------------------------------------------


# bytes a block of csrc/rle_encode.cu takes (its kTile); the launcher
# refuses a scratch buffer sized from a smaller value
RLE_TILE = 8192


def _check_tile(n: int, tile: int, use_diff: bool) -> None:
    if tile & (tile - 1) or n % tile:
        raise ValueError("tile must be a power of two dividing n")
    if use_diff:
        raise ValueError("tile mode requires use_diff=False")


def rle_diff_encode_plain(chunks, lengths, carries, use_diff: bool, cap: int,
                          tile: int = 0):
    if not tile:
        work = diff_apply(chunks, carries) if use_diff else chunks
        return _rle.rle_encode(work, lengths, cap)
    # every tile of a row encoded alone, the streams concatenated in order
    C, n = chunks.shape
    _check_tile(n, tile, use_diff)
    nt = n // tile
    t0 = torch.arange(nt, device=chunks.device) * tile
    tile_lens = (lengths.to(torch.int64)[:, None] - t0).clamp(0, tile)
    tcap = _rle.rle_max_encoded_len(tile)
    s, ln = _rle.rle_encode(chunks.reshape(C * nt, tile),
                            tile_lens.reshape(-1), tcap)
    return _rle.rle_concat(s.view(C, nt, tcap), ln.view(C, nt), cap)


def rle_diff_encode(chunks: torch.Tensor, lengths: torch.Tensor,
                    carries: torch.Tensor, use_diff: bool, cap: int,
                    tile: int = 0):
    """Per-chunk diff (seeded by ``carries``) then MNP-5 encode.

    chunks (C, n) uint8, lengths (C,) int32 valid bytes, carries (C,)
    uint8. Returns (streams (C, cap) uint8, zero past each end; encoded
    lengths (C,) int32). On CUDA, n and cap stay below 2^30; rows whose
    length does not divide by 16 are padded with zeros to a multiple of 16
    for the kernel's 16-byte loads (bytes past ``lengths`` are never
    encoded, so the padding changes nothing).

    ``tile`` > 0 (a power of two dividing n, without diff) is the tile
    mode: each row is n / tile tiles, every tile encoded as a stream of
    its own (runs restart at its first byte, its last byte is a fresh
    literal) and the tile streams concatenated in order, which is an
    adaptive band's payload when the row holds the band's tiles in their
    winning scan order. Its launches are counted apart, as
    ``tile_launches``."""
    if tile:
        _check_tile(chunks.shape[1], tile, use_diff)
    if chunks.device.type == "cpu":
        return rle_diff_encode_plain(chunks, lengths, carries, use_diff, cap,
                                     tile)
    dev = _check_cuda("rle_diff_encode", (chunks, torch.uint8, 2),
                      (lengths, torch.int32, 1), (carries, torch.uint8, 1))
    C, n = chunks.shape
    if n >= 1 << 30 or cap >= 1 << 30:
        raise ValueError("rle_diff_encode: rows and streams hold fewer than "
                         "2^30 bytes")
    if n % 16:
        chunks = torch.nn.functional.pad(chunks, (0, -n % 16))
        n = chunks.shape[1]
    streams = torch.empty((C, cap), dtype=torch.uint8, device=dev)
    out_lens = torch.empty((C,), dtype=torch.int32, device=dev)
    if C:
        # the look-back's status word a tile of the kernel and its tile
        # counter, zeroed by the launch on the same stream
        scratch = torch.empty(C * max(1, -(-n // RLE_TILE)) + 1,
                              dtype=torch.int64, device=dev)
        _launch("rle_encode", "rle_encode_launch",
                (chunks, lengths, carries, streams, out_lens, scratch),
                (scratch.numel(), C, n, cap, int(use_diff), tile), dev)
        if tile:
            rle_diff_encode.tile_launches += 1
        else:
            rle_diff_encode.launches += 1
    return streams, out_lens


rle_diff_encode.launches = 0
rle_diff_encode.tile_launches = 0


# ---------------------------------------------------------------------------
# 2. byte histogram of each chunk's valid prefix
# ---------------------------------------------------------------------------


def histogram256_plain(data, lengths):
    C, L = data.shape
    pos = torch.arange(L, device=data.device)[None, :]
    valid = pos < lengths.to(torch.int64)[:, None]
    idx = torch.where(valid, data.to(torch.int64), N_SYM)  # N_SYM: dropped
    idx = idx + torch.arange(C, device=data.device)[:, None] * (N_SYM + 1)
    counts = torch.bincount(idx.reshape(-1), minlength=C * (N_SYM + 1))
    return counts.view(C, N_SYM + 1)[:, :N_SYM].to(torch.int32)


def histogram256(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(C, 256) int32 byte counts of each (C, L) uint8 row's first
    ``lengths[c]`` bytes, any L.

    With fewer rows than the card has SMs, each row is cut into slices
    counted by blocks of their own, and the launch is two operations on
    the stream: a memset of the counts, then the kernel adding each
    slice's counts to them. A call adds one to ``launches`` either way
    (and a CUDA graph replay of it one, as its capture recorded)."""
    if data.device.type == "cpu":
        return histogram256_plain(data, lengths)
    dev = _check_cuda("histogram256", (data, torch.uint8, 2),
                      (lengths, torch.int32, 1))
    C, L = data.shape
    out = torch.empty((C, N_SYM), dtype=torch.int32, device=dev)
    if C:
        _launch("histogram", "histogram_launch", (data, lengths, out),
                (C, L), dev)
        histogram256.launches += 1
    return out


histogram256.launches = 0


# ---------------------------------------------------------------------------
# 3. canonical lane pack
# ---------------------------------------------------------------------------


def lane_pack_plain(data, lengths, tables, lane: int):
    C, L = data.shape
    nl, W = L // lane, lane_words_cap(lane)
    dev = data.device
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < lengths.to(torch.int64)[:, None]
    per = torch.gather(tables.to(torch.int64) & 0xFFFFFFFF, 1,
                       data.to(torch.int64))
    per = torch.where(valid, per, 0).view(C, nl, lane)
    code, ln = per & MASK26, per >> 26
    incl = torch.cumsum(ln, dim=2)
    off = incl - ln
    bits = incl[:, :, -1]
    # each code as a 64-bit window starting at word off >> 5, MSB first
    sh = torch.where(ln > 0, 64 - (off & 31) - ln, 0)
    win = code << sh
    w0 = off >> 5
    row = (torch.arange(C * nl, device=dev) * (W + 1)).view(C, nl, 1)
    acc = torch.zeros(C * nl * (W + 1), dtype=torch.int64, device=dev)
    # contributions to one word have disjoint bits, so add == or
    acc.scatter_add_(0, (row + w0).reshape(-1),
                     ((win >> 32) & 0xFFFFFFFF).reshape(-1))
    acc.scatter_add_(0, (row + w0 + 1).reshape(-1),
                     (win & 0xFFFFFFFF).reshape(-1))
    words = to_i32_bits(acc).view(C, nl, W + 1)[:, :, :W].clone()
    words[:, :, W - 1] = 0  # the TPU wrapper's bit-count column
    return words, bits.to(torch.int32)


def lane_pack(data: torch.Tensor, lengths: torch.Tensor,
              tables: torch.Tensor, lane: int):
    """Canonical encode of (C, L) uint8 rows into word-aligned lanes.

    tables (C, 256) int32: ``code | len << 26`` per symbol. Lane k of a
    chunk holds symbols [k*lane, (k+1)*lane) packed MSB-first. Returns
    (words (C, L/lane, lane_words_cap(lane)) int32 zero-padded, bits
    (C, L/lane) int32). Any lane dividing L."""
    if data.device.type == "cpu":
        return lane_pack_plain(data, lengths, tables, lane)
    dev = _check_cuda("lane_pack", (data, torch.uint8, 2),
                      (lengths, torch.int32, 1), (tables, torch.int32, 2))
    C, L = data.shape
    if L % lane:
        raise ValueError("lane_pack: L must divide by lane")
    nl, W = L // lane, lane_words_cap(lane)
    words = torch.empty((C, nl, W), dtype=torch.int32, device=dev)
    bits = torch.empty((C, nl), dtype=torch.int32, device=dev)
    if C and nl:
        _launch("lane_pack", "lane_pack_launch",
                (data, lengths, tables, words, bits), (C, L, lane, W), dev)
        lane_pack.launches += 1
    return words, bits


lane_pack.launches = 0


# ---------------------------------------------------------------------------
# 4. repad: dense wire words -> fixed-stride lane layout
# ---------------------------------------------------------------------------


def repad_words_plain(flat, lane_words, wb: int):
    C, nl = lane_words.shape
    dev = flat.device
    lw = lane_words.to(torch.int64).reshape(-1)
    start = torch.cumsum(lw, 0) - lw
    total = int(lw.sum())
    lid = torch.repeat_interleave(torch.arange(C * nl, device=dev), lw)
    i = torch.arange(total, device=dev)
    j = i - torch.repeat_interleave(start, lw)
    keep = (j < wb) & (i < flat.numel())
    out = torch.zeros(C * nl * wb, dtype=torch.int32, device=dev)
    out[(lid * wb + j)[keep]] = flat[i[keep]]
    return out.view(C, nl * wb)


def repad_words(flat: torch.Tensor, lane_words: torch.Tensor,
                wb: int) -> torch.Tensor:
    """Dense wire words of a step's chunks (flat (N,) int32, chunk after
    chunk, lane after lane) -> (C, nl * wb) int32 with lane k of chunk c at
    columns [k*wb, k*wb + lane_words[c, k]); every other slot is 0."""
    if flat.device.type == "cpu":
        return repad_words_plain(flat, lane_words, wb)
    dev = _check_cuda("repad_words", (flat, torch.int32, 1),
                      (lane_words, torch.int32, 2))
    C, nl = lane_words.shape
    if wb < 1 or C * nl * wb >= REPAD_MAX or flat.numel() >= 1 << 31:
        raise ValueError("repad_words: wb >= 1, and the output and the words "
                         f"hold fewer than {REPAD_MAX} and 2^31 words")
    out = torch.empty((C, nl * wb), dtype=torch.int32, device=dev)
    if C * nl:
        scratch, epoch = _repad_scratch(dev, repad_scratch_words(C, nl, wb))
        _launch("repad", "repad_launch", (flat, lane_words, out, scratch),
                (scratch.numel(), C, nl, wb, flat.numel(), epoch), dev)
        repad_words.launches += 1
    return out


repad_words.launches = 0
# output slots a block of csrc/repad.cu covers (its kSpan); the launcher
# refuses a scratch buffer sized from a smaller value
REPAD_SPAN = 4096
REPAD_MAX = (1 << 31) - REPAD_SPAN
_repad_scratches: dict = {}
_repad_lock = threading.Lock()


def repad_scratch_words(C: int, nl: int, wb: int) -> int:
    """int64 words of ``repad_words``' scratch: a status word for each
    block of REPAD_SPAN output slots."""
    return -(-(C * nl * wb) // REPAD_SPAN)


def _repad_scratch(dev: torch.device, words: int):
    """(scratch, launch number) for ``repad_words`` on the current stream
    of ``dev``. A status word counts only in the launch whose number it
    carries, so the words need no zeroing between launches: one scratch is
    kept for each stream (launches on one stream run in order), replaced by
    a larger one when a launch needs more, and zeroed again before the
    numbers (1 .. 2^31 - 1) come round. A CUDA graph replays the number it
    captured, so a capture gets a scratch of its own, zeroed in the graph
    itself (its memory stays the graph's), and no two graphs share one."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(max(words, 1), dtype=torch.int64, device=dev), 1
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _repad_lock:  # two threads on one stream must not share a number
        buf, epoch = _repad_scratches.get(key, (None, 0))
        if buf is None or buf.numel() < words:
            buf = torch.zeros(max(words, 1024), dtype=torch.int64,
                              device=dev)
        epoch += 1
        if epoch >= 1 << 31:
            buf.zero_()
            epoch = 1
        _repad_scratches[key] = (buf, epoch)
    return buf, epoch


# ---------------------------------------------------------------------------
# 5. canonical lane decode
# ---------------------------------------------------------------------------


def decode_tables(lens_tables: torch.Tensor, max_len: int):
    """Per-chunk (bound, base, canon_syms) of a canonical code: a codeword
    of length l has prefix value v < bound[l], and its symbol is
    canon_syms[base[l] + v]. bound/base are (C, max_len) for l = 1..max_len."""
    from huffman_codec_tpu_torch.ops.canonical import canonical_tables

    first_code, start_index, canon_syms = canonical_tables(
        lens_tables.to(torch.int64))
    bl_count = torch.diff(start_index, dim=1)
    bound = first_code[:, 1:max_len + 1] + bl_count[:, 1:max_len + 1]
    base = start_index[:, 1:max_len + 1] - first_code[:, 1:max_len + 1]
    return bound, base, canon_syms


def lane_decode_plain(buf, lens_tables, lengths, lane: int, max_len: int):
    C, nl, wb = buf.shape
    dev = buf.device
    bound, base, canon = decode_tables(lens_tables, max_len)
    n = C * nl
    rep = torch.arange(C, device=dev).repeat_interleave(nl)
    bound, base, canon = bound[rep], base[rep], canon[rep]
    words = buf.reshape(n, wb).to(torch.int64) & 0xFFFFFFFF
    ns = (lengths.to(torch.int64)[:, None]
          - torch.arange(nl, device=dev)[None, :] * lane).clamp(0, lane)
    ns = ns.reshape(n)
    lvec = torch.arange(1, max_len + 1, device=dev)[None, :]
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    out = torch.zeros((n, lane), dtype=torch.uint8, device=dev)

    def word(i):
        got = torch.gather(words, 1, i.clamp(max=wb - 1)[:, None])[:, 0]
        return torch.where(i < wb, got, 0)

    for k in range(lane):
        i, r = pos >> 5, pos & 31
        win = (((word(i) << 32) | word(i + 1)) >> (32 - r)) & 0xFFFFFFFF
        v = win[:, None] >> (32 - lvec)
        sel = v < bound
        has = sel.any(dim=1)
        first = sel.to(torch.int32).argmax(dim=1, keepdim=True)
        ln = torch.where(has, first[:, 0] + 1, 0)
        idx = torch.where(has, torch.gather(base + v, 1, first)[:, 0], 0)
        sym = torch.gather(canon, 1, idx.clamp(0, N_SYM - 1)[:, None])[:, 0]
        active = k < ns
        out[:, k] = torch.where(active, sym, 0).to(torch.uint8)
        pos = pos + torch.where(active, ln, 0)
    return out.view(C, nl * lane)


def lane_decode(buf: torch.Tensor, lens_tables: torch.Tensor,
                lengths: torch.Tensor, lane: int, max_len: int = 31):
    """Canonical decode of padded lanes (C, nl, wb) int32 with (C, 256)
    uint8 code lengths; lane k decodes clip(lengths[c] - k*lane, 0, lane)
    symbols. Returns (C, nl * lane) uint8, zero past each lane's symbols.
    Any lane; 1 <= max_len <= 31."""
    if buf.device.type == "cpu":
        return lane_decode_plain(buf, lens_tables, lengths, lane, max_len)
    dev = _check_cuda("lane_decode", (buf, torch.int32, 3),
                      (lens_tables, torch.uint8, 2), (lengths, torch.int32, 1))
    C, nl, wb = buf.shape
    if not 1 <= max_len <= 31:
        raise ValueError("lane_decode: 1 <= max_len <= 31")
    out = torch.empty((C, nl * lane), dtype=torch.uint8, device=dev)
    if C:
        _launch("lane_decode", "lane_decode_launch",
                (buf, lens_tables, lengths, out), (C, nl, wb, lane, max_len),
                dev)
        lane_decode.launches += 1
    return out


lane_decode.launches = 0


# ---------------------------------------------------------------------------
# 7. canonical lane decode for few fat lanes
# ---------------------------------------------------------------------------


def lane_decode_lanemajor_plain(buf, lens_tables, lengths, lane: int,
                                max_len: int):
    """Plain version of ``lane_decode_lanemajor``: the function is
    ``lane_decode``'s, so it shares that plain version. Its loop runs
    ``lane`` steps of small ops, so keep ``lane`` small on the CPU."""
    return lane_decode_plain(buf, lens_tables, lengths, lane, max_len)


def lane_decode_lanemajor(buf: torch.Tensor, lens_tables: torch.Tensor,
                          lengths: torch.Tensor, lane: int,
                          max_len: int = 31):
    """Canonical decode with ``lane_decode``'s contract for few fat lanes
    (the whole-file container: up to 112 lanes of up to 32768 symbols):
    one block per lane, its bits cut into ``fat_subseq_bits(wb)``-bit
    sub-sequences decoded in parallel and resynchronised. Any C and nl;
    needs lane % 128 == 0 and 1 <= max_len <= 31."""
    if lane % 128 or not 1 <= max_len <= 31:
        raise ValueError("lane_decode_lanemajor: lane must divide by 128, "
                         "1 <= max_len <= 31")
    if buf.device.type == "cpu":
        return lane_decode_lanemajor_plain(buf, lens_tables, lengths, lane,
                                           max_len)
    dev = _check_cuda("lane_decode_lanemajor", (buf, torch.int32, 3),
                      (lens_tables, torch.uint8, 2), (lengths, torch.int32, 1))
    C, nl, wb = buf.shape
    out = torch.empty((C, nl * lane), dtype=torch.uint8, device=dev)
    if C * nl:
        _launch("lane_decode_lm", "lane_decode_lm_launch",
                (buf, lens_tables, lengths, out),
                (C, nl, wb, lane, max_len, fat_subseq_bits(wb)), dev)
        lane_decode_lanemajor.launches += 1
    return out


lane_decode_lanemajor.launches = 0
# threads of a block of csrc/lane_decode_lm.cu: a sub-sequence each
FAT_THREADS = 1024


def fat_subseq_bits(wb: int) -> int:
    """Bits of a sub-sequence of ``lane_decode_lanemajor``: the fewest
    words that let FAT_THREADS sub-sequences cover a lane of ``wb`` words,
    at least 3 (more than a code) and odd, so that the words the threads of
    a warp read at once lie in 32 different shared-memory banks."""
    return 32 * (max(3, -(-wb // FAT_THREADS)) | 1)


# ---------------------------------------------------------------------------
# 6. MNP-5 expansion + diff revert
# ---------------------------------------------------------------------------


def rle_expand_plain(streams, lengths, carries, out_len: int,
                     use_diff: bool):
    is_cnt = _rle.rle_classify(streams, lengths)
    out, total = _rle.rle_expand_runs(streams, is_cnt, lengths, out_len)
    if use_diff:
        j = torch.arange(out_len, device=streams.device)[None, :]
        out = torch.where(j < total[:, None], diff_revert(out, carries), 0)
    return out.to(torch.uint8)


def rle_expand(streams: torch.Tensor, lengths: torch.Tensor,
               carries: torch.Tensor, out_len: int, use_diff: bool,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """MNP-5 decode of (C, n) uint8 streams, ``lengths[c]`` valid bytes
    each: the count bytes found by the decoder FSM (what
    ops/rle.rle_classify computes), each expanded to its run, with the
    per-chunk diff revert seeded by ``carries`` when ``use_diff``. Returns
    (C, out_len) uint8, zero past each chunk's decoded length: ``out``
    when given (a contiguous (C, out_len) uint8 tensor on the streams'
    device, which the kernel writes directly when out_len is a multiple of
    16 and ``out`` is 16-byte aligned), else a new tensor. On CUDA the
    kernel writes rows of out_len rounded up to 16 bytes (its 16-byte
    stores), which are cut back to out_len: the output is a prefix of the
    decoded row either way. Rows and output index with 32-bit ints."""
    if out is not None and (out.shape != (streams.shape[0], out_len)
                            or out.dtype != torch.uint8
                            or out.device != streams.device
                            or not out.is_contiguous()):
        raise ValueError("rle_expand: out must be a contiguous (C, out_len) "
                         "uint8 tensor on the streams' device")
    if streams.device.type == "cpu":
        res = rle_expand_plain(streams, lengths, carries, out_len, use_diff)
        return res if out is None else out.copy_(res)
    dev = _check_cuda("rle_expand", (streams, torch.uint8, 2),
                      (lengths, torch.int32, 1), (carries, torch.uint8, 1))
    C, n = streams.shape
    if n >= RLE_EXPAND_MAX or out_len >= RLE_EXPAND_MAX:
        raise ValueError("rle_expand: rows and output hold fewer than "
                         f"{RLE_EXPAND_MAX} bytes (32-bit offsets)")
    width = -(-out_len // 16) * 16
    rows = (out if out is not None and width == out_len
            and out.data_ptr() % 16 == 0 else
            torch.empty((C, width), dtype=torch.uint8, device=dev))
    if C:
        _launch("rle_expand", "rle_expand_launch",
                (streams, lengths, carries, rows),
                (C, n, width, int(use_diff)), dev)
        rle_expand.launches += 1
    if rows is out or (out is None and width == out_len):
        return rows
    return (rows[:, :out_len].contiguous() if out is None
            else out.copy_(rows[:, :out_len]))


rle_expand.launches = 0
# csrc/rle_expand.cu keeps offsets in ints: a tile adds at most 2^20
# output bytes past out_len before the kernel stops
RLE_EXPAND_MAX = (1 << 31) - (1 << 21)


# ---------------------------------------------------------------------------
# tile lengths of a grouped adaptive manifest (no TPU kernel: the JAX
# package runs this walk as an XLA scan)
# ---------------------------------------------------------------------------


def group_tile_lens_plain(stream, group_offs, sizes, total: int,
                          group_cap: int, with_decoded: bool = False):
    """One step per stream byte of the longest group, every group at
    once: the decoder FSM with a restart each time a tile's output size
    is reached."""
    dev = stream.device
    ng = group_offs.shape[0]
    K = sizes.shape[0] // ng
    goff = group_offs.to(torch.int64)
    end = torch.cat([goff[1:], torch.tensor([total], device=dev)])
    glen = (end - goff).clamp(max=group_cap)
    steps = max(int(glen.max()), 0) if ng else 0
    j = torch.arange(steps, device=dev)
    at = (goff[:, None] + j).clamp(0, max(stream.shape[0] - 1, 0))
    seg = stream.to(torch.int64)[at]  # (ng, steps)
    # a trailing zero column: the tile size once a group's tiles are done
    sz = torch.cat([sizes.view(ng, K).to(torch.int64),
                    torch.zeros((ng, 1), dtype=torch.int64, device=dev)], 1)
    lens = torch.zeros((ng, K + 1), dtype=torch.int64, device=dev)
    decoded = torch.zeros_like(lens)
    zero = torch.zeros(ng, dtype=torch.int64, device=dev)
    t_rel, produced, match, count = zero, zero, zero - 1, zero
    for p in range(steps):
        byte = seg[:, p]
        active = p < glen
        is_cnt = count == 3
        new_match = torch.where(is_cnt, match, byte)
        eq = (match == byte) & ~is_cnt
        new_count = torch.where(is_cnt, 0, torch.where(eq, count + 1, 1))
        produced2 = produced + torch.where(is_cnt, byte, 1)
        slot = t_rel.clamp(max=K)[:, None]
        lens.scatter_add_(1, slot, active[:, None].to(torch.int64))
        decoded.scatter_(1, slot, torch.where(
            active[:, None], produced2[:, None], decoded.gather(1, slot)))
        done = produced2 >= sz.gather(1, slot)[:, 0]
        t_rel = torch.where(active & done, t_rel + 1, t_rel)
        produced = torch.where(active, torch.where(done, 0, produced2),
                               produced)
        match = torch.where(active, torch.where(done, -1, new_match), match)
        count = torch.where(active, torch.where(done, 0, new_count), count)
    lens = lens[:, :K].reshape(-1).to(torch.int32)
    if with_decoded:
        return lens, decoded[:, :K].reshape(-1).to(torch.int32)
    return lens


def group_tile_lens(stream: torch.Tensor, group_offs: torch.Tensor,
                    sizes: torch.Tensor, total: int, group_cap: int,
                    with_decoded: bool = False):
    """Per-tile stream lengths from a grouped manifest.

    stream (N,) uint8 holds concatenated per-tile MNP-5 streams, ``total``
    bytes in all; group_offs (ng,) int32 is the offset of every K-th
    tile's stream; sizes (ng * K,) int32 the decoded size of each tile
    (0 past the last tile). Each group is walked through the decoder FSM
    for at most ``group_cap`` bytes, and a tile ends where its decoded
    size is reached. Returns (ng * K,) int32 lengths; ``with_decoded``
    also returns what each tile's stream decodes to as walked, (ng * K,)
    int32: its size, more where a count byte overshoots it, less for the
    tile a group's bytes end inside, 0 for a tile never reached."""
    if stream.device.type == "cpu":
        return group_tile_lens_plain(stream, group_offs, sizes, total,
                                     group_cap, with_decoded)
    dev = _check_cuda("group_tile_lens", (stream, torch.uint8, 1),
                      (group_offs, torch.int32, 1), (sizes, torch.int32, 1))
    ng = group_offs.shape[0]
    if ng == 0 or sizes.shape[0] % ng or stream.shape[0] == 0:
        raise ValueError("group_tile_lens: needs a stream, and sizes "
                         "holding a whole number of tiles a group")
    lens = torch.empty_like(sizes)
    decoded = torch.empty_like(sizes) if with_decoded else None
    _launch("group_tile_lens", "group_tile_lens_launch",
            (stream, group_offs, sizes, lens, decoded),
            (ng, sizes.shape[0] // ng, stream.shape[0], total, group_cap),
            dev)
    group_tile_lens.launches += 1
    return (lens, decoded) if with_decoded else lens


group_tile_lens.launches = 0


# ---------------------------------------------------------------------------
# FGK adaptive Huffman encode and decode (no TPU kernel: the JAX package
# runs the serial tree update as an XLA scan)
# ---------------------------------------------------------------------------


def fgk_encode_plain(chunks, lengths, n_words: int):
    return _fgk.fgk_encode_batch(chunks, lengths, n_words)


def fgk_encode(chunks: torch.Tensor, lengths: torch.Tensor, n_words: int):
    """FGK encode of the first ``lengths[c]`` symbols of each (C, L) uint8
    row with a tree of its own. Returns (words (C, n_words) int32, the
    codes MSB-first, zero past each stream and cut at ``n_words``; bits
    (C,) int32)."""
    if chunks.device.type == "cpu":
        return fgk_encode_plain(chunks, lengths, n_words)
    dev = _check_cuda("fgk_encode", (chunks, torch.uint8, 2),
                      (lengths, torch.int32, 1))
    C, L = chunks.shape
    if n_words < 1:
        raise ValueError("fgk_encode: n_words >= 1")
    words = torch.empty((C, n_words), dtype=torch.int32, device=dev)
    bits = torch.empty((C,), dtype=torch.int32, device=dev)
    if C:
        _launch("fgk", "fgk_encode_launch", (chunks, lengths, words, bits),
                (C, L, n_words), dev)
        fgk_encode.launches += 1
    return words, bits


fgk_encode.launches = 0


def fgk_decode_plain(words, counts, out_len: int):
    return _fgk.fgk_decode_batch(words, counts, out_len)


def fgk_decode(words: torch.Tensor, counts: torch.Tensor,
               out_len: int) -> torch.Tensor:
    """FGK decode of (C, W) int32 word streams (W >= 1): the first
    ``counts[c]`` symbols of each, a tree a row. Returns (C, out_len)
    uint8, zero past each count; a read past a row reads its last word."""
    if words.device.type == "cpu":
        return fgk_decode_plain(words, counts, out_len)
    dev = _check_cuda("fgk_decode", (words, torch.int32, 2),
                      (counts, torch.int32, 1))
    C, W = words.shape
    if W < 1 or out_len < 0:
        raise ValueError("fgk_decode: rows of at least one word")
    out = torch.empty((C, out_len), dtype=torch.uint8, device=dev)
    if C:
        _launch("fgk", "fgk_decode_launch", (words, counts, out),
                (C, W, out_len), dev)
        fgk_decode.launches += 1
    return out


fgk_decode.launches = 0


KERNELS = (rle_diff_encode, histogram256, lane_pack, repad_words,
           lane_decode, rle_expand, lane_decode_lanemajor, group_tile_lens,
           fgk_encode, fgk_decode)
# kernel 1b shares kernel 1's wrapper and is counted under this name
TILE_MODE = "rle_diff_encode_tile"


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    rle_diff_encode.tile_launches = 0


def launch_counts() -> dict[str, int]:
    counts = {k.__name__: k.launches for k in KERNELS}
    counts[TILE_MODE] = rle_diff_encode.tile_launches
    return counts


def add_launches(counts: dict[str, int], sign: int = 1) -> None:
    """Add ``counts`` (as ``launch_counts`` gives them) to the kernels'
    counts, or take them away with ``sign=-1``: a CUDA graph replay
    launches what its capture recorded without passing through the
    wrappers, and the capture itself launches nothing."""
    for k in KERNELS:
        k.launches += sign * counts.get(k.__name__, 0)
    rle_diff_encode.tile_launches += sign * counts.get(TILE_MODE, 0)

