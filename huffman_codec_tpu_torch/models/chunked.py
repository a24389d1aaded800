"""TorchCodec: the v3 canonical codec on PyTorch and CUDA, in the global
layout (``CodecConfig``'s default) and the sharded streaming layout.

Writes the same container bytes as the JAX package's ``TPUCodec`` for the
same input and config, and decodes the containers of either package.
Layout of the v3 wire (little-endian; payload words big-endian):

    magic "HCTPU\\x03" | version u8 (3) | flags u8 | entropy u8
    table bit width u8 | lane-words bit width u8
    orig_size u64 | transformed_size u64 | chunk_size u32 | n_chunks u32
    lane u32 | crc32 u32 (of the original data)
    [adaptive] W u64 | H u64 | bs u64 | n_tiles u32
               scan directions, one bit a tile, MSB-first (1 = row-major)
               tile stream lengths, u16 (u32 from bs 256) * n_tiles, or
               [flag 0x10: grouped] the offset u32 of every 64th tile
    [sharded] rle_lens u32 * n_chunks | carries u8 * n_chunks
    [canonical] code-length tables, 4 or 5 bits packed (256 per chunk)
                lane_words of the used lanes, k bits packed
    payload: every chunk's lanes, each word-aligned, chunk after chunk

Sharded encode, one step of ``step_chunks`` input chunks at a time:
per-chunk diff seeded by the carry byte and MNP-5 RLE (kernel), byte
histogram (kernel), package-merge code lengths and canonical codes (torch
ops), lane pack (kernel), then the padding between lanes is stripped on
the device at a fixed shape. Sharded decode, per step: re-pad the wire
words to a fixed lane stride (kernel), canonical lane decode (kernel),
MNP-5 decode with the diff revert (kernel: it finds the count bytes
itself), then the crc32 check. Both run as the JAX package's step
pipeline (``models/pipeline.py``): every step uploaded and dispatched
before any is fetched, fetches in waves; on the card each canonical
encode step is one CUDA graph replay (``encode_step_chunks`` bounds
their geometries), and each decode step runs launch by launch; FGK
steps, each bound by one serial chain a chunk, run side by side on side
streams.

Global encode: diff and MNP-5 RLE over the whole input as one stream
(torch ops; runs cross chunk borders), the stream cut into chunks, the
same canonical stage. Two containers of the same wire are tried, the
whole stream as one chunk of 8 to 112 fat lanes (one table, the smallest
manifest) and ``chunk_size`` chunks at lane 2048 (a table per chunk), and
the smaller is kept; a small input whose v3 container is small also races
the reference's v1 format, encoded by the host C++ runtime. Global
decode: re-pad every chunk (kernel), canonical lane decode (the
block-per-lane kernel for a whole-file container's fat lanes), then the
whole-stream RLE decode and diff revert (torch ops), the size check and
the crc32. ``decode`` tells v1 and v2 blobs by their magic and hands them
to the host runtime.

Adaptive mode (``use_adapt``) replaces the stream RLE by the adaptive
block RLE of ``ops/adapt.py``: the input is a matrix ``width`` wide, cut
into bs x bs tiles, each MNP-5 encoded in the better of its two scan
orders, with bs searched for the least estimated container. Global: the
search and the tile encode run over the whole matrix (torch ops), the
concatenated tile streams take the place of the RLE stream, and the
manifest keeps every tile's direction and length (or, for many small
tiles, one offset per 64 tiles; decode then finds the lengths again by
walking the groups, a kernel). Sharded: a chunk is a band of
``chunk_size / width`` full rows, tiled and entropy-coded on its own
with one block size for all bands; where bs divides the band's sides the
band's tiles are reordered by a transpose, sized in both directions
(torch ops) and encoded by the RLE kernel in tile mode, any other
geometry (the shorter tail band) goes through the torch-op tile encode.
Decode cuts every tile's stream out as a row, decodes the rows (the MNP-5
decode kernel) and puts the tiles back.

FGK entropy (``entropy="fgk"``) replaces the canonical stage in every
layout: each chunk's symbols are coded with an adaptive Huffman tree of
its own (the FGK kernels, one thread a chunk's chain), and the container
keeps each chunk's stream byte-aligned with its bit count in the
manifest, no tables and no lanes. The global layout then has one
candidate, ``chunk_size`` chunks at the configured lane, still raced
against v1.

Every decision of the entropy mode is asked of its coder
(``models/entropy.py``), looked up once by ``CodecConfig.entropy`` or by
a container's entropy byte; this module holds no entropy branch.
"""

from __future__ import annotations

import functools
import struct
import zlib
from dataclasses import dataclass, fields

import numpy as np
import torch

from huffman_codec_tpu_torch.formats import (  # noqa: F401
    # ENTROPY_*: the JAX module's names (tests/test_torch_surface.py)
    ENTROPY_CANONICAL,
    ENTROPY_FGK,
    FLAG_ADAPT,
    FLAG_AGROUP,
    FLAG_DIFF,
    FLAG_SHARDED,
    GROUP_K,
    HUFF_HEADER_BYTES,
    V3_MAGIC,
    is_v2,
    parse_huff_header,
)
from huffman_codec_tpu_torch.models import entropy
from huffman_codec_tpu_torch.models.pipeline import (
    ALIGN,
    StepGraph,
    Transfers,
    aligned,
)
from huffman_codec_tpu_torch.native import runtime
from huffman_codec_tpu_torch.ops import kernels
from huffman_codec_tpu_torch.ops.adapt import (
    _gather_tiles,
    adapt_decode_bands,
    adapt_decode_tiled,
    adapt_encode_bands,
    adapt_encode_fixed,
    adapt_group_tile_lens,
    adapt_search_best_v3,
    grouped_manifest,
    tile_len_width,
)
from huffman_codec_tpu_torch.ops.diff import diff_apply, diff_revert
from huffman_codec_tpu_torch.ops.kernels import lane_words_cap
from huffman_codec_tpu_torch.ops.rle import (
    CLASSIFY_BLOCK,
    rle_decode,
    rle_encode,
    rle_encoded_size,
    rle_max_encoded_len,
)


@dataclass(frozen=True)
class CodecConfig:
    """Pipeline options; the same fields and defaults as the JAX
    package's ``CodecConfig`` so a config crosses between the packages
    as ``dataclasses.asdict`` (see ``config_from_fields``)."""

    use_diff: bool = False
    use_adapt: bool = False
    width: int = 512
    chunk_size: int = 1 << 16
    entropy: str = "canonical"  # "canonical" | "fgk"
    lane: int = 512  # canonical decode parallel granularity
    layout: str = "global"  # "global" | "sharded" (per-chunk transforms)
    whole_file: bool = True  # global layout only
    step_chunks: int | None = None  # chunks per device step; None = all

    def flags(self) -> int:
        return ((FLAG_DIFF if self.use_diff else 0)
                | (FLAG_ADAPT if self.use_adapt else 0)
                | (FLAG_SHARDED if self.layout == "sharded" else 0))


# the bulk streaming configuration: the sharded layout in stream mode
# with canonical entropy, 256 chunks of 64 KiB per step
MAIN_PATH = CodecConfig(layout="sharded", step_chunks=256)

# the whole-file candidate is tried up to this padded RLE size
_WHOLE_MAX_CAP = 3_500_000


def config_from_fields(d: dict) -> CodecConfig:
    """``dataclasses.asdict`` of a JAX-package CodecConfig -> the port's."""
    names = {f.name for f in fields(CodecConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown CodecConfig fields: {unknown}")
    return CodecConfig(**d)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _packk(vals: np.ndarray, width: int) -> bytes:
    """Flat int array -> MSB-first ``width``-bit packed bytes."""
    v = np.asarray(vals).reshape(-1).astype(np.int64)
    bits = (v[:, None] >> np.arange(width - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(-1).astype(np.uint8)).tobytes()


def _unpackk(raw, count: int, width: int, offset: int = 0) -> np.ndarray:
    """``count`` MSB-first ``width``-bit fields (1-32 bits) that start at
    byte ``offset`` of ``raw``, as int64. Reads the fields'
    ``(count * width + 7) // 8`` bytes where they lie and no other: eight
    fields fill ``width`` bytes, so the k-th field of every such group
    sits at the same bits of its group, read column by column."""
    nbytes = (count * width + 7) // 8
    b = np.frombuffer(raw, np.uint8, nbytes, offset)
    if width == 8:
        return b.astype(np.int64)
    full = count // 8
    out = np.empty((-(-count // 8), 8), np.int64)
    _unpack_groups(b[: full * width].reshape(full, width), width, out[:full])
    if full < out.shape[0]:
        # the last group's bytes, zero past the fields' own
        tail = np.zeros((1, width), np.uint8)
        tail[0, : nbytes - full * width] = b[full * width:]
        _unpack_groups(tail, width, out[full:])
    return out.reshape(-1)[:count]


def _unpack_groups(groups: np.ndarray, width: int, out: np.ndarray) -> None:
    """(G, width) uint8 rows, eight MSB-first ``width``-bit fields each,
    into the (G, 8) ``out``: field k spans the same one to five bytes of
    every row, joined big-endian and shifted down to its bits."""
    # a field and the bits before it in its first byte: width + 7 bits
    dt = np.uint32 if width <= 25 else np.uint64
    mask = (1 << width) - 1
    for k in range(8):
        first = k * width
        c0, c1 = first >> 3, (first + width - 1) >> 3
        win = groups[:, c0].astype(dt)
        for c in range(c0 + 1, c1 + 1):
            win = (win << 8) | groups[:, c]
        out[:, k] = (win >> (8 * (c1 + 1) - first - width)) & mask


def encode_step_chunks(n_chunks: int, step_chunks: int | None) -> int:
    """Chunks in each encode step of an input of ``n_chunks`` (>= 1)
    chunks: ``step_chunks`` for an input of a step or more (the last step
    zero-padded), and a shorter input's count rounded up to a power of two,
    at most ``step_chunks``; the chunks past the input are zero-padded and
    encode nothing, and the container is cut at ``n_chunks``. So a codec
    meets at most ``step_graph_bound(step_chunks)`` step geometries,
    whatever the sizes of its inputs. ``step_chunks`` None (or 0): one
    step of the input's own count."""
    if not step_chunks:
        return n_chunks
    return min(step_chunks, 1 << (n_chunks - 1).bit_length())


def step_graph_bound(step_chunks: int | None) -> int:
    """The most CUDA graphs a ``TorchCodec`` keeps: one per encode step
    geometry of ``encode_step_chunks``, the powers of two below
    ``step_chunks`` and ``step_chunks`` itself (9 at 256); 0 with
    ``step_chunks`` None, where every input is one step of its own count,
    run eagerly."""
    return (step_chunks - 1).bit_length() + 1 if step_chunks else 0


def encode_sharded_stage(data: torch.Tensor, length,
                         carry0: int | torch.Tensor, use_diff: bool,
                         chunk_size: int, n_chunks: int, lane: int,
                         ent=entropy.CANONICAL, n_words: int | None = None):
    """Per-chunk diff (with carry) -> per-chunk RLE -> entropy coding by
    ``ent`` (a coder of ``models/entropy.py``).

    ``data`` is (n_chunks * chunk_size,) uint8 on the device, of which the
    first ``length`` bytes (an int or a 0-d tensor; below 0 or past the
    data it clips) are input; ``carry0`` is the input byte before it (0
    at the stream start), an int or a (1,) uint8 tensor on the device,
    which is read without synchronising. ``n_words`` sizes FGK's word
    rows (``ent.encode``). Returns ``ent.encode``'s (a, meta, tables),
    then (rle_lens, carries), on the device."""
    dev = data.device
    chunks = data.view(n_chunks, chunk_size)
    starts = torch.arange(n_chunks, device=dev, dtype=torch.int64) * chunk_size
    in_lens = (length - starts).clamp(0, chunk_size).to(torch.int32)
    carry0 = torch.as_tensor(carry0, dtype=torch.uint8, device=dev).view(1)
    # interior chunks are full, so [:, -1] is the next chunk's carry; the
    # chunks after a partial tail have in_lens 0 and encode nothing
    carries = torch.cat([carry0, chunks[:-1, -1]])
    streams, rle_lens = kernels.rle_diff_encode(
        chunks, in_lens, carries, use_diff, ent.cap(chunk_size, lane))
    return (*ent.encode(streams, rle_lens, lane, n_words), rle_lens,
            carries)


def _step_views(base: torch.Tensor, S: int, chunk_size: int):
    """(data (S * chunk_size,) uint8, length (1,) int32, carry (1,) uint8)
    of an encode step's uploaded buffer (``TorchCodec._upload_step``)."""
    off = aligned(S * chunk_size)
    return (base[: S * chunk_size], base[off: off + 4].view(torch.int32),
            base[off + ALIGN: off + ALIGN + 1])


def _encode_step(base: torch.Tensor, S: int, chunk_size: int, lane: int,
                 use_diff: bool, ent):
    """One sharded encode step from its uploaded buffer: the stage, and
    what ``ent`` keeps of the payload (``ent.keep``). Returns (payload,
    meta, tables, rle_lens, carries) on the device."""
    data, length, carry = _step_views(base, S, chunk_size)
    a, meta, tables, rl, car = encode_sharded_stage(
        data, length, carry, use_diff, chunk_size, S, lane, ent)
    return ent.keep(a, meta), meta, tables, rl, car


def _chunkify(stream: torch.Tensor, total: torch.Tensor, chunk_size: int,
              max_chunks: int):
    """Flat stream of ``total`` valid bytes -> (max_chunks, chunk_size)
    rows and their valid lengths."""
    starts = torch.arange(max_chunks, device=stream.device) * chunk_size
    lens = (total.to(torch.int64) - starts).clamp(0, chunk_size)
    return stream.view(max_chunks, chunk_size), lens.to(torch.int32)


def _band_tiles(width: int, band_h: int, bs: int) -> int:
    """Tiles per band: the manifest's stride."""
    return _cdiv(width, bs) * _cdiv(band_h, bs)


def _band_winner_order(work: torch.Tensor, width: int, band_h: int, bs: int):
    """(nb, band_h * width) bands whose sides bs divides -> each band's
    tiles one after the other, every tile in the scan order that encodes
    shorter: the reorder is two transposes, the pick compares the tiles'
    closed-form encoded sizes. Returns (win (nb, band_h * width), dirs
    (nb, nt) bool, tile_lens (nb, nt) int32)."""
    nb = work.shape[0]
    T = bs * bs
    hor, ver, _ = _gather_tiles(work, width, band_h, bs)
    nt = hor.shape[1]
    full = torch.full((nb * nt,), T, dtype=torch.int32, device=work.device)
    h_sz = rle_encoded_size(hor.reshape(-1, T), full).view(nb, nt)
    v_sz = rle_encoded_size(ver.reshape(-1, T), full).view(nb, nt)
    dirs = h_sz <= v_sz  # horizontal wins ties
    win = torch.where(dirs[:, :, None], hor, ver).reshape(nb, -1)
    return win, dirs, torch.minimum(h_sz, v_sz).to(torch.int32)


def encode_sharded_adapt_stage(bands: torch.Tensor, carries: torch.Tensor,
                               use_diff: bool, width: int, band_h: int,
                               bs: int, cap: int, lane: int,
                               ent=entropy.CANONICAL):
    """Sharded-adaptive encode of (nb, band_h * width) uint8 bands of one
    height: per-band diff seeded by ``carries``, adaptive block RLE of
    each band on its own at block size ``bs`` (tiles clamped at the
    band's borders), entropy coding per band by ``ent``. Returns
    ``ent.encode``'s (a, meta, tables), then (stream_lens (nb,), dirs
    (nb, nt), tile_lens (nb, nt)), on the device."""
    work = diff_apply(bands, carries) if use_diff else bands
    nb, cs = work.shape
    if width % bs == 0 and band_h % bs == 0 and cs % 16 == 0:
        # tiles whole: one pass of the RLE kernel in tile mode over the
        # winning order; its row-wide offsets concatenate the tile streams
        win, dirs, tile_lens = _band_winner_order(work, width, band_h, bs)
        streams, totals = kernels.rle_diff_encode(
            win, torch.full((nb,), cs, dtype=torch.int32, device=work.device),
            torch.zeros(nb, dtype=torch.uint8, device=work.device), False,
            cap, tile=bs * bs)
    else:
        streams, totals, dirs, tile_lens = adapt_encode_bands(
            work, width, band_h, bs, cap)
    return (*ent.encode(streams, totals, lane), totals, dirs, tile_lens)


def decode_sharded_adapt_tail(streams, tile_lens, dirs, carries, width: int,
                              band_h: int, bs: int, use_diff: bool):
    """Inverse of the band stage: per-band tile decode from the manifest,
    then the per-band diff revert seeded by the stored carries."""
    out = adapt_decode_bands(streams, tile_lens, dirs, width, band_h, bs)
    return (diff_revert(out, carries) if use_diff else out).reshape(-1)


def _decode_adapt_tail(stream, tile_lens, dirs, width: int, height: int,
                       bs: int, use_diff: bool):
    flat = adapt_decode_tiled(stream, tile_lens, dirs, width, height, bs)
    return diff_revert(flat) if use_diff else flat


def _global_geometry(cfg: CodecConfig, n: int, whole: bool, ent):
    """(chunk_size, lane, max_chunks) of one global-layout candidate for
    ``n`` input bytes. ``whole``: one chunk of fat lanes, the smallest
    power-of-two lane >= an eighth of the padded RLE size, at most 32768,
    and the chunk rounded up to 8 lanes; else ``chunk_size`` chunks at
    lane 2048 beside a whole-file candidate (``ent.whole_file``) where it
    divides the chunk, the configured lane otherwise."""
    cap = rle_max_encoded_len(n) + 64
    if whole:
        lane = min(1 << 15, max(64, 1 << ((cap + 7) // 8 - 1).bit_length()))
        cs = _cdiv(cap, 8 * lane) * (8 * lane)
        return cs, lane, 1
    lane = (2048 if cfg.whole_file and ent.whole_file
            and cfg.chunk_size % 2048 == 0 else cfg.lane)
    return cfg.chunk_size, lane, _cdiv(cap, cfg.chunk_size)


def _decode_stream_tail(stream: torch.Tensor, total: int, out_len: int,
                        use_diff: bool):
    """Whole-stream RLE decode and diff revert of a flat (N,) stream."""
    n = torch.tensor([total], dtype=torch.int32, device=stream.device)
    out, m = rle_decode(stream[None, :], n, out_len, block=CLASSIFY_BLOCK)
    return (diff_revert(out[0]) if use_diff else out[0]), m[0]


class TorchCodec:
    """Chunk-parallel lossless codec whose encode and decode run on a CUDA
    device through the kernels of ``ops/kernels.py``.

    ``config=None`` means ``CodecConfig()``, the global layout.
    ``device=None`` means ``"cuda"``, and raises when no GPU is present;
    ``device="cpu"`` runs every kernel's plain PyTorch version instead.

    On the card, each canonical encode step of the sharded stream path is
    a CUDA graph replay: one graph per step geometry, captured the first
    time the geometry is met and kept in ``_graphs`` for the codec's life
    with its memory pool. Step geometries come from ``encode_step_chunks``,
    so a codec keeps at most ``step_graph_bound(config.step_chunks)``
    graphs (9 at ``step_chunks`` 256, none with ``step_chunks`` None)
    whatever sizes and data it sees. Everything else runs launch by
    launch: the decode steps, FGK entropy, the other layouts and
    adaptive mode. ``entropy`` is the codec's coder (``models/entropy.py``):
    FGK's sharded steps of a request run side by side on side streams."""

    # the v1 race runs only on small inputs (the v1 FGK chain is serial
    # per symbol) whose v3 container is small enough for its fixed costs
    # to decide the winner
    _V1_RACE_MAX_IN = 1 << 20
    _V1_RACE_MAX_OUT = 1 << 16

    def __init__(self, config: CodecConfig | None = None, device=None):
        self.config = cfg = config or CodecConfig()
        # the JAX package's order of checks, so that a config breaking
        # two rules gets the same message
        self.entropy = entropy.lookup(cfg.entropy)
        self.entropy.check(cfg.chunk_size, cfg.lane)
        if cfg.layout not in ("global", "sharded"):
            raise ValueError(f"unknown layout {cfg.layout}")
        if cfg.layout == "sharded" and cfg.use_adapt:
            # adaptive chunks are bands of full matrix rows
            if cfg.chunk_size % cfg.width:
                raise ValueError("sharded adaptive needs chunk_size "
                                 "divisible by the matrix width")
            if cfg.chunk_size // cfg.width < 8:
                raise ValueError("sharded adaptive needs bands of >= 8 "
                                 "rows (chunk_size / width)")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run "
                               "the plain PyTorch versions")
        self._xfer = Transfers(self.device)
        # encode step count -> its CUDA graph, as jax.jit keeps one program
        # per shape; at most step_graph_bound(step_chunks) of them
        self._graphs: dict[int, StepGraph] = {}

    @property
    def timer(self):
        """A ``utils.profiling.StageTimer`` that receives the codec's spans
        and counters, or None (the default: nothing is timed or counted).
        Host spans do not nest, so each one's total is a self time:
        - the sharded stream path: ``host staging``, ``payload``,
          ``crc32``, ``container`` (encode); ``parse``, ``host staging``,
          ``bytes``, ``crc32`` (decode);
        - ``decode_range``: ``parse``, ``host staging``, ``dispatch``
          (the step's launches), ``wait``, ``bytes``;
        - the global layout: ``upload``, ``dispatch`` (the candidates'
          launches and their fetches), ``wait``, ``crc32``,
          ``container``, ``v1 race`` (encode); ``parse``, ``upload``,
          ``dispatch``, ``wait``, ``bytes``, ``crc32``, or ``v1 decode``
          for a v1 blob (decode).
        - FGK entropy adds ``fgk strip`` (the encode's strip of its word
          rows in the fetch, ``chunk_bytes`` with its synchronisations).
        The adaptive block-size search and the sharded-adaptive stages lie
        in no span but FGK's strip. Device spans, between CUDA events,
        added by the timer's ``resolve`` once the work has run:
        ``device``, the sharded steps' time (canonical: a span a step;
        FGK: one span a request, from the fork of its side-by-side steps
        to their join); ``fgk rows``, an FGK decode's cut of its payload
        into word rows as it is staged.
        Counters: ``v1 races`` and ``v1 wins`` (``_race_v1``), ``parse
        copied bytes`` (the container's bytes ``_parse`` copies), ``fgk
        steps`` (the FGK sharded steps run) and ``fgk steps side by
        side`` (those queued on a side stream that held no earlier step
        of the request; on the card only)."""
        return self._xfer.timer

    @timer.setter
    def timer(self, timer) -> None:
        self._xfer.timer = timer

    # -- encode -------------------------------------------------------------

    def encode_chunk_range(self, data: np.ndarray | bytes, c0: int, c1: int):
        """Encode chunks [c0, c1) of the input (sharded layout only) as
        one fixed step; chunks past the input are zero-padded and encode
        nothing. The step is restartable through its carry byte, so a
        range re-encoded alone splices in byte-equal. Returns the coder's
        (a, meta, tables) (``entropy.encode``), then (rle_lens, carries),
        on the device, without synchronising."""
        cfg = self.config
        if cfg.layout != "sharded":
            raise ValueError("encode_chunk_range requires the sharded layout")
        arr = (np.frombuffer(data, np.uint8)
               if isinstance(data, (bytes, bytearray)) else data)
        base = self._upload_step(arr, c0, c1)
        x, length, carry = _step_views(base, c1 - c0, cfg.chunk_size)
        return encode_sharded_stage(x, length, carry, cfg.use_diff,
                                    cfg.chunk_size, c1 - c0, cfg.lane,
                                    self.entropy)

    def _upload_step(self, arr: np.ndarray, c0: int, c1: int) -> torch.Tensor:
        """Chunks [c0, c1) of the input as one fixed step, in one buffer on
        the device (``_step_views``): the bytes, zero past the input, the
        valid length and the carry byte (the input byte before the step,
        0 at the start). Staged in pinned memory and copied on the copy
        stream; the current stream waits for the copy, the host does
        not."""
        base, ready = self._stage_upload(arr, c0, c1)
        self._xfer.wait(ready)
        return base

    def _stage_upload(self, arr: np.ndarray, c0: int, c1: int):
        """``_upload_step`` without the wait: (the buffer, the event that
        marks its copy, None on the CPU)."""
        cs = self.config.chunk_size
        n = len(arr)
        lo, hi = c0 * cs, min(n, c1 * cs)
        carry0 = arr[lo - 1] if 0 < lo <= n else 0
        base, _, ready = self._xfer.upload([
            (arr[lo:hi], (c1 - c0) * cs, torch.uint8),
            (np.array([max(0, hi - lo)], np.int32), 1, torch.int32),
            (np.array([carry0], np.uint8), 1, torch.uint8)])
        return base, ready

    def _run_encode_step(self, base: torch.Tensor, S: int):
        """``_encode_step`` of an uploaded step of S chunks: on CUDA with
        ``step_chunks`` set, unless the coder is chain-bound (FGK: one
        kernel of tens of ms a replay would not shorten), the CUDA graph
        of step count S (``StepGraph``: the first step of a count runs
        eagerly and captures it, synchronising once), its outputs cloned,
        since every step is dispatched before any is fetched; at most
        ``step_graph_bound(step_chunks)`` graphs. Else eagerly."""
        cfg = self.config
        step = functools.partial(
            _encode_step, S=S, chunk_size=cfg.chunk_size, lane=cfg.lane,
            use_diff=cfg.use_diff, ent=self.entropy)
        if (self.entropy.chain_bound or not cfg.step_chunks
                or not self._xfer.cuda):
            return step(base)
        graph = self._graphs.get(S)
        if graph is None:
            graph = self._graphs[S] = StepGraph(step,
                                                [torch.empty_like(base)])
        return tuple(o.clone() for o in graph(base))

    def dispatch_sharded(self, data: bytes) -> list:
        """The dispatch half of the sharded stream encode: every step of
        ``encode_step_chunks`` chunks staged, uploaded and run
        (``_run_encode_step``) before any is fetched, in the coder's
        schedule (FGK's side by side: a request takes about its longest
        chain). Nothing here waits for the device once the steps' graphs
        exist. Returns each step's outputs on the device."""
        cfg = self.config
        arr = np.frombuffer(data, np.uint8)
        n_chunks = _cdiv(len(arr), cfg.chunk_size)
        S = encode_step_chunks(n_chunks, cfg.step_chunks)
        n_steps = _cdiv(n_chunks, S)
        run = self.entropy.schedule(self._xfer, n_steps, S)
        outs = []
        for k in range(n_steps):
            base, ready = self._stage_upload(arr, k * S, (k + 1) * S)
            with run.step(k, ready, (base,)):
                out = self._run_encode_step(base, S)
            outs.append(run.hand_back(out))
        run.join()
        return outs

    def fetch_sharded(self, data: bytes, outs: list) -> bytes:
        """The fetch half: wave 1 copies every step's manifests (lane words
        or FGK bits, tables, rle_lens, carries) to pinned memory and waits
        once; wave 2 is the coder's payload wave (``entropy.payloads``);
        then the container."""
        ent = self.entropy
        n = len(data)
        n_chunks = _cdiv(n, self.config.chunk_size)
        xf = self._xfer
        man = [xf.fetch([t for t in o[1:] if t is not None]) for o in outs]
        xf.fence()
        pays, landed = ent.payloads(xf, [o[0] for o in outs],
                                    [o[1] for o in outs], [m[0] for m in man])
        xf.wait_host(landed)
        *cols, rl, car = (
            np.concatenate([m[i].numpy() for m in man])[:n_chunks]
            for i in range(len(man[0])))
        with xf.host_stage("payload"):
            payload = b"".join(ent.wire(p) for p in pays)
        with xf.host_stage("crc32"):
            crc = zlib.crc32(data)
        with xf.host_stage("container"):
            return self._container(payload, n, int(rl.sum()),
                                   *ent.manifest(*cols), (rl, car), crc)

    def encode(self, data: bytes) -> bytes:
        cfg = self.config
        n = len(data)
        if cfg.use_adapt:
            if cfg.width <= 0:
                raise ValueError("invalid matrix width")
            if n % cfg.width:
                raise ValueError("invalid size of input 2D data")
        if n == 0:
            return self._container(b"", 0, 0, [], None, None, None,
                                   zlib.crc32(b""))
        if cfg.layout == "sharded" and cfg.use_adapt:
            return self._encode_sharded_adapt(data)
        if cfg.layout != "sharded":
            bs = None
            if cfg.use_adapt:
                # the search sees the matrix after the diff, as the
                # reference applies the diff model before its search
                x = torch.from_numpy(
                    np.frombuffer(data, np.uint8).copy()).to(self.device)
                bs = adapt_search_best_v3(
                    diff_apply(x) if cfg.use_diff else x, cfg.width,
                    n // cfg.width)
            # best of two shapes of the same wire: the whole-file candidate
            # wins when the per-chunk manifest dominates, the chunked one
            # when the statistics drift and a table per chunk pays; it is
            # first, so it also wins a tie
            sts = [self._dispatch_global(data, bs, w)
                   for w in self.global_candidates(n)]
            # both candidates' manifests are fetched before either is
            # read, then both payload prefixes (the JAX package's waves)
            for st in sts:
                self._start_fetch(st)
            for st in sts:
                self._presplice_payload(st)
            return self._race_v1(data, min(
                (self._assemble_global(data, st) for st in sts), key=len))
        return self.fetch_sharded(data, self.dispatch_sharded(data))

    def run_sharded_adapt_stage(self, x: torch.Tensor, bs: int) -> list:
        """The sharded-adaptive device stage on resident input ((n,) uint8
        on the device, whole rows) at block size ``bs``, without
        synchronising: the full bands in one call, then a shorter tail
        band in a call of its own at its clamped geometry.
        Returns per call (payload, meta, tables, stream_lens, dirs,
        tile_lens), the payload as the coder keeps it (``entropy.keep``)."""
        cfg = self.config
        ent = self.entropy
        w, cs = cfg.width, cfg.chunk_size
        band_h = cs // w
        nb_full, h_tail = divmod(x.shape[0] // w, band_h)
        # band k's diff carry is the input byte before it
        car = torch.cat([x.new_zeros(1), x[cs - 1:: cs]])
        cap = ent.cap(cs, cfg.lane)
        calls = [(0, nb_full, band_h)] if nb_full else []
        if h_tail:
            calls.append((nb_full, nb_full + 1, h_tail))
        outs = []
        for b0, b1, bh in calls:
            bands = x[b0 * cs: b0 * cs + (b1 - b0) * bh * w].view(b1 - b0, -1)
            a, meta, *rest = encode_sharded_adapt_stage(
                bands, car[b0:b1], cfg.use_diff, w, bh, bs, cap, cfg.lane,
                ent)
            outs.append((ent.keep(a, meta), meta, *rest))
        return outs

    def _encode_sharded_adapt(self, data: bytes) -> bytes:
        """The input matrix is cut into bands of ``chunk_size / width``
        full rows; each band is adaptively block-RLE'd on its own, with
        one block size searched for all of them, and entropy-coded as a
        chunk of its own. Bands restart the RLE and carry one diff byte,
        so the container streams, splices and random-accesses like the
        stream-mode sharded layout."""
        cfg = self.config
        n, w, cs = len(data), cfg.width, cfg.chunk_size
        n_rows, band_h = n // w, cs // w
        if min(w, band_h, n_rows) < 8:
            raise ValueError("too small 2D data dimensions")
        arr = np.frombuffer(data, np.uint8)
        x = torch.from_numpy(arr.copy()).to(self.device)
        # candidates must fit a band; scored on the whole matrix
        bs = adapt_search_best_v3(diff_apply(x) if cfg.use_diff else x, w,
                                  n_rows, max_height=band_h)
        outs = self.run_sharded_adapt_stage(x, bs)
        ent = self.entropy
        xf = self._xfer
        # the coder's manifest columns: meta, and the tables it has
        man = [[t.cpu() for t in o[1:3] if t is not None] for o in outs]
        pays, landed = ent.payloads(xf, [o[0] for o in outs],
                                    [o[1] for o in outs], [m[0] for m in man])
        xf.wait_host(landed)
        payload = b"".join(ent.wire(p) for p in pays)
        cols = [np.concatenate([m[i].numpy() for m in man])
                for i in range(len(man[0]))]
        rl, dirs, tile_lens = (
            np.concatenate([o[i].cpu().numpy().reshape(-1) for o in outs])
            for i in (3, 4, 5))
        car = np.zeros(len(rl), np.uint8)
        car[1:] = arr[cs - 1:: cs][: len(rl) - 1]
        return self._container(
            payload, n, int(rl.sum()), *ent.manifest(*cols), (rl, car),
            zlib.crc32(data),
            adapt_meta=(w, n_rows, bs, dirs, tile_lens, False))

    def global_candidates(self, n: int) -> list[bool]:
        """The candidates ``encode`` tries for ``n`` input bytes, as
        ``whole`` flags in the order that decides a tie; a coder without
        the whole-file candidate (FGK) has only the chunked one."""
        if (self.config.whole_file and self.entropy.whole_file
                and rle_max_encoded_len(n) + 64 <= _WHOLE_MAX_CAP):
            return [True, False]
        return [False]

    def run_global_stage(self, x: torch.Tensor, whole: bool,
                         bs: int | None = None) -> dict:
        """One global-layout candidate's device stage on resident input
        ((n,) uint8), without synchronising: the whole-input diff and RLE
        (the adaptive block RLE at block size ``bs``, None in stream mode),
        the stream cut into chunks and coded. Returns the payload as the
        coder keeps it (``entropy.keep``), meta, tables, the stream length
        and in adaptive mode the tiles' directions and lengths."""
        cfg = self.config
        ent = self.entropy
        n = x.shape[0]
        cs, lane, max_chunks = _global_geometry(cfg, n, whole, ent)
        st = dict(cs=cs, lane=lane, n=n, bs=bs)
        x = diff_apply(x) if cfg.use_diff else x
        if bs is None:
            stream, total = rle_encode(
                x[None, :], torch.tensor([n], dtype=torch.int32,
                                         device=x.device), max_chunks * cs)
            stream, total = stream[0], total[0]
        else:
            st["wh"] = w, h = cfg.width, n // cfg.width
            stream, total, st["dirs"], st["tile_lens"] = adapt_encode_fixed(
                x, w, h, bs, out_len=max_chunks * cs, with_header=False)
        a, meta, tables = ent.encode(
            *_chunkify(stream, total, cs, max_chunks), lane)
        st.update(payload=ent.keep(a, meta), meta=meta, tables=tables,
                  total=total)
        return st

    def _dispatch_global(self, data: bytes, bs, whole: bool) -> dict:
        """Upload the input and start one candidate's device stage.
        ``bs`` is the adaptive block size, None in stream mode."""
        xf = self._xfer
        with xf.host_stage("upload"):
            # a copy: the bytes object's buffer is read-only
            x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(
                self.device)
        with xf.host_stage("dispatch"):
            return self.run_global_stage(x, whole, bs)

    def _start_fetch(self, st: dict) -> None:
        """Start the device -> host copies of a dispatched candidate's
        manifest arrays into pinned memory (``st["host"]``): all but the
        payload, which the coder's payload wave takes
        (``_presplice_payload``)."""
        keys = [k for k, v in st.items() if isinstance(v, torch.Tensor)
                and k != "payload"]
        with self._xfer.host_stage("dispatch"):
            st["host"] = dict(zip(keys,
                                  self._xfer.fetch([st[k] for k in keys])))
            st["fetched"] = self._xfer.record()

    def _presplice_payload(self, st: dict) -> None:
        """Second wave: once the candidate's manifest has landed, the
        coder's payload wave (``entropy.payloads``; canonical's copy counts
        under ``dispatch``)."""
        xf = self._xfer
        h = st["host"]
        with xf.host_stage("wait"):
            xf.wait_host(st["fetched"])
        (h["payload"],), st["fetched"] = self.entropy.payloads(
            xf, [st["payload"]], [st["meta"]], [h["meta"]], "dispatch")

    def _assemble_global(self, data: bytes, st: dict) -> bytes:
        """The container of a candidate whose fetches were started; the
        chunks past the stream's end hold no lane words and drop out."""
        xf = self._xfer
        with xf.host_stage("wait"):
            xf.wait_host(st["fetched"])
        with xf.host_stage("crc32"):
            crc = zlib.crc32(data)
        with xf.host_stage("container"):
            h = st["host"]
            cs = st["cs"]
            total = int(h["total"])
            n_chunks = _cdiv(total, cs)
            chunk_bits, tables, lane_words = self.entropy.manifest(
                *(h[k].numpy()[:n_chunks] for k in ("meta", "tables")
                  if k in h))
            adapt_meta = None
            if st["bs"] is not None:
                tile_lens = h["tile_lens"].numpy()
                # the payload estimate in bytes
                est = sum(chunk_bits) // 8
                grouped = grouped_manifest(len(tile_lens), st["bs"], est)
                adapt_meta = (*st["wh"], st["bs"], h["dirs"].numpy(),
                              tile_lens, grouped)
            return self._container(
                self.entropy.wire(h["payload"]), st["n"], total, chunk_bits,
                tables, lane_words, None, crc, chunk_size=cs,
                lane=st["lane"], adapt_meta=adapt_meta)

    def _encode_global(self, data: bytes, bs, whole: bool) -> bytes:
        st = self._dispatch_global(data, bs, whole)
        self._start_fetch(st)
        self._presplice_payload(st)
        return self._assemble_global(data, st)

    def _race_v1(self, data: bytes, blob: bytes) -> bytes:
        """Keep the reference's v1 format when it is strictly smaller:
        the v3 container's fixed costs (a 43-byte header, a packed table)
        and its static tables can lose to v1's 9-byte header and
        per-symbol adaptation on small payloads. ``decode`` tells the two
        apart by the magic. The v1 encoder is the host C++ runtime; a
        build or load failure raises, so a different container is never
        returned quietly."""
        if (len(data) > self._V1_RACE_MAX_IN
                or len(blob) > self._V1_RACE_MAX_OUT):
            return blob
        cfg = self.config
        xf = self._xfer
        with xf.host_stage("v1 race"):
            v1 = runtime.v1_compress(data, cfg.use_diff, cfg.use_adapt,
                                     cfg.width)
        won = len(v1) < len(blob)
        if xf.timer is not None:
            xf.timer.count("v1 races")
            xf.timer.count("v1 wins", int(won))
        return v1 if won else blob

    def _container(self, payload, orig, total, chunk_bits, tables,
                   lane_words, sharded_meta, crc=0, chunk_size=None,
                   lane=None, adapt_meta=None) -> bytes:
        """``chunk_bits``, ``tables`` and ``lane_words`` as
        ``entropy.manifest`` gives them (no tables: FGK). ``adapt_meta``:
        (W, H, bs, dirs, tile_lens, grouped) of an adaptive container,
        else None."""
        cfg = self.config
        chunk_size = cfg.chunk_size if chunk_size is None else chunk_size
        lane = cfg.lane if lane is None else lane
        out = bytearray()
        out += V3_MAGIC
        out.append(3)  # container version
        grouped = adapt_meta is not None and adapt_meta[5]
        out.append(cfg.flags() | (FLAG_AGROUP if grouped else 0))
        out.append(self.entropy.code)
        # code-length table bit width, then the lane-words bit width: the
        # maximum of THIS container
        tw = kw = 0
        if tables is not None and len(chunk_bits):
            tw = 4 if int(np.max(tables)) <= 15 else 5
            kw = max(1, int(np.asarray(lane_words).max()).bit_length())
        out.append(tw)
        out.append(kw)
        out += struct.pack("<QQIIII", orig, total, chunk_size,
                           len(chunk_bits), lane, crc)
        if adapt_meta is not None:
            w, h, bs, dirs, tile_lens, _ = adapt_meta
            nt = len(tile_lens)
            out += struct.pack("<QQQI", w, h, bs, nt)
            out += np.packbits(np.asarray(dirs, np.uint8)).tobytes()
            if grouped:
                # one byte offset per GROUP_K tiles; decode finds the
                # tile lengths again (ops/adapt.adapt_group_tile_lens)
                offs = np.concatenate(
                    [[0], np.cumsum(tile_lens.astype(np.int64))])
                out += offs[:nt:GROUP_K].astype("<u4").tobytes()
            else:
                out += np.asarray(tile_lens,
                                  f"<u{tile_len_width(bs)}").tobytes()
        if tables is None:
            out += np.asarray(chunk_bits, "<u4").tobytes()
        if sharded_meta is not None:
            rle_lens, carries = sharded_meta
            out += np.asarray(rle_lens, "<u4").tobytes()
            out += np.asarray(carries, np.uint8).tobytes()
        if tables is not None and len(chunk_bits):
            # tables at tw bits per length; lane_words of the used lanes
            # only (the used count per chunk follows from its rle_len);
            # chunk_bits is implied: 32 * sum(lane_words)
            out += _packk(np.asarray(tables), tw)
            lw = np.asarray(lane_words)
            counts = self._chunk_counts(sharded_meta, total, chunk_size,
                                        len(chunk_bits))
            used = -(-counts // lane)
            mask = np.arange(lw.shape[1])[None, :] < used[:, None]
            if (lw[~mask] != 0).any():
                raise ValueError("lane_words nonzero outside the used lanes")
            out += _packk(lw[mask], kw)
        out += payload
        return bytes(out)

    @staticmethod
    def _chunk_counts(sharded_meta, total, chunk_size, n_chunks):
        """Per-chunk symbol counts, derived the same way by the writer and
        the parser."""
        if sharded_meta is not None:
            return np.asarray(sharded_meta[0], np.int64)
        return np.clip(
            int(total) - np.arange(n_chunks, dtype=np.int64) * chunk_size,
            0, chunk_size)

    # -- decode -------------------------------------------------------------

    @staticmethod
    def _check_supported(hdr: dict):
        """The coder of a parsed container (``entropy.by_code``); an unknown
        entropy mode raises."""
        return entropy.by_code(hdr["entropy"])

    def _stage_step(self, blob: bytes, hdr: dict, c0: int, c1: int, S: int):
        """Host -> device transfer of one decode step, without compute: the
        manifest rows zero-padded to S chunks and what the coder stages
        (``entropy.stage_step``); ``ready`` marks the copy (the compute
        waits on it, the host does not)."""
        (rl, car), ready, rows = self._check_supported(hdr).stage_step(
            self._xfer, blob, hdr, c0, c1, S,
            [(hdr["rle_lens"][c0:c1], S, torch.int32),
             (hdr["carries"][c0:c1], S, torch.uint8)])
        return {"c0": c0, "c1": c1, "rl": rl, "car": car, "ready": ready,
                **rows}

    def stage_decode_steps(self, blob: bytes, hdr: dict | None = None):
        """Parse, then start the host -> device transfer of every decode
        step without running any of its compute. Returns (hdr, staged)."""
        hdr = self._parse(blob) if hdr is None else hdr
        self._check_supported(hdr)
        if not hdr["flags"] & FLAG_SHARDED:
            raise ValueError("decode_steps requires the sharded layout")
        if hdr["flags"] & FLAG_ADAPT:
            raise ValueError("decode_steps requires stream mode")
        n_chunks = hdr["n_chunks"]
        S = min(self.config.step_chunks or n_chunks, n_chunks)
        staged = [self._stage_step(blob, hdr, k * S,
                                   min(n_chunks, (k + 1) * S), S)
                  for k in range(_cdiv(n_chunks, S))] if n_chunks else []
        return hdr, staged

    def _decode_step(self, hdr: dict, st: dict,
                     out: torch.Tensor | None = None) -> torch.Tensor:
        """A staged step's decode, launch by launch and without
        synchronising: the coder's decode (``entropy.decode``), then
        ``rle_expand``, which writes its (S, chunk_size) rows into ``out``
        when given. Returns the (S * chunk_size,) uint8 bytes on the
        device."""
        ent = self._check_supported(hdr)
        self._xfer.wait(st["ready"])
        cs = hdr["chunk_size"]
        chunks_rle = ent.decode(hdr, st, st["rl"], ent.cap(cs, hdr["lane"]))
        return kernels.rle_expand(chunks_rle, st["rl"], st["car"], cs,
                                  bool(hdr["flags"] & FLAG_DIFF),
                                  out=out).view(-1)

    def _run_decode(self, hdr: dict, staged: list) -> torch.Tensor:
        """Every staged step decoded into one (steps * S * chunk_size,)
        uint8 device tensor, without synchronising, in the coder's schedule
        (FGK's fork follows every step's row cut). Each step runs launch by
        launch (``_decode_step``; no CUDA graph, whose key would follow the
        container's lane stride and code-length bucket) and writes its
        rows straight into its slice of the result."""
        S = staged[0]["rl"].shape[0] if staged else 0
        cs = hdr["chunk_size"]
        out = torch.empty((len(staged) * S, cs), dtype=torch.uint8,
                          device=self.device)
        run = self._check_supported(hdr).schedule(self._xfer, len(staged), S)
        for k, st in enumerate(staged):
            held = [out, *(t for t in st.values()
                           if isinstance(t, torch.Tensor))]
            with run.step(k, held=held):
                self._decode_step(hdr, st, out[k * S:(k + 1) * S])
        run.join()
        return out.view(-1)

    def run_decode_steps(self, hdr: dict, staged: list):
        """Run the decode compute of staged steps; returns each step's
        (S * chunk_size,) uint8 device tensor without synchronising."""
        if not staged:
            return []
        out = self._run_decode(hdr, staged)
        return list(out.split(out.shape[0] // len(staged)))

    def decode_steps(self, blob: bytes, hdr: dict | None = None):
        """The sharded-layout decode as per-step device tensors, not yet
        copied back to the host: every step staged before any runs, and
        no step waits for the device."""
        hdr, staged = self.stage_decode_steps(blob, hdr)
        return self.run_decode_steps(hdr, staged)

    def stage_adapt_bands(self, blob: bytes, hdr: dict, c0: int, c1: int):
        """Host -> device transfer of bands [c0, c1) of a sharded-adaptive
        container without any compute: per group of one geometry (the
        full bands, then the shorter tail band) the payload words and the manifest rows, the tiles'
        lengths and directions among them."""
        cs, w, bs = hdr["chunk_size"], hdr["w"], hdr["bs"]
        band_h = cs // w
        nb_full, h_tail = divmod(hdr["h"], band_h)
        dirs, tl = hdr["dirs"], hdr["tile_lens"].astype(np.int32)
        staged = []
        for b0, b1, bh, nt, toff in self._band_groups(
                c0, c1, nb_full, h_tail, _band_tiles(w, band_h, bs), w, bs,
                band_h):
            st = self._stage_step(blob, hdr, b0, b1, b1 - b0)
            rows = slice(toff, toff + (b1 - b0) * nt)
            st.update(
                band_h=bh,
                tile_lens=torch.from_numpy(
                    tl[rows].reshape(b1 - b0, nt)).to(self.device),
                dirs=torch.from_numpy(
                    dirs[rows].reshape(b1 - b0, nt)).to(self.device))
            staged.append(st)
        return staged

    def run_adapt_bands(self, hdr: dict, staged: list) -> torch.Tensor:
        """The decode compute of staged sharded-adaptive bands as one flat
        device tensor, without synchronising: entropy decode of each
        band's chunk, tile decode from the manifest, per-band diff
        revert."""
        ent = self._check_supported(hdr)
        cap = ent.cap(hdr["chunk_size"], hdr["lane"])
        parts = []
        for st in staged:
            self._xfer.wait(st["ready"])
            streams = ent.decode(hdr, st, st["rl"], cap)
            parts.append(decode_sharded_adapt_tail(
                streams, st["tile_lens"], st["dirs"], st["car"], hdr["w"],
                st["band_h"], hdr["bs"], bool(hdr["flags"] & FLAG_DIFF)))
        return torch.cat(parts)

    @staticmethod
    def _band_groups(c0, c1, nb_full, h_tail, nt_full, w, bs, band_h):
        """Split a band range into (start, end, band rows, tiles a band,
        flat tile offset) groups of one geometry: the full bands, then
        the shorter tail band."""
        f1 = min(c1, nb_full)
        groups = [(c0, f1, band_h, nt_full, c0 * nt_full)] if c0 < f1 else []
        if h_tail and c1 > nb_full:
            groups.append((nb_full, nb_full + 1, h_tail,
                           _band_tiles(w, h_tail, bs), nb_full * nt_full))
        return groups

    def decode_range(self, blob: bytes, start: int, length: int) -> bytes:
        """Random-access decode of ``[start, start + length)`` (sharded
        layout only): only the covering chunks are decoded, each from its
        manifest row and its stored diff carry."""
        xf = self._xfer
        with xf.host_stage("parse"):
            hdr = self._parse(blob, xf.timer)
        self._check_supported(hdr)
        if not hdr["flags"] & FLAG_SHARDED:
            raise ValueError("decode_range requires the sharded layout")
        if start < 0 or length < 0 or start + length > hdr["orig"]:
            raise ValueError("range out of bounds")
        if length == 0:
            return b""
        cs = hdr["chunk_size"]
        c0, c1 = start // cs, (start + length - 1) // cs + 1
        if hdr["flags"] & FLAG_ADAPT:
            staged = self.stage_adapt_bands(blob, hdr, c0, c1)
            with xf.host_stage("dispatch"):
                out = self.run_adapt_bands(hdr, staged)
        else:
            step = self._stage_step(blob, hdr, c0, c1, c1 - c0)
            with xf.host_stage("dispatch"):
                out = self._decode_step(hdr, step)
        with xf.host_stage("wait"):
            flat = out.cpu().numpy()
        lo = start - c0 * cs
        with xf.host_stage("bytes"):
            return flat[lo: lo + length].tobytes()

    def stage_global(self, blob: bytes, hdr: dict) -> dict:
        """Host -> device transfer of a global-layout container: every
        chunk's payload and the manifest as the coder stages them
        (``entropy.stage_global``), without any compute."""
        if hdr["flags"] & FLAG_SHARDED:
            raise ValueError("stage_global requires the global layout")
        dev = self.device
        xf = self._xfer
        st = self._check_supported(hdr).stage_global(xf, blob, hdr, dev)
        if hdr["flags"] & FLAG_ADAPT:
            with xf.host_stage("upload"):
                st["dirs"] = torch.from_numpy(hdr["dirs"]).to(dev)
                key = ("group_offs" if hdr["flags"] & FLAG_AGROUP
                       else "tile_lens")
                st[key] = torch.from_numpy(hdr[key].astype(np.int32)).to(dev)
        return st

    def run_global_decode(self, hdr: dict, st: dict):
        """The decode compute of a staged global-layout container: (at
        least ``orig`` bytes uint8, the decoded length) on the device,
        without synchronising."""
        # repad is per lane, so the pseudo-chunk rows re-pad as they are
        stream = self._check_supported(hdr).decode(
            hdr, st, st["counts"], st["rcs"]).reshape(-1)
        use_diff = bool(hdr["flags"] & FLAG_DIFF)
        if not hdr["flags"] & FLAG_ADAPT:
            return _decode_stream_tail(stream, hdr["total"], hdr["orig"] + 8,
                                       use_diff)
        w, h, bs = hdr["w"], hdr["h"], hdr["bs"]
        if hdr["flags"] & FLAG_AGROUP:
            tl = adapt_group_tile_lens(
                stream, st["group_offs"], hdr["total"], w, h, bs,
                GROUP_K * rle_max_encoded_len(bs * bs))[: len(hdr["dirs"])]
        else:
            tl = st["tile_lens"]
        return _decode_adapt_tail(stream, tl, st["dirs"], w, h, bs,
                                  use_diff), w * h

    def _decode_global(self, blob: bytes, hdr: dict) -> torch.Tensor:
        """A global-layout container's bytes in pinned host memory (the
        device's result itself on the CPU), once they have landed."""
        xf = self._xfer
        st = self.stage_global(blob, hdr)
        with xf.host_stage("dispatch"):
            out, m = self.run_global_decode(hdr, st)
        with xf.host_stage("wait"):
            m = int(m)
        if m != hdr["orig"]:
            raise ValueError("corrupt v3 container: size mismatch")
        with xf.host_stage("dispatch"):
            host = xf.fetch([out[: hdr["orig"]]])[0]
        with xf.host_stage("wait"):
            xf.fence()
        return host

    def decode(self, blob: bytes) -> bytes:
        xf = self._xfer
        if blob[:6] != V3_MAGIC:
            # encode() may have returned a v1 blob (the race), and files
            # of the reference binary are v1 too
            if is_v2(blob):
                return runtime.v2_decompress(blob)
            with xf.host_stage("v1 decode"):
                # the native decoder trusts its input: hold the 9-byte
                # header against the blob first (a symbol costs at least
                # one bit)
                count, _, _ = parse_huff_header(blob)
                if count > 8 * (len(blob) - HUFF_HEADER_BYTES):
                    raise ValueError("invalid Huffman coding file contents")
                return runtime.v1_decompress(blob)
        with xf.host_stage("parse"):
            hdr = self._parse(blob, xf.timer)
        if hdr["orig"] == 0:
            return b""
        self._check_supported(hdr)
        if hdr["flags"] & FLAG_SHARDED:
            if hdr["flags"] & FLAG_ADAPT:
                flat = self.run_adapt_bands(hdr, self.stage_adapt_bands(
                    blob, hdr, 0, hdr["n_chunks"]))
            else:
                flat = self._run_decode(
                    hdr, self.stage_decode_steps(blob, hdr)[1])
            # the decoded bytes, fetched once into pinned memory
            host = xf.fetch([flat[: hdr["orig"]]])[0]
            xf.fence()
        else:
            host = self._decode_global(blob, hdr)
        with xf.host_stage("bytes"):
            result = host.numpy().tobytes()
        with xf.host_stage("crc32"):
            if zlib.crc32(result) != hdr["crc"]:
                raise ValueError("v3 container integrity check failed "
                                 "(crc32)")
        return result

    @staticmethod
    def _parse(blob: bytes, timer=None) -> dict:
        """A v3 container's header and manifest, read where they lie in
        ``blob``: the parse never slices the container and never reads the
        payload, so it costs the manifest's size, not the container's.
        ``timer`` (a ``StageTimer``, or None) counts the container's bytes
        that the parse copies as they are (the manifest arrays it hands
        out writable), as ``parse copied bytes``."""
        if len(blob) < 43 or blob[:6] != V3_MAGIC or blob[6] != 3:
            raise ValueError("invalid v3 container")
        flags = blob[7]
        code = blob[8]
        with_tables = entropy.has_tables(code)
        tblw = blob[9]  # canonical table bit width (4 or 5; 0 for fgk)
        kw = blob[10]  # lane-words manifest bit width (container max)
        orig, total, chunk_size, n_chunks, lane, crc = struct.unpack_from(
            "<QQIIII", blob, 11)
        pos = 43
        hdr = dict(flags=flags, entropy=code, orig=orig, total=total,
                   chunk_size=chunk_size, n_chunks=n_chunks, lane=lane,
                   crc=crc)
        chunk_bits: list = []
        if flags & FLAG_ADAPT and orig:
            w, h, bs, nt = struct.unpack_from("<QQQI", blob, pos)
            pos += 28
            ndb = _cdiv(nt, 8)
            dirs = np.unpackbits(
                np.frombuffer(blob, np.uint8, ndb, pos), count=nt
            ).astype(bool)
            pos += ndb
            hdr.update(w=w, h=h, bs=bs, dirs=dirs)
            if flags & FLAG_AGROUP:
                ng = _cdiv(nt, GROUP_K)
                hdr["group_offs"] = np.frombuffer(blob, "<u4", ng, pos).copy()
                pos += 4 * ng
            else:
                tw = tile_len_width(bs)
                hdr["tile_lens"] = np.frombuffer(blob, f"<u{tw}", nt,
                                                 pos).copy()
                pos += tw * nt
        if not with_tables:
            chunk_bits = np.frombuffer(blob, "<u4", n_chunks, pos).tolist()
            pos += 4 * n_chunks
        if flags & FLAG_SHARDED and n_chunks:
            rle_lens = np.frombuffer(blob, "<u4", n_chunks, pos).copy()
            pos += 4 * n_chunks
            carries = np.frombuffer(blob, np.uint8, n_chunks, pos).copy()
            pos += n_chunks
            hdr.update(rle_lens=rle_lens, carries=carries)
        if with_tables and n_chunks:
            L = (entropy.CANONICAL.cap(chunk_size, lane)
                 if flags & FLAG_SHARDED else chunk_size)
            tables = _unpackk(blob, n_chunks * 256, tblw, pos).reshape(
                n_chunks, 256).astype(np.uint8)
            pos += (n_chunks * 256 * tblw + 7) // 8
            lpc = L // lane
            counts = TorchCodec._chunk_counts(
                (hdr["rle_lens"], None) if flags & FLAG_SHARDED else None,
                total, chunk_size, n_chunks)
            used = -(-counts // lane)
            n_entries = int(used.sum())
            entries = _unpackk(blob, n_entries, kw, pos)
            pos += (n_entries * kw + 7) // 8
            lw = np.zeros((n_chunks, lpc), np.int32)
            lw[np.arange(lpc)[None, :] < used[:, None]] = entries
            chunk_bits = (32 * lw.sum(axis=1, dtype=np.int64)).tolist()
            # decoder lane stride: the fattest lane rounded up to a
            # multiple of 16 words (at least 8, at most the worst case);
            # the code-length bucket bounds the decoder's length search
            mx = int(lw.max()) if lw.size else 1
            wb = max(8, -(-mx // 16) * 16)
            ml = int(tables.max()) if tables.size else 1
            hdr.update(tables=tables, lane_words=lw,
                       wl_bucket=min(wb, lane_words_cap(lane)),
                       max_len_bucket=next(
                           b for b in (8, 12, 16, 24, 31) if b >= ml))
        if timer is not None:
            # the manifest arrays copied out of the blob as they are (the
            # tables and lane words are unpacked, not copied)
            timer.count("parse copied bytes", sum(hdr[k].nbytes for k in (
                "group_offs", "tile_lens", "rle_lens", "carries") if k in hdr))
        hdr.update(
            chunk_bits=chunk_bits, payload_off=pos,
            chunk_offs=np.concatenate([
                np.zeros(1, np.int64),
                np.cumsum(np.asarray([(b + 7) // 8 for b in chunk_bits],
                                     dtype=np.int64)),
            ]),
        )
        return hdr
