"""The plain reference of the v3 container with canonical entropy in
stream mode, in both layouts, and of the mesh's gathered columns.

``judge_v3`` takes a container the program wrote and the input it was
given, works out from the input alone every field the wire holds (header,
RLE lengths and carries, lane words, payload), takes from the container
only the code lengths, judges those (``canonical.bad_tables``), and
compares the container with what it built, byte for byte.
``judge_columns`` does the same for one step of the mesh's outputs (the
padded lane buffers and the manifest columns). Nothing here imports the
program.

The v3 wire (little-endian; payload words big-endian)::

    magic "HCTPU\\x03" | version u8 (3) | flags u8 | entropy u8 (1)
    table bit width u8 (4 if every length <= 15, else 5)
    lane-words bit width u8 (the largest lane's words' bit length, >= 1)
    orig_size u64 | transformed_size u64 | chunk_size u32 | n_chunks u32
    lane u32 | crc32 u32 (of the input)
    [sharded] rle_lens u32 * n_chunks | carries u8 * n_chunks
    code lengths, table-bit-width bits each, 256 a chunk, MSB first
    the words of every used lane, lane-words-bit-width bits each
    payload: every used lane's words, chunk after chunk

Sharded layout: the input is cut into ``chunk_size`` chunks, each RLE'd
on its own (carry: the input byte before it). Global layout: the input is
RLE'd as one stream, which is cut into chunks of the container's
``chunk_size``: either the whole-file geometry (one chunk of 8 or more
fat lanes) or ``chunk_size`` chunks at lane 2048.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from benchmark.reference import canonical, stream

MAGIC = b"HCTPU\x03"
FLAG_DIFF, FLAG_ADAPT, FLAG_SHARDED = 0x80, 0x40, 0x20
CANONICAL = 1
HEADER = 43


def rle_cap(n: int) -> int:
    """The RLE's worst case for ``n`` bytes (4 out for every 3 in)."""
    return n + n // 3 + 4


def global_geometries(n: int, chunk_size: int,
                      whole_file: bool = True) -> list[tuple[int, int]]:
    """The (chunk_size, lane) a global container of ``n`` input bytes may
    have, in the order that decides a tie of sizes: the whole-file
    geometry (the smallest power-of-two lane of at least an eighth of the
    padded RLE size, 64 to 32768, the chunk a multiple of 8 lanes), while
    the padded RLE size is at most 3,500,000 bytes and ``whole_file``
    holds, and ``chunk_size`` chunks at lane 2048."""
    cap = rle_cap(n) + 64
    out = []
    if whole_file and cap <= 3_500_000:
        lane = min(1 << 15, max(64, 1 << ((cap + 7) // 8 - 1).bit_length()))
        out.append((-(-cap // (8 * lane)) * 8 * lane, lane))
    out.append((chunk_size, 2048))
    return out


def global_size_bounds(data: np.ndarray, use_diff: bool,
                       geometry: tuple[int, int], device) -> tuple[int, int]:
    """The least and the most bytes a global container of ``data`` at
    ``geometry`` (chunk_size, lane) can have under any optimal code.

    Every optimal code of a chunk codes it in the same bits ``T`` (the
    optimal cost of its histogram), but how those bits fall into the
    chunk's ``L`` lanes, each padded to 32-bit words, depends on which
    optimal code it is: the chunk's words lie between ``ceil(T / 32)`` and
    ``floor((T + 31 L) / 32)``; a code length takes 4 or 5 bits, a lane's
    word count 1 to the bits of the chunk's most words."""
    cs, lane = geometry
    x = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    sym, total = _expected_streams(
        x, use_diff, torch.zeros(1, dtype=torch.int64, device=device))
    t = int(total[0])
    counts = torch.clamp(t - torch.arange(0, t, cs, device=device), max=cs)
    chunk_of, _ = _chunked(sym, counts)
    hist = canonical.histograms(sym, chunk_of, counts.shape[0]).cpu().numpy()
    bits = np.array([canonical.optimal_cost(h) for h in hist], np.int64)
    used = -(-counts.cpu().numpy() // lane)
    nc, entries = len(bits), int(used.sum())
    words_lo, words_hi = -(-bits // 32), (bits + 31 * used) // 32
    kw_lo = max(1, int((-(-(-(-bits // used)) // 32)).max()).bit_length())
    kw_hi = max(1, int(words_lo.max()).bit_length())
    lo = (HEADER + -(-nc * 256 * 4 // 8) + -(-entries * kw_lo // 8)
          + 4 * int(words_lo.sum()))
    hi = (HEADER + -(-nc * 256 * 5 // 8) + -(-entries * kw_hi // 8)
          + 4 * int(words_hi.sum()))
    return lo, hi


def geometry_of(blob: bytes) -> tuple[int, int]:
    """(chunk_size, lane) a v3 container's header states."""
    _, _, chunk_size, _, lane, _ = struct.unpack_from("<QQIIII", blob, 11)
    return chunk_size, lane


def _unpack(raw: bytes, count: int, width: int) -> np.ndarray:
    """``count`` values of ``width`` bits, MSB first."""
    if width == 0:
        return np.zeros(count, np.int64)
    nbytes = (count * width + 7) // 8
    bits = np.unpackbits(np.frombuffer(raw, np.uint8, nbytes))
    bits = bits[: count * width].reshape(count, width).astype(np.int64)
    return (bits << np.arange(width - 1, -1, -1)).sum(axis=1)


def _pack(vals: np.ndarray, width: int) -> bytes:
    v = np.asarray(vals, np.int64).reshape(-1)
    bits = (v[:, None] >> np.arange(width - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(-1).astype(np.uint8)).tobytes()


def _expected_streams(x: torch.Tensor, use_diff: bool, starts):
    y = stream.diff(x) if use_diff else x
    return stream.mnp5(y, starts)


def _chunked(sym: torch.Tensor, lens: torch.Tensor):
    """Each symbol's chunk and place in it, for streams of ``lens``."""
    dev = sym.device
    n_chunks = lens.shape[0]
    chunk_of = torch.repeat_interleave(torch.arange(n_chunks, device=dev),
                                       lens)
    pos = (torch.arange(sym.shape[0], device=dev)
           - (torch.cumsum(lens, 0) - lens)[chunk_of])
    return chunk_of, pos


def _mismatch(got: bytes, want: bytes) -> int:
    """Bytes that differ, counting a length difference as differing."""
    m = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, m)
    b = np.frombuffer(want, np.uint8, m)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))


def judge_v3(blob: bytes, data: np.ndarray, cfg: dict, device) -> dict:
    """Judge a v3 container of ``data`` written under ``cfg`` (the
    CodecConfig fields). Returns {"bad_bytes": bytes of the container
    that differ from the reference's, "bad_tables": chunks whose code
    lengths are not an optimal complete code of the reference's
    histogram}. A container whose code lengths cannot even be read where
    the reference expects them (too short, wrong widths) differs in all
    its bytes."""
    try:
        return _judge_v3(blob, data, cfg, device)
    except (ValueError, IndexError, RuntimeError, struct.error):
        return {"bad_bytes": max(len(blob), len(data), 1), "bad_tables": 1}


def _judge_v3(blob: bytes, data: np.ndarray, cfg: dict, device) -> dict:
    n = len(data)
    sharded = cfg["layout"] == "sharded"
    use_diff = bool(cfg["use_diff"])
    if len(blob) < HEADER or blob[:6] != MAGIC:
        return {"bad_bytes": max(len(blob), n), "bad_tables": 1}
    tw, kw = blob[9], blob[10]
    _, _, chunk_size, n_chunks, lane, _ = struct.unpack_from(
        "<QQIIII", blob, 11)
    x = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    if sharded:
        chunk_size, lane = int(cfg["chunk_size"]), int(cfg["lane"])
        starts = torch.arange(0, n, chunk_size, device=device)
        sym, rle_lens = _expected_streams(x, use_diff, starts)
        counts = rle_lens
    else:
        if (chunk_size, lane) not in global_geometries(
                n, int(cfg["chunk_size"])):
            chunk_size, lane = global_geometries(n, int(cfg["chunk_size"]))[-1]
        sym, total = _expected_streams(
            x, use_diff, torch.zeros(1, dtype=torch.int64, device=device))
        t = int(total[0])
        counts = torch.clamp(
            t - torch.arange(0, t, chunk_size, device=device), max=chunk_size)
    total = int(counts.sum())
    nc = counts.shape[0]
    pos = HEADER
    if sharded:
        pos += 5 * nc
    lens_np = _unpack(blob[pos:], nc * 256, tw).reshape(nc, 256)
    lens = torch.from_numpy(lens_np).to(device)
    chunk_of, at = _chunked(sym, counts)
    hist = canonical.histograms(sym, chunk_of, nc)
    bad_tables = canonical.bad_tables(lens, hist)
    if not canonical.codes_every_symbol(lens, hist):
        return {"bad_bytes": max(len(blob), n, 1), "bad_tables": bad_tables}
    words, payload = canonical.lanes(sym, chunk_of, at, counts, lens, lane)
    lw = words.cpu().numpy()
    kw_want = max(1, int(lw.max(initial=0)).bit_length())
    tw_want = 4 if int(lens_np.max(initial=0)) <= 15 else 5
    flags = ((FLAG_DIFF if use_diff else 0)
             | (FLAG_SHARDED if sharded else 0))
    want = bytearray(MAGIC)
    want += bytes([3, flags, CANONICAL, tw_want, kw_want])
    want += struct.pack("<QQIIII", n, total, chunk_size, nc, lane,
                        zlib.crc32(data.tobytes()))
    if sharded:
        carries = np.zeros(nc, np.uint8)
        carries[1:] = data[chunk_size - 1::chunk_size][: nc - 1]
        want += counts.cpu().numpy().astype("<u4").tobytes()
        want += carries.tobytes()
    want += _pack(lens_np, tw_want)
    want += _pack(lw, kw_want)
    want += canonical.to_wire(payload)
    return {"bad_bytes": _mismatch(blob, bytes(want)),
            "bad_tables": bad_tables}


def judge_columns(cols: dict, data: np.ndarray, chunk_size: int, lane: int,
                  use_diff: bool, device) -> dict:
    """Judge one mesh step's gathered outputs on its input ``data`` (the
    step's bytes, before the zero padding to its chunk count). ``cols``:
    ``lane_buf`` (C, n_lanes, W) int32, ``lane_words`` (C, n_lanes),
    ``tables`` (C, 256), ``rle_lens`` (C,), ``carries`` (C,), as host
    arrays; C may pass the data's chunks (those past it are empty). The
    step starts a stream of its own (carry 0). Returns {"bad_bytes":
    manifest and payload bytes that differ, "bad_tables": as
    ``judge_v3``}."""
    try:
        return _judge_columns(cols, data, chunk_size, lane, use_diff, device)
    except (ValueError, IndexError, RuntimeError):
        return {"bad_bytes": max(len(data), 1), "bad_tables": 1}


def _judge_columns(cols, data, chunk_size, lane, use_diff, device) -> dict:
    C = cols["rle_lens"].shape[0]
    n = len(data)
    padded = np.zeros(C * chunk_size, np.uint8)
    padded[:n] = data
    x = torch.from_numpy(padded[:n]).to(device)
    starts = torch.arange(0, n, chunk_size, device=device)
    sym, rle = _expected_streams(x, use_diff, starts)
    counts = torch.zeros(C, dtype=torch.int64, device=device)
    counts[: rle.shape[0]] = rle
    lens = torch.from_numpy(cols["tables"].astype(np.int64)).to(device)
    chunk_of, at = _chunked(sym, counts)
    hist = canonical.histograms(sym, chunk_of, C)
    bad_tables = canonical.bad_tables(lens, hist)
    if not canonical.codes_every_symbol(lens, hist):
        return {"bad_bytes": max(len(data), 1), "bad_tables": bad_tables}
    words, payload = canonical.lanes(sym, chunk_of, at, counts, lens, lane)
    lw = np.asarray(cols["lane_words"], np.int64)
    used = -(-counts.cpu().numpy() // lane)
    mask = np.arange(lw.shape[1])[None, :] < used[:, None]
    lw_want = np.zeros_like(lw)
    lw_want[mask] = words.cpu().numpy()
    buf = np.asarray(cols["lane_buf"]).reshape(C, lw.shape[1], -1)
    inside = np.arange(buf.shape[2])[None, None, :] < lw[:, :, None]
    got_payload = buf[inside].view(np.uint32).astype(">u4").tobytes()
    carries = np.zeros(C, np.uint8)
    if use_diff:
        carries[1:] = padded[chunk_size - 1::chunk_size][: C - 1]
    bad = (_mismatch(np.asarray(cols["rle_lens"], "<u4").tobytes(),
                     counts.cpu().numpy().astype("<u4").tobytes())
           + _mismatch(np.asarray(cols["carries"], np.uint8).tobytes(),
                       carries.tobytes())
           + _mismatch(lw.astype("<u4").tobytes(),
                       lw_want.astype("<u4").tobytes())
           + _mismatch(got_payload, canonical.to_wire(payload)))
    return {"bad_bytes": bad, "bad_tables": bad_tables}
