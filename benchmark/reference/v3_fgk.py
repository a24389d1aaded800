"""The plain reference of the v3 container with FGK entropy in the sharded
stream layout, named by a configuration as ``"reference": "v3_fgk"``.

The wire (little-endian), written from the format's rules::

    magic "HCTPU\\x03" | version u8 (3) | flags u8 (diff 0x80, sharded 0x20)
    entropy u8 (0, FGK) | table bit width u8 (0) | lane-words bit width u8 (0)
    orig_size u64 | transformed_size u64 | chunk_size u32 | n_chunks u32
    lane u32 | crc32 u32 (of the input)
    bits u32 * n_chunks | rle_lens u32 * n_chunks | carries u8 * n_chunks
    payload: every chunk's FGK stream, chunk after chunk, each its bits
             MSB first, zero padded to a whole byte

Each chunk is diffed (seeded by the input byte before it) and RLE'd on
its own (``stream``), then coded by FGK from a fresh tree (``fgk``).

``judge_encode`` derives from the input alone the header, every chunk's
``rle_lens`` and ``carries``, and holds the payload's length to the sum of
the streams' whole bytes. The pure-Python FGK codes 0.05-0.4 M symbols
a second (random bytes the slowest), so it judges ``bits`` and stream of
a sample of ``CHUNKS_JUDGED`` chunks: the first, the last (the short one)
and others drawn by the run's ``rng``. A byte that differs counts one; a
container whose shape is wrong (too short, a payload of another length
than its bit counts give) counts all its bytes. The global layout (one FGK
candidate raced against v1) is not judged here: ``check`` refuses it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from benchmark.reference import stream
from benchmark.reference.container import (FLAG_DIFF, FLAG_SHARDED, HEADER,
                                           MAGIC, _mismatch)
from benchmark.reference.fgk import fgk_encode

FGK = 0  # the entropy byte
# chunks of a container whose bits and stream are judged, the first and
# the last among them: as many as keep a bulk run's three judged encodes
# of 64 KiB chunks under 30 s of one host core
CHUNKS_JUDGED = 24


def check(cfg: dict) -> None:
    """Raises unless ``cfg`` (``CodecConfig`` fields) is the sharded
    stream layout with FGK entropy."""
    if (cfg.get("layout") != "sharded" or cfg.get("entropy") != "fgk"
            or cfg.get("use_adapt")):
        raise ValueError("v3_fgk judges the sharded stream layout with FGK "
                         f"entropy only, not {cfg}")


def sizes(blob: bytes) -> dict:
    """Work counts of a sharded FGK container from its header and
    manifest: the RLE bytes, the payload bytes, the restored bytes and
    the code bits."""
    if blob[:6] != MAGIC or not blob[7] & FLAG_SHARDED or blob[8] != FGK:
        return {}
    orig, total, _, nc, _, _ = struct.unpack_from("<QQIIII", blob, 11)
    if len(blob) < HEADER + 9 * nc:
        return {}
    bits = np.frombuffer(blob, "<u4", nc, HEADER)
    return {"rle_bytes": int(total),
            "payload_bytes": len(blob) - HEADER - 9 * nc,
            "out_bytes": int(orig),
            "code_bits": int(bits.sum(dtype=np.int64))}


def chunks_judged(n_chunks: int, rng: np.random.Generator) -> list[int]:
    """The chunks whose streams are judged: all of them up to
    ``CHUNKS_JUDGED``, else the first, the last and others drawn by
    ``rng``, in order."""
    if n_chunks <= CHUNKS_JUDGED:
        return list(range(n_chunks))
    mid = rng.choice(np.arange(1, n_chunks - 1), CHUNKS_JUDGED - 2,
                     replace=False)
    return [0, *sorted(int(c) for c in mid), n_chunks - 1]


def judge_encode(blob: bytes, data: np.ndarray, cfg: dict, device,
                 rng: np.random.Generator) -> dict:
    """Judge a container of ``data`` written under ``cfg``. Returns
    {"bad_bytes": bytes that differ from the reference's, "bad_tables": 0
    (FGK has no tables), "v1": 0}."""
    try:
        bad = _judge(blob, data, cfg, device, rng)
    except (ValueError, IndexError, RuntimeError, struct.error):
        bad = None
    if bad is None:
        bad = max(len(blob), len(data), 1)
    return {"bad_bytes": bad, "bad_tables": 0, "v1": 0}


def _judge(blob: bytes, data: np.ndarray, cfg: dict, device,
           rng: np.random.Generator) -> int | None:
    """Bytes that differ, or None where the container's shape is wrong."""
    n = len(data)
    cs, lane = int(cfg["chunk_size"]), int(cfg["lane"])
    use_diff = bool(cfg["use_diff"])
    x = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    starts = torch.arange(0, n, cs, device=device)
    sym, rle = stream.mnp5(stream.diff(x) if use_diff else x, starts)
    rle = rle.cpu().numpy()
    nc = len(rle)
    carries = np.zeros(nc, np.uint8)
    carries[1:] = data[cs - 1::cs][: nc - 1]
    flags = (FLAG_DIFF if use_diff else 0) | FLAG_SHARDED
    head = (MAGIC + bytes([3, flags, FGK, 0, 0])
            + struct.pack("<QQIIII", n, int(rle.sum()), cs, nc, lane,
                          zlib.crc32(data.tobytes())))
    payload_off = HEADER + 9 * nc
    if len(blob) < payload_off:
        return None
    bits = np.frombuffer(blob, "<u4", nc, HEADER).astype(np.int64)
    nbytes = (bits + 7) // 8
    if payload_off + int(nbytes.sum()) != len(blob):
        return None
    bad = (_mismatch(blob[:HEADER], head)
           + _mismatch(blob[HEADER + 4 * nc: payload_off],
                       rle.astype("<u4").tobytes() + carries.tobytes()))
    stream_at = payload_off + np.cumsum(nbytes) - nbytes
    sym_at = np.cumsum(rle) - rle
    sym = sym.cpu().numpy()
    for c in chunks_judged(nc, rng):
        code = fgk_encode(sym[sym_at[c]: sym_at[c] + rle[c]].tobytes())
        at, m = HEADER + 4 * c, int(stream_at[c])
        bad += _mismatch(blob[at: at + 4], struct.pack("<I", len(code)))
        bad += _mismatch(blob[m: m + int(nbytes[c])],
                         np.packbits(np.asarray(code, np.uint8)).tobytes())
    return bad
