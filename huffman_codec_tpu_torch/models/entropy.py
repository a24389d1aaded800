"""The entropy coders of the port's codec (``lookup`` by a
``CodecConfig.entropy`` name, ``by_code`` by a container's entropy byte):
the one module that branches on the entropy mode.

``Canonical``: a canonical Huffman code a chunk in word-aligned lanes of
``lane`` symbols, each chunk's code-length table and used lanes' words in
the manifest; a sharded encode step is a CUDA graph replay, in order.
``FGK``: the reference's adaptive Huffman coder, a fresh tree a chunk,
each chunk's stream byte-aligned and its bits in the manifest; a step is
bound by its longest chain (one thread a chunk), so steps run eagerly,
side by side. ``meta``: a coder's per-chunk manifest column (lane words
(C, n_lanes), or bits (C,)); ``xf``: the codec's ``pipeline.Transfers``.
"""

from __future__ import annotations

import numpy as np
import torch

from huffman_codec_tpu_torch.formats import ENTROPY
from huffman_codec_tpu_torch.models.pipeline import (
    InOrder,
    SideBySide,
    side_by_side_width,
)
from huffman_codec_tpu_torch.ops import kernels
from huffman_codec_tpu_torch.ops.canonical import (
    MAX_LEN,
    canonical_decode_batch,
    canonical_encode_batch,
)
from huffman_codec_tpu_torch.ops.fgk import n_words_for
from huffman_codec_tpu_torch.ops.pack import chunk_bytes, chunk_words
from huffman_codec_tpu_torch.ops.rle import rle_max_encoded_len

# a canonical one-chunk container up to this size decodes as 8
# pseudo-chunks that share its table
_SINGLE_MAX = 2 << 20


def _strip_payload(buf: torch.Tensor, lw: torch.Tensor) -> torch.Tensor:
    """(C, n_lanes, W) padded lane buffers -> a (C * n_lanes * W,) buffer
    whose prefix is the dense payload words, zeros past it, at a fixed
    shape and without synchronising (the JAX package's compaction): each
    lane's first ``lw`` words are scattered to its offset, an exclusive
    cumsum of ``lw``, its other words to a spill slot of its own past the
    end, which is cut off. The used length is ``lw.sum()``, which a caller
    reads from the manifest."""
    C, nl, W = buf.shape
    n = C * nl * W
    dev = buf.device
    lw64 = lw.reshape(-1).to(torch.int64)
    off = torch.cumsum(lw64, 0) - lw64
    col = torch.arange(W, device=dev)[None, :]
    spill = n + torch.arange(C * nl, device=dev)[:, None]
    dst = torch.where(col < lw64[:, None], off[:, None] + col, spill)
    out = torch.zeros(n + C * nl, dtype=buf.dtype, device=dev)
    out.scatter_(0, dst.reshape(-1), buf.reshape(-1))
    return out[:n]


def _bucket(used: int, size: int) -> int:
    """The words a payload fetch takes: ``used`` rounded up to a power of
    two (at least 1024), as the JAX package's second fetch wave does, at
    most the payload's ``size``."""
    b = 1024
    while b < used:
        b <<= 1
    return min(b, size)


def _counts(total: int, rows: int, size: int, device) -> torch.Tensor:
    """Symbols in each of ``rows`` rows of ``size`` of a ``total`` stream."""
    return torch.from_numpy(np.clip(
        total - np.arange(rows, dtype=np.int64) * size, 0, size).astype(
            np.int32)).to(device)


class Canonical:
    name = "canonical"
    code = ENTROPY[name]
    chain_bound = False
    whole_file = True  # a global candidate of one chunk of fat lanes

    def check(self, chunk_size: int, lane: int) -> None:
        if chunk_size % lane:
            raise ValueError("chunk_size must divide by lane")
        if lane > 1 << 15:
            raise ValueError("lane > 32768 overflows the packed "
                             "lane-words manifest width")

    def cap(self, chunk_size: int, lane: int) -> int:
        blk = 8 * lane  # the padded RLE row: whole blocks of 8 lanes
        return -(-rle_max_encoded_len(chunk_size) // blk) * blk

    def encode(self, chunks, lens, lane: int, n_words=None):
        """-> (lane_buf (C, n_lanes, W), lane_words, tables)."""
        return canonical_encode_batch(chunks, lens, lane=lane)

    def keep(self, a, meta):
        """What a stage keeps of its payload on the device: the words
        stripped at a fixed shape, without synchronising."""
        return _strip_payload(a, meta)

    def payloads(self, xf, kept: list, metas: list, hosts: list,
                 span: str | None = None):
        """A fetch's payload wave: each strip's used prefix (the host
        manifest ``hosts`` has its words), rounded up (``_bucket``), copied
        to pinned memory in the host span ``span``, without waiting.
        Returns (the used words' views, the event after the copies)."""
        with xf.host_stage(span):
            out = []
            for k, h in zip(kept, hosts):
                used = int(h.numpy().sum(dtype=np.int64))
                out.append(xf.fetch([k[: _bucket(used, len(k))]])[0][:used])
            return out, xf.record()

    def wire(self, words) -> bytes:
        """Payload words (u32 bits in int32) -> big-endian wire bytes."""
        return words.cpu().numpy().view(np.uint32).astype(">u4").tobytes()

    def manifest(self, lane_words, tables):
        """Host manifest columns -> (chunk_bits, tables, lane_words)."""
        return ((lane_words.sum(axis=1, dtype=np.int64) * 32).tolist(),
                tables, lane_words)

    def stage_step(self, xf, blob: bytes, hdr: dict, c0: int, c1: int,
                   S: int, head: list):
        """Uploads ``head``'s parts, chunks [c0, c1)'s lane words and tables
        zero-padded to S chunks, and their payload words, in one buffer.
        -> (the views of ``head``, the upload's event, staged tensors)."""
        nl = hdr["lane_words"].shape[1]
        offs = hdr["chunk_offs"]
        nw = int(offs[c1] - offs[c0]) // 4
        _, views, ready = xf.upload(head + [
            (hdr["lane_words"][c0:c1], S * nl, torch.int32),
            (hdr["tables"][c0:c1], S * 256, torch.uint8),
            (np.frombuffer(blob, ">u4", nw, hdr["payload_off"]
                           + int(offs[c0])), nw, torch.int32)])
        k = len(head)
        return views[:k], ready, {"lw": views[k].view(S, nl),
                                  "tables": views[k + 1].view(S, 256),
                                  "flat": views[k + 2]}

    def stage_global(self, xf, blob: bytes, hdr: dict, device) -> dict:
        """A global-layout container's staged tensors (host span
        ``upload``); one chunk of at most ``_SINGLE_MAX`` bytes whose lanes
        divide by 8 as 8 pseudo-chunks that share its table."""
        with xf.host_stage("upload"):
            cs, n_chunks = hdr["chunk_size"], hdr["n_chunks"]
            nw = int(hdr["chunk_offs"][-1]) // 4
            flat = np.frombuffer(blob, ">u4", nw, hdr["payload_off"]).astype(
                np.uint32)
            lane_words, tables = hdr["lane_words"], hdr["tables"]
            n_lanes = cs // hdr["lane"]
            rows, rcs = n_chunks, cs
            if (n_chunks == 1 and n_lanes % 8 == 0 and n_lanes >= 8
                    and cs <= _SINGLE_MAX):
                rows, rcs = 8, cs // 8
                tables = np.tile(tables, (8, 1))
                lane_words = np.ascontiguousarray(lane_words.reshape(8, -1))
            return {"rcs": rcs,
                    "flat": torch.from_numpy(flat.view(np.int32)).to(device),
                    "lw": torch.from_numpy(lane_words).to(device),
                    "tables": torch.from_numpy(tables).to(device),
                    "counts": _counts(hdr["total"], rows, rcs, device)}

    def decode_rows(self, words, counts, out_len: int, lane: int, tables,
                    lane_words, max_len: int = MAX_LEN):
        """Padded lane words (C, n_lanes * W) -> (C, out_len) uint8."""
        return canonical_decode_batch(words, tables, lane_words, counts,
                                      lane=lane, out_len=out_len,
                                      max_len=max_len)

    def decode(self, hdr: dict, st: dict, counts, out_len: int):
        """Staged rows -> (rows, out_len) uint8: re-pad to the container's
        lane stride, lane decode at its code-length bucket."""
        words = kernels.repad_words(st["flat"], st["lw"], hdr["wl_bucket"])
        return self.decode_rows(words, counts, out_len, hdr["lane"],
                                st["tables"], st["lw"],
                                hdr["max_len_bucket"])

    def schedule(self, xf, n_steps: int, S: int) -> InOrder:
        return InOrder(xf)


class FGK:
    name = "fgk"
    code = ENTROPY[name]
    chain_bound = True
    whole_file = False

    def check(self, chunk_size: int, lane: int) -> None:
        pass  # every chunk size and lane

    def cap(self, chunk_size: int, lane: int) -> int:
        return rle_max_encoded_len(chunk_size)

    def encode(self, chunks, lens, lane: int, n_words=None):
        """-> (words (C, n_words), bits (C,), None); ``n_words`` defaults to
        an L-symbol row's worst case."""
        words, bits = kernels.fgk_encode(
            chunks, lens,
            n_words_for(chunks.shape[1]) if n_words is None else n_words)
        return words, bits, None

    def keep(self, a, meta):
        return a  # the strip synchronises: the fetch makes it

    def payloads(self, xf, kept: list, metas: list, hosts: list,
                 span: str | None = None):
        """A fetch's payload wave: the streams' bytes cut out of the word
        rows on the device (``chunk_bytes``, which synchronises) in the
        host span ``fgk strip``. -> (the bytes, None: nothing to wait on)."""
        with xf.host_stage("fgk strip"):
            return [chunk_bytes(k, m) for k, m in zip(kept, metas)], None

    def wire(self, payload) -> bytes:
        return payload.cpu().numpy().tobytes()

    def manifest(self, bits):
        return bits.astype(np.int64).tolist(), None, None

    def _words(self, xf, blob: bytes, hdr: dict, c0: int, c1: int,
               rows: int) -> torch.Tensor:
        """Chunks [c0, c1) as (rows, W) int32 word rows, zero past each
        stream: the payload bytes uploaded, cut on the device (device span
        ``fgk rows``). W is the longest stream's words plus a zero word."""
        offs = hdr["chunk_offs"]
        nbytes = int(offs[c1] - offs[c0])
        nb = np.diff(offs[c0:c1 + 1])
        _, (payload, off, nbt), ready = xf.upload([
            (np.frombuffer(blob, np.uint8, nbytes,
                           hdr["payload_off"] + int(offs[c0])), nbytes,
             torch.uint8),
            (offs[c0:c1] - offs[c0], rows, torch.int64),
            (nb, rows, torch.int64)])
        xf.wait(ready)
        n_words = -(-int(nb.max(initial=0)) // 4) + 1
        with xf.device_stage("fgk rows"):
            return chunk_words(payload, off, nbt, n_words)

    def stage_step(self, xf, blob: bytes, hdr: dict, c0: int, c1: int,
                   S: int, head: list):
        _, views, ready = xf.upload(head)
        return views, ready, {"words": self._words(xf, blob, hdr, c0, c1, S)}

    def stage_global(self, xf, blob: bytes, hdr: dict, device) -> dict:
        cs, n_chunks = hdr["chunk_size"], hdr["n_chunks"]
        with xf.host_stage("upload"):
            counts = _counts(hdr["total"], n_chunks, cs, device)
        return {"rcs": cs, "counts": counts,
                "words": self._words(xf, blob, hdr, 0, n_chunks, n_chunks)}

    def decode_rows(self, words, counts, out_len: int, lane: int,
                    tables=None, lane_words=None):
        return kernels.fgk_decode(words, counts, out_len)

    def decode(self, hdr: dict, st: dict, counts, out_len: int):
        return self.decode_rows(st["words"], counts, out_len, hdr["lane"])

    def width(self, xf, S: int) -> int:
        """Steps side by side: as many as the card holds the blocks of."""
        if not xf.cuda:
            return 1
        index = xf.device.index
        return side_by_side_width(kernels.fgk_resident_blocks(
            torch.cuda.current_device() if index is None else index), S)

    def schedule(self, xf, n_steps: int, S: int) -> SideBySide:
        return SideBySide(xf, n_steps, self.width(xf, S), "fgk steps")


CANONICAL = Canonical()
_CODERS = {e.name: e for e in (CANONICAL, FGK())}
_BY_CODE = {e.code: e for e in _CODERS.values()}


def lookup(name: str):
    if name not in _CODERS:
        raise ValueError(f"unknown entropy mode {name}")
    return _CODERS[name]


def by_code(code: int):
    if code not in _BY_CODE:
        raise ValueError(f"unknown entropy mode {code} in the v3 container")
    return _BY_CODE[code]


def has_tables(code: int) -> bool:
    """Whether the manifest of entropy byte ``code`` keeps tables and lane
    words, not chunk bits (an unknown code: bits; ``by_code`` refuses it)."""
    return code == CANONICAL.code
