"""TorchCodec: the v3 sharded canonical codec on PyTorch and CUDA.

Writes the same v3 container bytes as the JAX package's
``TPUCodec(CodecConfig(layout="sharded", ...))`` for the same input and
config, and decodes the containers of either package. Layout of the wire
(little-endian; payload words big-endian):

    magic "HCTPU\\x03" | version u8 (3) | flags u8 | entropy u8
    table bit width u8 | lane-words bit width u8
    orig_size u64 | transformed_size u64 | chunk_size u32 | n_chunks u32
    lane u32 | crc32 u32 (of the original data)
    [sharded] rle_lens u32 * n_chunks | carries u8 * n_chunks
    [canonical] code-length tables, 4 or 5 bits packed (256 per chunk)
                lane_words of the used lanes, k bits packed
    payload: every chunk's lanes, each word-aligned, chunk after chunk

Encode, one step of ``step_chunks`` input chunks at a time: per-chunk diff
seeded by the carry byte and MNP-5 RLE (kernel), byte histogram (kernel),
package-merge code lengths and canonical codes (torch ops), lane pack
(kernel), then the padding between lanes is stripped on the device.
Decode, per step: re-pad the wire words to a fixed lane stride (kernel),
canonical lane decode (kernel), count-byte classification (torch ops),
MNP-5 expansion with the diff revert (kernel), then the crc32 check.

This slice supports ``layout="sharded"``, ``entropy="canonical"`` and
``use_adapt=False``; other configurations raise NotImplementedError.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, fields

import numpy as np
import torch

from huffman_codec_tpu_torch.formats import (
    ENTROPY,
    ENTROPY_CANONICAL,
    FLAG_ADAPT,
    FLAG_AGROUP,
    FLAG_DIFF,
    FLAG_SHARDED,
    GROUP_K,
    V3_MAGIC,
)
from huffman_codec_tpu_torch.ops import kernels
from huffman_codec_tpu_torch.ops.canonical import (
    canonical_decode_batch,
    canonical_encode_batch,
)
from huffman_codec_tpu_torch.ops.kernels import lane_words_cap
from huffman_codec_tpu_torch.ops.rle import rle_classify, rle_max_encoded_len


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


# the configuration this slice runs: the sharded streaming layout in
# stream mode with canonical entropy, 256 chunks of 64 KiB per step
MAIN_PATH = CodecConfig(layout="sharded", step_chunks=256)


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


def _unpackk(raw: bytes, count: int, width: int) -> np.ndarray:
    nbytes = (count * width + 7) // 8
    bits = np.unpackbits(np.frombuffer(raw, np.uint8, nbytes))
    bits = bits[: count * width].reshape(count, width).astype(np.int64)
    return (bits << np.arange(width - 1, -1, -1)).sum(axis=1)


def _sharded_cap(chunk_size: int, entropy: str, lane: int) -> int:
    """Padded per-chunk RLE buffer length; canonical rounds up to whole
    blocks of 8 lanes."""
    cap = rle_max_encoded_len(chunk_size)
    blk = 8 * lane
    return -(-cap // blk) * blk if entropy == "canonical" else cap


def _tile_len_width(bs: int) -> int:
    """Manifest bytes per adaptive tile length."""
    return 2 if rle_max_encoded_len(bs * bs) <= 0xFFFF else 4


def _strip_payload(buf: torch.Tensor, lw: torch.Tensor) -> torch.Tensor:
    """(C, n_lanes, W) padded lane buffers -> the dense payload words, by
    one boolean-mask compaction on the buffers' device."""
    col = torch.arange(buf.shape[2], device=buf.device)
    return buf[col[None, None, :] < lw[:, :, None]]


def _words_to_wire(words: torch.Tensor) -> bytes:
    """int32 words (u32 bits) -> big-endian wire bytes."""
    return words.cpu().numpy().view(np.uint32).astype(">u4").tobytes()


def _encode_sharded_stage(data: torch.Tensor, length: int, carry0: int,
                          use_diff: bool, chunk_size: int, n_chunks: int,
                          lane: int):
    """Per-chunk diff (with carry) -> per-chunk RLE -> canonical entropy.

    ``data`` is (n_chunks * chunk_size,) uint8 on the device, of which the
    first ``length`` bytes are input; ``carry0`` is the input byte before
    it (0 at the stream start). Returns (lane_buf, lane_words, tables,
    rle_lens, carries) on the device."""
    dev = data.device
    chunks = data.view(n_chunks, chunk_size)
    starts = torch.arange(n_chunks, device=dev, dtype=torch.int64) * chunk_size
    in_lens = (length - starts).clamp(0, chunk_size).to(torch.int32)
    # interior chunks are full, so [:, -1] is the next chunk's carry; the
    # chunks after a partial tail have in_lens 0 and encode nothing
    carries = torch.cat([torch.tensor([carry0], dtype=torch.uint8, device=dev),
                         chunks[:-1, -1]])
    cap = _sharded_cap(chunk_size, "canonical", lane)
    streams, rle_lens = kernels.rle_diff_encode(chunks, in_lens, carries,
                                                use_diff, cap)
    buf, lane_words, tables = canonical_encode_batch(streams, rle_lens,
                                                     lane=lane)
    return buf, lane_words, tables, rle_lens, carries


class TorchCodec:
    """Chunk-parallel lossless codec whose encode and decode run on a CUDA
    device through the kernels of ``ops/kernels.py``.

    ``device=None`` means ``"cuda"``, and raises when no GPU is present;
    ``device="cpu"`` runs every kernel's plain PyTorch version instead."""

    def __init__(self, config: CodecConfig | None = None, device=None):
        self.config = cfg = config or MAIN_PATH
        if cfg.entropy not in ENTROPY:
            raise ValueError(f"unknown entropy mode {cfg.entropy}")
        if cfg.layout not in ("global", "sharded"):
            raise ValueError(f"unknown layout {cfg.layout}")
        if cfg.entropy == "canonical":
            if cfg.chunk_size % cfg.lane:
                raise ValueError("chunk_size must divide by lane")
            if cfg.lane > 1 << 15:
                raise ValueError("lane > 32768 overflows the packed "
                                 "lane-words manifest width")
        if cfg.layout != "sharded":
            raise NotImplementedError(
                "the global layout comes with ROADMAP.md queue 1 item 6")
        if cfg.use_adapt:
            raise NotImplementedError(
                "adaptive block RLE comes with ROADMAP.md queue 1 item 7")
        if cfg.entropy != "canonical":
            raise NotImplementedError(
                "FGK entropy comes with ROADMAP.md queue 1 item 8")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run "
                               "the plain PyTorch versions")

    # -- encode -------------------------------------------------------------

    def encode_chunk_range(self, data: np.ndarray | bytes, c0: int, c1: int):
        """Encode chunks [c0, c1) of the input as one fixed step; chunks
        past the input are zero-padded and encode nothing. The step is
        restartable through its carry byte, so a range re-encoded alone
        splices in byte-equal. Returns (lane_buf, lane_words, tables,
        rle_lens, carries) on the device, without synchronising."""
        cfg = self.config
        cs = cfg.chunk_size
        arr = (np.frombuffer(data, np.uint8)
               if isinstance(data, (bytes, bytearray)) else data)
        n = len(arr)
        lo, hi = c0 * cs, min(n, c1 * cs)
        step_np = np.zeros((c1 - c0) * cs, np.uint8)
        step_np[: max(0, hi - lo)] = arr[lo:hi]
        carry0 = int(arr[lo - 1]) if 0 < lo <= n else 0
        x = torch.from_numpy(step_np).to(self.device)
        return _encode_sharded_stage(x, max(0, hi - lo), carry0,
                                     cfg.use_diff, cs, c1 - c0, cfg.lane)

    def encode(self, data: bytes) -> bytes:
        cfg = self.config
        n = len(data)
        if n == 0:
            return self._container(b"", 0, 0, [], None, None, None,
                                   zlib.crc32(b""))
        n_chunks = _cdiv(n, cfg.chunk_size)
        arr = np.frombuffer(data, np.uint8)
        S = min(cfg.step_chunks or n_chunks, n_chunks)
        payload, lws, tables, rle_lens, carries = [], [], [], [], []
        for k in range(_cdiv(n_chunks, S)):
            buf, lw, tab, rl, car = self.encode_chunk_range(arr, k * S,
                                                            (k + 1) * S)
            payload.append(_words_to_wire(_strip_payload(buf, lw)))
            lws.append(lw.cpu().numpy())
            tables.append(tab.cpu().numpy())
            rle_lens.append(rl.cpu().numpy())
            carries.append(car.cpu().numpy())
        rl = np.concatenate(rle_lens)[:n_chunks]
        car = np.concatenate(carries)[:n_chunks]
        lw = np.concatenate(lws)[:n_chunks]
        chunk_bits = (lw.sum(axis=1, dtype=np.int64) * 32).tolist()
        return self._container(b"".join(payload), n, int(rl.sum()),
                               chunk_bits, np.concatenate(tables)[:n_chunks],
                               lw, (rl, car), zlib.crc32(data))

    def _container(self, payload, orig, total, chunk_bits, tables,
                   lane_words, sharded_meta, crc=0, chunk_size=None,
                   lane=None) -> bytes:
        cfg = self.config
        chunk_size = cfg.chunk_size if chunk_size is None else chunk_size
        lane = cfg.lane if lane is None else lane
        canonical = cfg.entropy == "canonical" and tables is not None
        out = bytearray()
        out += V3_MAGIC
        out.append(3)  # container version
        out.append(cfg.flags())
        out.append(ENTROPY[cfg.entropy])
        # code-length table bit width, then the lane-words bit width: the
        # maximum of THIS container
        tw = kw = 0
        if canonical and len(chunk_bits):
            tw = 4 if int(np.max(tables)) <= 15 else 5
            kw = max(1, int(np.asarray(lane_words).max()).bit_length())
        out.append(tw)
        out.append(kw)
        out += struct.pack("<QQIIII", orig, total, chunk_size,
                           len(chunk_bits), lane, crc)
        if not canonical:
            out += np.asarray(chunk_bits, "<u4").tobytes()
        if sharded_meta is not None:
            rle_lens, carries = sharded_meta
            out += np.asarray(rle_lens, "<u4").tobytes()
            out += np.asarray(carries, np.uint8).tobytes()
        if canonical and len(chunk_bits):
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

    def _check_supported(self, hdr: dict) -> None:
        flags = hdr["flags"]
        if not flags & FLAG_SHARDED:
            raise NotImplementedError(
                "global-layout containers come with ROADMAP.md queue 1 "
                "item 6")
        if flags & FLAG_ADAPT:
            raise NotImplementedError(
                "adaptive containers come with ROADMAP.md queue 1 item 7")
        if hdr["entropy"] != ENTROPY_CANONICAL:
            raise NotImplementedError(
                "FGK containers come with ROADMAP.md queue 1 item 8")

    def _stage_step(self, blob: bytes, hdr: dict, c0: int, c1: int, S: int):
        """Host -> device transfer of one decode step: the step's dense
        payload words plus its manifest rows, zero-padded to S chunks."""
        nl = hdr["lane_words"].shape[1]
        offs = hdr["chunk_offs"]
        base = hdr["payload_off"] + int(offs[c0])
        nw = int(offs[c1] - offs[c0]) // 4
        flat = np.frombuffer(blob, ">u4", nw, base).astype(np.uint32)
        lw = np.zeros((S, nl), np.int32)
        lw[: c1 - c0] = hdr["lane_words"][c0:c1]
        tab = np.zeros((S, 256), np.uint8)
        tab[: c1 - c0] = hdr["tables"][c0:c1]
        rl = np.zeros(S, np.int32)
        rl[: c1 - c0] = hdr["rle_lens"][c0:c1]
        car = np.zeros(S, np.uint8)
        car[: c1 - c0] = hdr["carries"][c0:c1]
        dev = self.device
        return {"c0": c0, "c1": c1,
                "flat": torch.from_numpy(flat.view(np.int32)).to(dev),
                "lw": torch.from_numpy(lw).to(dev),
                "tables": torch.from_numpy(tab).to(dev),
                "rl": torch.from_numpy(rl).to(dev),
                "car": torch.from_numpy(car).to(dev)}

    def stage_decode_steps(self, blob: bytes, hdr: dict | None = None):
        """Parse, then start the host -> device transfer of every decode
        step without running any of its compute. Returns (hdr, staged)."""
        hdr = self._parse(blob) if hdr is None else hdr
        self._check_supported(hdr)
        n_chunks = hdr["n_chunks"]
        S = min(self.config.step_chunks or n_chunks, n_chunks)
        staged = [self._stage_step(blob, hdr, k * S,
                                   min(n_chunks, (k + 1) * S), S)
                  for k in range(_cdiv(n_chunks, S))] if n_chunks else []
        return hdr, staged

    def run_decode_steps(self, hdr: dict, staged: list):
        """Run the decode compute of staged steps; returns each step's
        (S * chunk_size,) uint8 device tensor without synchronising."""
        cs, lane = hdr["chunk_size"], hdr["lane"]
        use_diff = bool(hdr["flags"] & FLAG_DIFF)
        cap = _sharded_cap(cs, "canonical", lane)
        parts = []
        for st in staged:
            w = kernels.repad_words(st["flat"], st["lw"], hdr["wl_bucket"])
            chunks_rle = canonical_decode_batch(
                w, st["tables"], st["lw"], st["rl"], lane=lane, out_len=cap,
                max_len=hdr["max_len_bucket"])
            is_cnt = rle_classify(chunks_rle, st["rl"])
            out = kernels.rle_expand(chunks_rle, is_cnt, st["rl"], st["car"],
                                     cs, use_diff)
            parts.append(out.view(-1))
        return parts

    def decode_steps(self, blob: bytes, hdr: dict | None = None):
        """The sharded-layout decode as per-step device tensors, not yet
        copied back to the host."""
        hdr, staged = self.stage_decode_steps(blob, hdr)
        return self.run_decode_steps(hdr, staged)

    def decode_range(self, blob: bytes, start: int, length: int) -> bytes:
        """Random-access decode of ``[start, start + length)``: only the
        covering chunks are decoded, each from its manifest row and its
        stored diff carry."""
        hdr = self._parse(blob)
        self._check_supported(hdr)
        if start < 0 or length < 0 or start + length > hdr["orig"]:
            raise ValueError("range out of bounds")
        if length == 0:
            return b""
        cs = hdr["chunk_size"]
        c0, c1 = start // cs, (start + length - 1) // cs + 1
        step = self._stage_step(blob, hdr, c0, c1, c1 - c0)
        flat = self.run_decode_steps(hdr, [step])[0].cpu().numpy()
        lo = start - c0 * cs
        return flat[lo: lo + length].tobytes()

    def decode(self, blob: bytes) -> bytes:
        if blob[:6] != V3_MAGIC:
            raise NotImplementedError(
                "only v3 containers decode in this slice; v1 and v2 come "
                "with ROADMAP.md queue 1 item 6")
        hdr = self._parse(blob)
        if hdr["orig"] == 0:
            return b""
        parts = self.decode_steps(blob, hdr)
        flat = torch.cat(parts).cpu().numpy()
        result = flat[: hdr["orig"]].tobytes()
        if zlib.crc32(result) != hdr["crc"]:
            raise ValueError("v3 container integrity check failed (crc32)")
        return result

    @staticmethod
    def _parse(blob: bytes) -> dict:
        if len(blob) < 43 or blob[:6] != V3_MAGIC or blob[6] != 3:
            raise ValueError("invalid v3 container")
        flags = blob[7]
        entropy = blob[8]
        tblw = blob[9]  # canonical table bit width (4 or 5; 0 for fgk)
        kw = blob[10]  # lane-words manifest bit width (container max)
        orig, total, chunk_size, n_chunks, lane, crc = struct.unpack_from(
            "<QQIIII", blob, 11)
        pos = 43
        hdr = dict(flags=flags, entropy=entropy, orig=orig, total=total,
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
                tw = _tile_len_width(bs)
                hdr["tile_lens"] = np.frombuffer(blob, f"<u{tw}", nt,
                                                 pos).copy()
                pos += tw * nt
        if entropy != ENTROPY_CANONICAL:
            chunk_bits = np.frombuffer(blob, "<u4", n_chunks, pos).tolist()
            pos += 4 * n_chunks
        if flags & FLAG_SHARDED and n_chunks:
            rle_lens = np.frombuffer(blob, "<u4", n_chunks, pos).copy()
            pos += 4 * n_chunks
            carries = np.frombuffer(blob, np.uint8, n_chunks, pos).copy()
            pos += n_chunks
            hdr.update(rle_lens=rle_lens, carries=carries)
        if entropy == ENTROPY_CANONICAL and n_chunks:
            L = (_sharded_cap(chunk_size, "canonical", lane)
                 if flags & FLAG_SHARDED else chunk_size)
            tables = _unpackk(blob[pos:], n_chunks * 256, tblw).reshape(
                n_chunks, 256).astype(np.uint8)
            pos += (n_chunks * 256 * tblw + 7) // 8
            lpc = L // lane
            counts = TorchCodec._chunk_counts(
                (hdr["rle_lens"], None) if flags & FLAG_SHARDED else None,
                total, chunk_size, n_chunks)
            used = -(-counts // lane)
            n_entries = int(used.sum())
            entries = _unpackk(blob[pos:], n_entries, kw)
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
        hdr.update(
            chunk_bits=chunk_bits, payload_off=pos,
            chunk_offs=np.concatenate([
                np.zeros(1, np.int64),
                np.cumsum(np.asarray([(b + 7) // 8 for b in chunk_bits],
                                     dtype=np.int64)),
            ]),
        )
        return hdr
