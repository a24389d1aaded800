"""V1Codec: the reference's v1 format on the device.

Writes the bytes of the upstream binary (and of the port's host runtime,
``native/runtime.v1_compress``): diff, then MNP-5 RLE or adaptive block
RLE (with its in-band header), then the whole transformed stream coded as
one FGK chunk (``kernels.fgk_encode`` at C = 1), after a 9-byte header.
The v1 format's single adaptive tree makes that a serial chain by
construction; ``TorchCodec`` is the fast path, this is the device path of
the reference's wire.

Decode runs on the device: the FGK decode, then in stream mode the MNP-5
decode and the diff revert of the one stream. An adaptive payload
interleaves its tile borders with the data, so finding them is a serial
walk: ``kernels.group_tile_lens`` with one group holding every tile, then
the tiles decode in parallel. The walk also yields what each tile's stream
decodes to, so a broken payload (a tile that overshoots its size, a stream
that ends inside a tile, bytes left over) raises the reference's error.
"""

from __future__ import annotations

import numpy as np
import torch

from huffman_codec_tpu_torch.formats import (
    HUFF_HEADER_BYTES,
    make_huff_header,
    parse_adapt_rle_header,
    parse_huff_header,
)
from huffman_codec_tpu_torch.models.chunked import (
    CodecConfig,
    _cdiv,
    _decode_adapt_tail,
    _decode_stream_tail,
)
from huffman_codec_tpu_torch.ops import kernels
from huffman_codec_tpu_torch.ops.adapt import (
    _tile_geom_arrays,
    adapt_encode_fixed,
    adapt_search_sizes,
    candidate_sizes,
)
from huffman_codec_tpu_torch.ops.diff import diff_apply
from huffman_codec_tpu_torch.ops.fgk import n_words_for
from huffman_codec_tpu_torch.ops.pack import bytes_to_words, chunk_bytes
from huffman_codec_tpu_torch.ops.rle import rle_encode, rle_max_encoded_len


# the reference's messages for a broken adaptive payload (exit codes 13,
# 14 and 15 of its command line)
_OVERSHOOT = "invalid adaptive block RLE file contents"
_SHORT = "unexpected end of adaptive block RLE data"
_LEFTOVER = "leftover data of adaptive block RLE detected"


class V1Codec:
    """Bit-exact v1 encode and decode on a CUDA device.

    ``config=None`` means ``CodecConfig()`` (its ``use_diff``,
    ``use_adapt`` and ``width`` apply). ``device=None`` means ``"cuda"``,
    and raises when no GPU is present; ``device="cpu"`` runs every
    kernel's plain PyTorch version instead."""

    def __init__(self, config: CodecConfig | None = None, device=None):
        self.config = config or CodecConfig()
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run "
                               "the plain PyTorch versions")

    def encode(self, data: bytes) -> bytes:
        cfg = self.config
        n = len(data)
        if cfg.use_adapt:
            if cfg.width <= 0:
                raise ValueError("invalid width of 2D data")
            if n % cfg.width:
                raise ValueError("invalid size of input 2D data")
        if n == 0:
            return make_huff_header(0, cfg.use_diff, cfg.use_adapt)
        x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(
            self.device)
        if cfg.use_diff:
            x = diff_apply(x)
        if cfg.use_adapt:
            w, h = cfg.width, n // cfg.width
            sizes = adapt_search_sizes(x, w, h).cpu().numpy()
            bs = candidate_sizes(w, h)[int(np.argmin(sizes))]
            stream, total, _, _ = adapt_encode_fixed(
                x, w, h, bs, out_len=rle_max_encoded_len(n) + 64)
        else:
            ln = torch.tensor([n], dtype=torch.int32, device=self.device)
            stream, total = rle_encode(x[None, :], ln, rle_max_encoded_len(n))
            stream = stream[0]
        total = int(total)
        words, bits = kernels.fgk_encode(
            stream[None, :total].contiguous(),
            torch.tensor([total], dtype=torch.int32, device=self.device),
            n_words_for(total))
        body = chunk_bytes(words, bits).cpu().numpy().tobytes()
        return make_huff_header(total, cfg.use_diff, cfg.use_adapt) + body

    def _fgk_stream(self, blob: bytes, count: int) -> torch.Tensor:
        """The FGK decode of a v1 payload: the transformed stream, (count,)
        uint8 on the device."""
        payload = np.frombuffer(blob, np.uint8, offset=HUFF_HEADER_BYTES)
        if 8 * len(payload) < count:  # a symbol costs at least one bit
            raise ValueError("invalid Huffman coding file contents")
        pt = torch.from_numpy(payload.copy()).to(self.device)
        words = bytes_to_words(pt, max(1, _cdiv(len(payload), 4)))
        cnt = torch.tensor([count], dtype=torch.int32, device=self.device)
        return kernels.fgk_decode(words[None, :], cnt, count)[0]

    def decode(self, blob: bytes, size_hint: int | None = None) -> bytes:
        count, use_diff, use_adapt = parse_huff_header(blob)
        if count == 0:
            return b""
        if use_adapt:
            return self._decode_adapt(blob, count, use_diff)
        stream = self._fgk_stream(blob, count)
        # a count byte (at most 255 more output bytes) follows three
        # literals, so count stream bytes decode to at most this many
        bound = size_hint or count + 255 * (count // 4)
        out, m = _decode_stream_tail(stream, count, bound, use_diff)
        return out[: int(m)].cpu().numpy().tobytes()

    def _decode_adapt(self, blob: bytes, count: int, use_diff: bool) -> bytes:
        """v1 adaptive decode: the FGK decode, the in-band header, the
        serial walk over the tile borders (the group walk kernel with one
        group of every tile) with the reference's checks of the payload,
        then the tiles decoded in parallel and put back, and the diff
        revert."""
        stream = self._fgk_stream(blob, count)
        w, h, bs, dirs, hdr_len = parse_adapt_rle_header(
            stream.cpu().numpy().tobytes())
        nt = _cdiv(w, bs) * _cdiv(h, bs)
        body = stream[hdr_len:count].clone()  # a fresh, aligned buffer
        total = body.shape[0]
        if nt == 0:
            if total:
                raise ValueError(_LEFTOVER)
            return b""
        if total == 0:
            raise ValueError(_SHORT)
        dev = self.device
        sizes = torch.from_numpy(_tile_geom_arrays(w, h, bs)).to(dev)
        tile_lens, decoded = kernels.group_tile_lens(
            body, torch.zeros(1, dtype=torch.int32, device=dev), sizes,
            total, total, with_decoded=True)
        # the reference's checks, tile after tile: a tile whose stream
        # decodes past its size, the tile the stream ends inside (only
        # the last one reached; every overshoot comes before it), bytes
        # left after the last tile
        over, short, left = torch.stack([
            (decoded > sizes).any(), (decoded < sizes).any(),
            tile_lens.sum() != total]).tolist()
        if over or short or left:
            raise ValueError(_OVERSHOOT if over else
                             _SHORT if short else _LEFTOVER)
        flat = _decode_adapt_tail(
            body, tile_lens,
            torch.from_numpy(np.asarray(dirs[:nt], bool)).to(dev), w, h, bs,
            use_diff)
        return flat[: w * h].cpu().numpy().tobytes()
