"""The plain reference of the v1 format (the reference binary's own), which
the global layout's encode returns where it is strictly smaller than the
v3 container (the v1 race): ``[byteCount u64 LE][flags u8][FGK bits,
MSB first, zero padded]``, byteCount the RLE'd symbol count, flags bit 7
the diff model. The input is diffed and RLE'd as one stream
(``stream``), then FGK-coded (``fgk``, a frozen copy of the port's
pure-Python model)."""

from __future__ import annotations

import struct

import numpy as np
import torch

from benchmark.reference import stream
from benchmark.reference.fgk import fgk_encode

FLAG_DIFF = 0x80


def v1_blob(data: np.ndarray, use_diff: bool) -> bytes:
    """The v1 blob of ``data``, built from the input alone."""
    x = torch.from_numpy(np.ascontiguousarray(data))
    y = stream.diff(x) if use_diff else x
    sym, _ = stream.mnp5(y, torch.zeros(1, dtype=torch.int64))
    syms = sym.numpy().tobytes()
    bits = np.asarray(fgk_encode(syms), np.uint8)
    return (struct.pack("<QB", len(syms), FLAG_DIFF if use_diff else 0)
            + np.packbits(bits).tobytes())
