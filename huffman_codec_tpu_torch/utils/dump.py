"""Debug dumps of the entropy coders' code tables / trees — the analogue
of the reference's ``HuffTree::print`` (huffman.cpp:130-132, 231-266),
which walks the live FGK tree printing every node's bit-prefix.

Two container families:

- v3 canonical: the per-chunk code-length tables ARE the container
  manifest; ``dump_v3_tables`` reads them with ``TorchCodec._parse`` (on
  the host; no device is needed), assigns each chunk's canonical codes
  (``ops/canonical.assign_codes``, RFC-1951-style first_code) and prints
  one line per present symbol.
- v1 (FGK): the tree is never serialized — it is replayed; ``dump_v1_tree``
  re-runs the pyref FGK update loop over the transformed stream and
  prints the FINAL tree in the reference's DFS order with bit prefixes.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from huffman_codec_tpu_torch.formats import (
    HUFF_HEADER_BYTES,
    parse_huff_header,
    unpack_bits_msb,
)
from huffman_codec_tpu_torch.models.chunked import TorchCodec
from huffman_codec_tpu_torch.models.entropy import has_tables
from huffman_codec_tpu_torch.ops.canonical import assign_codes
from huffman_codec_tpu_torch.pyref.fgk import FGKTree


def _printable(sym: int) -> str:
    return chr(sym) if 32 <= sym < 127 else "."


def dump_v3_tables(blob: bytes, out=None, max_chunks: int | None = None):
    """Print every chunk's canonical code table of a v3 container."""
    out = out or sys.stderr
    hdr = TorchCodec._parse(blob)
    if not has_tables(hdr["entropy"]):
        out.write("v3 container uses FGK entropy; per-chunk trees are "
                  "adaptive (replay with dump_v1_tree semantics)\n")
        return
    tables = hdr["tables"]
    n = len(tables) if max_chunks is None else min(max_chunks, len(tables))
    codes = assign_codes(torch.from_numpy(tables[:n].astype(np.int64)))
    for c in range(n):
        lens = tables[c]
        out.write(f"chunk {c}: {sum(1 for v in lens if v)} symbols\n")
        for sym in sorted(range(256), key=lambda s: (int(lens[s]), s)):
            ln = int(lens[sym])
            if ln:
                out.write(f"  0x{sym:02x} '{_printable(sym)}' len {ln:2d} "
                          f"code {int(codes[c, sym]):0{ln}b}\n")


def dump_v1_tree(blob: bytes, out=None, max_symbols: int = 1 << 15):
    """Replay the FGK coder over a v1 container's payload and print the
    final tree, DFS order with bit prefixes (huffman.cpp:231-266 shape).

    ``max_symbols`` caps the replay (pyref is a behavioral model, not a
    fast path); the tree after N updates is printed either way.
    """
    out = out or sys.stderr
    byte_count, _, _ = parse_huff_header(blob)
    bits = unpack_bits_msb(blob[HUFF_HEADER_BYTES:])
    tree = FGKTree()
    pos, decoded = 0, 0
    total = min(byte_count, max_symbols)
    while decoded < total and pos < len(bits):
        sym, pos = tree.decode(bits, pos)
        tree.update(sym)
        decoded += 1
    out.write(f"FGK tree after {decoded} symbols "
              f"({'complete' if decoded == byte_count else 'truncated'}"
              f" stream):\n")

    def dfs(k: int, prefix: str) -> None:
        if tree.is_leaf(k):
            s = tree.symbol[k]
            name = ("NYT" if k == tree.nyt else
                    f"0x{s:02x} '{_printable(s)}'")
            out.write(f"  {prefix or '(root)'} -> {name} "
                      f"freq {tree.freq[k]}\n")
            return
        if tree.left[k] >= 0:
            dfs(tree.left[k], prefix + "0")
        if tree.right[k] >= 0:
            dfs(tree.right[k], prefix + "1")

    dfs(0, "")
