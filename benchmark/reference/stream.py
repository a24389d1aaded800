"""The transforms of the v3 container in plain PyTorch, written from the
format's rules and not from the program: the diff model and MNP-5 RLE.

Diff model: ``y[i] = x[i] - x[i-1]`` mod 256, ``x[-1] = 0``. Where the
sharded layout restarts the RLE at every chunk it seeds each chunk's diff
with the byte before it, so the diffed bytes are the whole input's.

MNP-5 RLE, per stream (a chunk in the sharded layout, the whole input in
the global one): cut the stream into maximal runs of one byte, and cut off
the stream's last byte as a run of its own (it is always a fresh literal).
A run of N bytes of value v is ``N // 258`` blocks ``v v v 255``, then for
the rest r = N % 258 either ``v v v (r - 3)`` (r >= 3) or r literals.
"""

from __future__ import annotations

import torch

RESET = 258  # 255, the largest count byte, plus 3 literals


def diff(x: torch.Tensor) -> torch.Tensor:
    """The diff model over the whole of ``x`` (uint8, 1-d)."""
    prev = torch.cat([x.new_zeros(1), x[:-1]])
    return x - prev  # uint8 arithmetic wraps mod 256


def mnp5(y: torch.Tensor, starts: torch.Tensor):
    """MNP-5 RLE of the streams of ``y`` (uint8, 1-d) that begin at
    ``starts`` (int64, ascending, ``starts[0] == 0``), each running to the
    next start (the last to the end). Returns (the encoded streams one
    after the other, uint8; each stream's encoded length, int64)."""
    n = y.shape[0]
    dev = y.device
    ends = torch.cat([starts[1:], torch.tensor([n], device=dev)])
    brk = torch.ones(n, dtype=torch.bool, device=dev)
    brk[1:] = y[1:] != y[:-1]
    brk[starts] = True
    brk[ends - 1] = True  # the last byte of a stream is a run of its own
    seg = torch.nonzero(brk).view(-1)
    seg_len = torch.diff(seg, append=torch.tensor([n], device=dev))
    q, r = seg_len // RESET, seg_len % RESET
    emit = q * 4 + torch.where(r >= 3, 4, r)
    seg_stream = torch.searchsorted(starts, seg, right=True) - 1
    lens = torch.zeros(starts.shape[0], dtype=torch.int64, device=dev)
    lens.scatter_add_(0, seg_stream, emit)
    of = torch.repeat_interleave(torch.arange(seg.shape[0], device=dev),
                                 emit)
    k = (torch.arange(of.shape[0], device=dev)
         - torch.repeat_interleave(torch.cumsum(emit, 0) - emit, emit))
    block, j = k // 4, k % 4
    v = y[seg][of]
    tail = block >= q[of]
    count = torch.where(tail, r[of] - 3, 255).to(torch.uint8)
    return torch.where(j < 3, v, count), lens
