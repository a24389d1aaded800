"""Data-parallel codec steps over a ``torch.distributed`` process group.

The input byte stream is cut into fixed-size chunks, and chunks are the
unit of data parallelism: one process a rank, each running the port's
own stage functions (and so its kernels) on its contiguous block of
chunks, ``[r * C / W, (r + 1) * C / W)`` in rank order. Per chunk the
whole pipeline (diff model, MNP-5 RLE, entropy coding, bit packing) is
independent, except the diff model's first byte, which needs the last
input byte of the previous chunk. That byte crosses ranks through one
``all_gather`` of every rank's last byte (W bytes): rank r takes rank
r - 1's, rank 0 takes 0. The per-chunk manifests are assembled with
``all_gather`` in rank order and the adaptive search's scores summed with
``all_reduce``. Every rank returns the gathered outputs, replicated.

The step functions keep the JAX package's names, arguments and return
tuples (``huffman_codec_tpu/parallel/mesh.py``), with what its mesh
functions do included: without the diff model the stream encode returns
zero carries; the adaptive encode always returns the real ones; the
search diffs every rank's block with a zero seed, so its scores depend
on the world size. The arguments are the global arrays, on any device:
each rank moves only its own rows to its device. The outputs of the
encodes are the v3 sharded manifest columns, so a container assembled
from them is byte-equal to ``TorchCodec``'s (with the diff model on).
The decodes take the lanes padded as the encodes return them, not the
dense wire payload. A decoded chunk is zero past its decoded length,
where the JAX package's repeats its last byte (with the diff model on).
What the entropy mode decides (the padded row cap, the entropy encode and
decode) is asked of its coder (``models/entropy.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from huffman_codec_tpu_torch.models.chunked import (
    decode_sharded_adapt_tail,
    encode_sharded_adapt_stage,
    encode_sharded_stage,
)
from huffman_codec_tpu_torch.models.entropy import CANONICAL, lookup
from huffman_codec_tpu_torch.ops import kernels
from huffman_codec_tpu_torch.ops.adapt import _adapt_score_v3, candidate_sizes
from huffman_codec_tpu_torch.ops.diff import diff_apply


@dataclass(frozen=True)
class Mesh:
    """One axis of ranks: the process group, this rank, the world size
    and this rank's device."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = "dp"


def default_mesh(n_devices: int | None = None, axis: str = "dp",
                 device: str | torch.device | None = None) -> Mesh:
    """The mesh of the initialised process group, every rank of it.
    ``n_devices``, if given, must be its size. The device is
    ``cuda:{LOCAL_RANK % device_count}`` (LOCAL_RANK defaulting to the
    rank) unless the caller names one; a CUDA device without a GPU
    raises, and so does a CPU device on an NCCL group."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() or "
                           "torch.distributed.init_process_group() first")
    group = dist.group.WORLD
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"the process group has {size} ranks, not "
                         f"{n_devices}")
    backend = dist.get_backend(group)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' on a gloo "
                               "group")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
    elif backend == "nccl":
        raise ValueError(f"an nccl group cannot run on {dev}")
    return Mesh(group, rank, size, dev, backend, axis)


def _block(mesh: Mesh, n: int, what: str) -> tuple[int, int]:
    """This rank's rows [lo, hi) of ``n``, which must divide by the world
    size (as ``shard_map`` requires)."""
    if n % mesh.size:
        raise ValueError(f"{n} {what} do not divide over {mesh.size} ranks")
    k = n // mesh.size
    return mesh.rank * k, (mesh.rank + 1) * k


def _local(x: torch.Tensor, lo: int, hi: int, mesh: Mesh) -> torch.Tensor:
    """Rows [lo, hi) of ``x`` on this rank's device, contiguous and
    16-byte aligned as the kernels take them (a copy only where a row
    slice on the device is not)."""
    t = x[lo:hi].to(mesh.device)
    if not t.is_contiguous() or (t.is_cuda and t.data_ptr() % 16):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _gather(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all) concatenated on dim 0 in rank
    order."""
    x = x.contiguous()
    out = torch.empty((mesh.size * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


def _carry_in(mesh: Mesh, last: torch.Tensor) -> torch.Tensor:
    """(1,) uint8: the last input byte of the previous rank's block, 0 on
    rank 0, from one all-gather of every rank's ``last`` byte."""
    prev = _gather(mesh, last)
    return (prev[mesh.rank - 1:mesh.rank] if mesh.rank
            else torch.zeros_like(last))


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")


def distributed_encode_step(data: torch.Tensor, length, mesh: Mesh,
                            chunk_size: int, n_words: int,
                            use_diff: bool = True, entropy: str = "fgk",
                            lane: int = 512, axis: str = "dp"):
    """One sharded encode step over the mesh.

    ``data`` is uint8[n_chunks * chunk_size] (padded), ``length`` the true
    byte count (an int or a 0-d tensor); n_chunks must divide by the world
    size. Each rank's chunk lengths are clipped from ``length`` at the
    chunks' global indices, so a tail chunk and the empty chunks after it
    fall on whichever rank holds them. Returns the replicated v3 sharded
    manifest columns: canonical -> (lane_buf (C, n_lanes, W), lane_words
    (C, n_lanes), tables, rle_lens, carries); fgk -> (words (C, n_words),
    bits (C,), None, rle_lens, carries). ``n_words`` only applies to fgk.
    Without the diff model the carries are zero."""
    _check_axis(mesh, axis)
    c0, c1 = _block(mesh, data.shape[0] // chunk_size, "chunks")
    local = _local(data, c0 * chunk_size, c1 * chunk_size, mesh)
    carry0 = _carry_in(mesh, local[-1:]) if use_diff else 0
    a, meta, tables, rle_lens, carries = encode_sharded_stage(
        local, length - c0 * chunk_size, carry0, use_diff, chunk_size,
        c1 - c0, lane, lookup(entropy), n_words)
    if not use_diff:
        carries = torch.zeros_like(carries)
    return tuple(None if x is None else _gather(mesh, x)
                 for x in (a, meta, tables, rle_lens, carries))


def distributed_adapt_search(data: torch.Tensor, mesh: Mesh, width: int,
                             band_h: int, use_diff: bool = True,
                             axis: str = "dp") -> torch.Tensor:
    """Distributed block-size search: every rank scores each candidate on
    its bands (``_adapt_score_v3`` on its block as one matrix, diffed with
    a zero seed), and the scores are summed over the ranks with one
    ``all_reduce``. Returns int32[n_candidates], replicated; pair with
    ``candidate_sizes(width, band_h)``, the first minimum winning."""
    _check_axis(mesh, axis)
    cs = band_h * width
    b0, b1 = _block(mesh, data.shape[0] // cs, "bands")
    local = _local(data, b0 * cs, b1 * cs, mesh)
    x = diff_apply(local) if use_diff else local
    rows = local.shape[0] // width
    scores = torch.stack([_adapt_score_v3(x, width, rows, b)
                          for b in candidate_sizes(width, band_h)])
    dist.all_reduce(scores, group=mesh.group)
    return scores.to(torch.int32)


def distributed_adapt_encode_step(data: torch.Tensor, mesh: Mesh,
                                  width: int, band_h: int, bs: int,
                                  use_diff: bool = True,
                                  entropy: str = "canonical",
                                  lane: int = 512, axis: str = "dp"):
    """Sharded-adaptive encode over the mesh: bands of ``band_h`` full
    matrix rows are the data-parallel unit (``_encode_sharded_adapt_stage``
    on each rank's bands, one block size for all). ``data`` must be
    n_bands * band_h * width bytes with n_bands divisible by the world
    size; the entropy coding is canonical (``entropy`` only sizes the
    rows, as in the JAX package). Returns replicated (lane_buf,
    lane_words, tables, stream_lens, dirs, tile_lens, carries), the
    carries whether or not the diff model is on."""
    _check_axis(mesh, axis)
    cs = band_h * width
    b0, b1 = _block(mesh, data.shape[0] // cs, "bands")
    bands = _local(data, b0 * cs, b1 * cs, mesh).view(b1 - b0, cs)
    carries = torch.cat([_carry_in(mesh, bands[-1, -1:]), bands[:-1, -1]])
    outs = encode_sharded_adapt_stage(
        bands, carries, use_diff, width, band_h, bs,
        lookup(entropy).cap(cs, lane), lane)
    return tuple(_gather(mesh, x) for x in (*outs, carries))


def distributed_adapt_decode_step(words: torch.Tensor,
                                  stream_lens: torch.Tensor,
                                  tile_lens: torch.Tensor,
                                  dirs: torch.Tensor, carries: torch.Tensor,
                                  tables: torch.Tensor,
                                  lane_words: torch.Tensor, mesh: Mesh,
                                  width: int, band_h: int, bs: int,
                                  use_diff: bool = True, lane: int = 512,
                                  axis: str = "dp") -> torch.Tensor:
    """Inverse of ``distributed_adapt_encode_step``: per-band canonical
    decode, tile decode from the manifest and diff revert on each rank's
    bands, then one ``all_gather`` of the rows. ``words`` is the padded
    fixed-stride lane layout (n_bands, n_lanes * Wl). Returns the matrix
    flat, uint8."""
    _check_axis(mesh, axis)
    b0, b1 = _block(mesh, words.shape[0], "bands")
    w, sl, tab, lw = (_local(x, b0, b1, mesh)
                      for x in (words, stream_lens.to(torch.int32), tables,
                                lane_words))
    streams = CANONICAL.decode_rows(w, sl, CANONICAL.cap(band_h * width, lane),
                                    lane, tab, lw)
    out = decode_sharded_adapt_tail(
        streams, _local(tile_lens, b0, b1, mesh),
        _local(dirs, b0, b1, mesh).to(torch.bool),
        _local(carries, b0, b1, mesh), width, band_h, bs, use_diff)
    return _gather(mesh, out)


def distributed_decode_step(words: torch.Tensor, rle_lens: torch.Tensor,
                            carries: torch.Tensor, mesh: Mesh,
                            chunk_size: int,
                            tables: torch.Tensor | None = None,
                            lane_words: torch.Tensor | None = None,
                            use_diff: bool = True, entropy: str = "fgk",
                            lane: int = 512,
                            axis: str = "dp") -> torch.Tensor:
    """Inverse of ``distributed_encode_step``: per-chunk entropy decode
    (canonical lanes, ``words`` as (C, n_lanes * W); or FGK word rows),
    then the MNP-5 decode with the diff revert seeded by the manifest's
    carries (``rle_expand``), on each rank's chunks; one ``all_gather``
    assembles them. Returns uint8[n_chunks * chunk_size], zero past each
    chunk's decoded length."""
    _check_axis(mesh, axis)
    ent = lookup(entropy)
    c0, c1 = _block(mesh, words.shape[0], "chunks")
    w, rl, car = (_local(x, c0, c1, mesh)
                  for x in (words, rle_lens.to(torch.int32), carries))
    streams = ent.decode_rows(
        w, rl, ent.cap(chunk_size, lane), lane,
        *(None if x is None else _local(x, c0, c1, mesh)
          for x in (tables, lane_words)))
    out = kernels.rle_expand(streams, rl, car, chunk_size, use_diff)
    return _gather(mesh, out).view(-1)
