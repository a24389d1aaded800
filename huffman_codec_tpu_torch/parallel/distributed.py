"""Process-group bootstrap on ``torch.distributed``, and elastic
re-dispatch.

Scaling the codec past one process needs two things, both here:

1. process-group bootstrap: ``init_distributed()`` wraps
   ``torch.distributed.init_process_group``, one process a rank, so that
   the step functions of ``parallel/mesh.py`` run as one SPMD program
   over the group (NCCL between cards, gloo on the CPU);
2. chunk-manifest recovery: chunks are self-contained, so a failed
   rank's chunk range can be re-encoded elsewhere. ``plan_chunk_ranges``
   computes the per-host assignment; ``missing_chunks`` diffs a partial
   manifest against the plan, the set a coordinator re-dispatches.

Launch on N cards of one host with ``torchrun --nproc_per_node=N``,
which sets the variables ``init_distributed`` reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

BACKENDS = ("nccl", "gloo")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device: str | torch.device | None = None,
                     backend: str | None = None) -> bool:
    """Initialise the ``torch.distributed`` process group when running as
    several processes.

    Arguments default to torchrun's variables: ``coordinator`` ("host:port")
    to MASTER_ADDR and MASTER_PORT, ``num_processes`` to WORLD_SIZE,
    ``process_id`` to RANK. Returns True if a multi-process group was
    initialised, False for a single process (nothing is initialised).

    The backend is the caller's: ``nccl`` for the card (the default, which
    needs a GPU and sets this process's device to
    ``cuda:{LOCAL_RANK % device_count}``, LOCAL_RANK defaulting to the
    rank, as ``mesh.default_mesh`` picks it), ``gloo`` when ``device="cpu"``
    or ``backend="gloo"`` is passed. Nothing tries one backend and takes
    another."""
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    nproc = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if not coordinator or nproc <= 1:
        return False
    cpu = device is not None and torch.device(device).type == "cpu"
    backend = backend or ("gloo" if cpu else "nccl")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    pid = process_id if process_id is not None else int(
        os.environ.get("RANK", "0"))
    if backend == "nccl":
        if cpu:
            raise ValueError("nccl runs on CUDA tensors; pass backend='gloo' "
                             "for device='cpu'")
        if not torch.cuda.is_available():
            raise RuntimeError("nccl needs a CUDA device; pass device='cpu' "
                               "to run on gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", pid))
                              % torch.cuda.device_count())
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=nproc,
        rank=pid)
    return True


@dataclass(frozen=True)
class ChunkRange:
    host: int
    start: int  # first chunk index (inclusive)
    stop: int  # last chunk index (exclusive)


def plan_chunk_ranges(n_chunks: int, n_hosts: int) -> list[ChunkRange]:
    """Contiguous balanced assignment of chunk indices to hosts."""
    base, extra = divmod(n_chunks, n_hosts)
    out, pos = [], 0
    for h in range(n_hosts):
        take = base + (1 if h < extra else 0)
        out.append(ChunkRange(h, pos, pos + take))
        pos += take
    return out


def missing_chunks(n_chunks: int, done: set[int]) -> list[int]:
    """Chunks not yet present in a partial manifest — the re-dispatch set
    after a host failure (chunks are independent, so recovery is a simple
    re-encode of this list on any surviving host)."""
    return [c for c in range(n_chunks) if c not in done]
