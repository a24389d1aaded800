"""Multi-GPU execution: data parallelism over a ``torch.distributed``
process group, one process a rank.

Independent chunks shard across the ranks, each running the port's
kernels on its block; the diff model's one-byte boundary carry and the
per-chunk manifests ride ``all_gather``, the adaptive search's scores
``all_reduce`` (NCCL between cards, gloo on the CPU).
"""

from huffman_codec_tpu_torch.parallel.mesh import (  # noqa: F401
    default_mesh,
    distributed_decode_step,
    distributed_encode_step,
)
