"""The port's device ops: plain tensor code and the CUDA kernel wrappers."""

from huffman_codec_tpu_torch.ops.diff import diff_apply, diff_revert  # noqa: F401
from huffman_codec_tpu_torch.ops.rle import (  # noqa: F401
    rle_decode,
    rle_encode,
    rle_encoded_size,
    rle_max_encoded_len,
)
