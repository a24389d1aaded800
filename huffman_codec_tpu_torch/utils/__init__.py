"""Profiling and tracing, structured metrics, and the entropy coders'
debug dumps."""

from huffman_codec_tpu_torch.utils.metrics import CodecMetrics  # noqa: F401
from huffman_codec_tpu_torch.utils.profiling import (  # noqa: F401
    StageTimer,
    device_time,
    device_trace,
)
