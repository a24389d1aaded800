"""The port's codecs.

- ``chunked``   — TorchCodec: the v3 device container
- ``reference`` — V1Codec: the reference's v1 wire format on the device
"""

from huffman_codec_tpu_torch.models.chunked import CodecConfig, TorchCodec  # noqa: F401
from huffman_codec_tpu_torch.models.reference import V1Codec  # noqa: F401
