"""Host C++ runtime of the v1 and v2 formats, bound with ctypes."""

from huffman_codec_tpu_torch.native.runtime import (  # noqa: F401
    NativeError,
    available,
    rle_decode,
    rle_encode,
    v1_compress,
    v1_decompress,
    v2_compress,
    v2_decompress,
)
