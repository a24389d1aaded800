"""``TorchCodec`` of the port under the configuration's ``CodecConfig``
fields."""

from __future__ import annotations

CODEC_FIELDS = ("use_diff", "use_adapt", "width", "chunk_size", "entropy",
                "lane", "layout", "whole_file", "step_chunks")


def fields(config: dict) -> dict:
    """The configuration's ``CodecConfig`` fields."""
    return {k: config[k] for k in CODEC_FIELDS if k in config}


def build(config: dict, device):
    from huffman_codec_tpu_torch import CodecConfig, TorchCodec

    return TorchCodec(CodecConfig(**fields(config)), device=device)
