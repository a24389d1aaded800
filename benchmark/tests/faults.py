"""Faults planted in the timed path for the tests that see ``correct``
come out false. Each is a function that patches the program in the
process it runs in; the mesh's ranks run them by name
(``module:function``)."""

from __future__ import annotations

import torch


def no_exchange() -> None:
    """The exchange between chips left out: every rank seeds its block's
    diff with 0 instead of the previous rank's last byte."""
    from huffman_codec_tpu_torch.parallel import mesh as M

    M._carry_in = lambda mesh, last: torch.zeros_like(last)


def half_decoded() -> None:
    """Half of the batch left out: the MNP-5 decode fills only the first
    half of the chunk rows it is given and leaves the rest zero."""
    from huffman_codec_tpu_torch.ops import kernels as K

    real = K.rle_expand

    def half(streams, lengths, carries, out_len, use_diff, out=None):
        got = real(streams, lengths, carries, out_len, use_diff, out=out)
        got.view(streams.shape[0], -1)[streams.shape[0] // 2:] = 0
        return got

    K.rle_expand = half


def rank_lost() -> None:
    """A rank other than the caller's dies before it joins the group."""
    import os

    if os.environ.get("LOCAL_RANK", "0") != "0":
        os._exit(3)
