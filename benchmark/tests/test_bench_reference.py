"""The plain reference against what the program writes on the CPU (the
plain versions of the kernels), for every mix at a small size: every
container, v1 blob and mesh step is judged sound, and a byte changed in
any of them is caught."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.codecs.torch_codec import fields
from benchmark.core import cells, traffic
from benchmark.reference import container
from benchmark.tests.conftest import SEED, small


def _pool(name):
    # images at their own size (256 KiB): cut smaller, every v3 container
    # would be small enough for the v1 race to win
    cell = cells.find_cell(name) if name == "global-m.images" else small(name)
    cfg = fields(cell.config)
    return cfg, traffic.build(cell.mix, SEED, cfg["chunk_size"])


@pytest.mark.parametrize("name", ["sharded-m.bulk", "global-m.images",
                                  "sharded-m.ranges"])
def test_reference_judges_the_ports_containers(name):
    from huffman_codec_tpu_torch import CodecConfig, TorchCodec

    cfg, pool = _pool(name)
    codec = TorchCodec(CodecConfig(**cfg), device="cpu")
    kinds = set()
    for x in pool.objects:
        blob = codec.encode(x.tobytes())
        got = reference.judge_encode(blob, x, cfg, "cpu")
        assert got["bad_bytes"] == 0 and got["bad_tables"] == 0, got
        kinds.add(got["v1"])
        bad = bytearray(blob)
        bad[len(bad) // 2] ^= 0x10
        assert reference.judge_encode(bytes(bad), x, cfg, "cpu")[
            "bad_bytes"] > 0
        y = x.copy()
        y[len(y) // 3] ^= 1
        assert reference.judge_encode(blob, y, cfg, "cpu")["bad_bytes"] > 0
    if name == "global-m.images":
        assert kinds == {0, 1}  # v3 containers and v1 blobs both met


@pytest.mark.parametrize("wrong", ["larger_candidate", "v1_unraced"])
def test_reference_holds_the_smallest_choice(wrong):
    """A global container that is not the smaller of the layout's two
    candidates, or a v1 blob where the race would not run (a v3 container
    over 64 KiB), is caught on every photo-like image of the mix."""
    from huffman_codec_tpu_torch import CodecConfig, TorchCodec
    from huffman_codec_tpu_torch.native import runtime

    cfg, pool = _pool("global-m.images")
    codec = TorchCodec(CodecConfig(**cfg), device="cpu")
    caught = 0
    for x in pool.objects:
        data = x.tobytes()
        if len(codec.encode(data)) <= reference.V1_RACE_MAX_OUT:
            continue  # a near-flat image: the race keeps v1
        if wrong == "larger_candidate":
            out = codec._encode_global(data, None, False)  # chunked
        else:
            out = runtime.v1_compress(data, cfg["use_diff"], False, 512)
        assert reference.judge_encode(out, x, cfg, "cpu")["bad_bytes"] > 0
        caught += 1
    assert caught >= 6


def test_reference_judges_mesh_columns():
    """The mesh's gathered columns at world 1 (gloo, in process)."""
    import torch.distributed as dist

    from benchmark.core.mesh import free_port
    from huffman_codec_tpu_torch.parallel import mesh as M

    cfg, pool = _pool("mesh4-m.bulk")
    cs, lane = cfg["chunk_size"], cfg["lane"]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = M.default_mesh(1, device="cpu")
        x = pool.objects[0]
        c = -(-len(x) // cs) + 1  # one empty chunk past the data
        buf = torch.zeros(c * cs, dtype=torch.uint8)
        buf[: len(x)] = torch.from_numpy(x)
        out = M.distributed_encode_step(buf, len(x), mesh, cs, 0, True,
                                        "canonical", lane)
    finally:
        dist.destroy_process_group()
    names = ("lane_buf", "lane_words", "tables", "rle_lens", "carries")
    cols = {n: t.numpy() for n, t in zip(names, out)}
    got = container.judge_columns(cols, x, cs, lane, True, "cpu")
    assert got == {"bad_bytes": 0, "bad_tables": 0}
    for key in names:
        bad = {k: v.copy() for k, v in cols.items()}
        flat = bad[key].reshape(-1)
        # a changed element inside what the step wrote
        i = int(np.flatnonzero(flat)[0]) if flat.any() else 0
        flat[i] = flat[i] + 1
        judged = container.judge_columns(bad, x, cs, lane, True, "cpu")
        assert judged["bad_bytes"] + judged["bad_tables"] > 0, key


def test_mnp5_rules():
    """The RLE's format rules on hand-made streams (pyref's docstring):
    516 x 'A' -> AAA 255 AAA 254 A, 'AAAA' -> AAA 0 A."""
    from benchmark.reference import stream

    def enc(b):
        x = torch.tensor(list(b), dtype=torch.uint8)
        s, n = stream.mnp5(x, torch.zeros(1, dtype=torch.int64))
        assert int(n[0]) == s.shape[0]
        return bytes(s.tolist())

    assert enc(b"A" * 516) == b"AAA\xffAAA\xfeA"
    assert enc(b"AAAA") == b"AAA\x00A"
    assert enc(b"AB") == b"AB"
    assert enc(b"A" * 258 + b"B") == b"AAA\xffB"
