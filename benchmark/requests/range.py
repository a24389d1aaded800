"""``range``: the server's ``decode_range`` of one of the mix's ranges of
the pool's first object, judged against those bytes of the object."""

from __future__ import annotations

from benchmark import reference


def pick(pool, i: int, turn: int) -> int:
    return i % len(pool.ranges)


def warm(ctx) -> None:
    s, m = ctx.pool.ranges[0]
    ctx.server.decode_range(ctx.blobs[0], s, m)


def serve(ctx, k: int):
    s, m = ctx.pool.ranges[k]
    out = ctx.server.decode_range(ctx.blobs[0], s, m)
    return out, len(out), {}


def judge(samples: dict, items: list, device) -> dict:
    total = 0
    for _, k, out in items:
        if isinstance(out, Exception):
            continue
        s, m = samples["ranges"][k]
        total += reference.judge_bytes(out, samples["objects"][0][s: s + m])
    return {"range_bad_bytes": total}
