"""``decode``: the server's decode of the set-up's container of a pool
object, judged against the object's bytes."""

from __future__ import annotations

from benchmark import reference


def pick(pool, i: int, turn: int) -> int:
    return turn % len(pool.objects)


def warm(ctx) -> None:
    for b in ctx.blobs:
        ctx.server.decode(b)


def serve(ctx, k: int):
    out = ctx.server.decode(ctx.blobs[k])
    return out, len(out), ctx.sizes[k]


def judge(samples: dict, items: list, device) -> dict:
    return {"decode_bad_bytes": sum(
        reference.judge_bytes(out, samples["objects"][k])
        for _, k, out in items if not isinstance(out, Exception))}
