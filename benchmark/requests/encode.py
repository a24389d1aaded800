"""``encode``: the server's encode of a pool object, judged container by
container (or v1 blob) against the plain reference."""

from __future__ import annotations

from benchmark import reference


def pick(pool, i: int, turn: int) -> int:
    return turn % len(pool.objects)


def warm(ctx) -> None:
    """Nothing more: the set-up has encoded every object once."""


def serve(ctx, k: int):
    return ctx.server.encode(ctx.objs[k]), len(ctx.objs[k]), {}


def judge(samples: dict, items: list, device) -> dict:
    bad = {"encode_bad_bytes": 0, "encode_bad_tables": 0}
    for _, k, out in items:
        if isinstance(out, Exception):
            continue
        got = reference.judge_encode(out, samples["objects"][k],
                                     samples["config"], device)
        bad["encode_bad_bytes"] += got["bad_bytes"]
        bad["encode_bad_tables"] += got["bad_tables"]
    return bad
