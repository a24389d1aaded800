"""The comparison that decides ``correct``: every sampled answer of the
window judged by the plain reference (``benchmark/reference``) once the
window has closed and the program's state is freed.

Each number compared is an exact count, so each limit is 0: a byte of a
container, a manifest or a decoded answer that differs from the
reference's, a chunk whose code lengths are not an optimal complete code
of the reference's histogram, a request that raised.
"""

from __future__ import annotations

from benchmark import requests

LIMIT = 0


def judge_single(samples: dict, failed: int, device) -> dict:
    """{check name: (value, limit)} for a one-chip run's samples, each
    request kind's answers judged by its module (``benchmark/requests``)."""
    checks = {"failed_requests": failed}
    for kind, items in samples["results"].items():
        checks.update(requests.find(kind).judge(samples, items, device))
    return {k: (int(v), LIMIT) for k, v in checks.items()}


def sampled(samples: dict) -> dict:
    """How many answers of each kind were judged."""
    return {k: len(v) for k, v in samples["results"].items()}


def correct(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


def as_line(checks: dict) -> dict:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
