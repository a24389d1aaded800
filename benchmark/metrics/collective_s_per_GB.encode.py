"""collective_s_per_GB.encode: device time of the NCCL kernels in rank
0's trace inside encode requests, per GB of the traced encodes' input."""

GB = 1e9


def read(run):
    if run.trace is None:
        return None
    evs = run.trace.device_events(
        "encode", lambda cat, name: cat == "kernel" and "nccl" in name.lower())
    nb = run.traced_bytes.get("encode", 0)
    if not evs or not nb:
        return None
    return sum(e[1] for e in evs) / 1e6 / (nb / GB)
