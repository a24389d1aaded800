"""fgk_encode_s_per_GB.encode: the device time of the FGK encode kernel
(fgk_encode_kernel) in the trace inside encode spans, per GB of the traced
encodes' input."""

GB = 1e9


def read(run):
    if run.trace is None:
        return None
    evs = run.trace.device_events(
        "encode",
        lambda cat, name: cat == "kernel" and "fgk_encode_kernel" in name)
    nb = run.traced_bytes.get("encode", 0)
    if not evs or not nb:
        return None
    return sum(e[1] for e in evs) / 1e6 / (nb / GB)
