"""launches_per_image.encode: CUDA kernels, copies and sets in the trace
that start inside encode requests, per encode request traced."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    n = len(run.trace.kind_spans("encode"))
    if not n:
        return None
    return len(run.trace.device_events("encode")) / n
