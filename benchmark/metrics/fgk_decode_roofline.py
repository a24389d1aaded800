"""fgk_decode_roofline: the FGK decode kernel's share of its roofline in
the traced decodes, in %: the least time the card could take, over the
trace's time of fgk_decode_kernel inside decode spans. The least time is
the larger of two: the bytes (each container's FGK payload read and its
RLE stream written, once each) over 3.35 TB/s, and 8 integer operations a
code bit over the card's INT32 rate. The counts are the decode spans' work
(``v3_fgk.sizes``: ``payload_bytes``, ``rle_bytes``, ``code_bits``).

8 a code bit is the count of ``chip_smoke.fgk_ops``: a code bit is one
tree level, which costs the code climb's parent load, edge compare and bit
store (3) and the update's level (4), a symbol's own costs at most one
more. The INT32 rate is ``chip_smoke.py``'s too: Hopper executes 64 INT32
operations a clock on each of the H100 SXM's 132 SMs, at its 1,980 MHz
maximum SM clock."""

from benchmark.core.peaks import HBM_BYTES_PER_S

OPS_PER_CODE_BIT = 8
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def read(run):
    if run.trace is None:
        return None
    evs = run.trace.device_events(
        "decode",
        lambda cat, name: cat == "kernel" and "fgk_decode_kernel" in name)
    t = sum(e[1] for e in evs) / 1e6
    spans = [s for s in run.extra.get("traced_spans", [])
             if s.kind == "decode"]
    bits = sum(s.work.get("code_bits", 0) for s in spans)
    nbytes = sum(s.work.get("payload_bytes", 0) + s.work.get("rle_bytes", 0)
                 for s in spans)
    if t <= 0 or bits <= 0:
        return None
    least = max(nbytes / HBM_BYTES_PER_S,
                OPS_PER_CODE_BIT * bits / INT32_OPS_PER_S)
    return 100.0 * least / t
