"""lane_decode_roofline: the canonical lane decode kernel's share of its
memory roofline in the traced decodes: the payload words read and the RLE
bytes written, once each, over 3.35 TB/s, divided by the trace's time of
lane_decode_kernel (not the whole-file kernel, lane_decode_lm)."""

from benchmark.core.readers import roofline_pct


def read(run):
    return roofline_pct(
        run, "decode", "lane_decode_kernel<",
        lambda s: s.work.get("payload_bytes", 0) + s.work.get("rle_bytes", 0))
