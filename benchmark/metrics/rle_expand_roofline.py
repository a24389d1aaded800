"""rle_expand_roofline: the MNP-5 decode kernel's share of its memory
roofline in the traced decodes: the RLE stream bytes read (the manifests'
rle_lens) and the decoded bytes written, once each, over 3.35 TB/s,
divided by the trace's time of rle_expand_kernel."""

from benchmark.core.readers import roofline_pct


def read(run):
    return roofline_pct(
        run, "decode", "rle_expand_kernel",
        lambda s: s.work.get("rle_bytes", 0) + s.work.get("out_bytes", 0))
