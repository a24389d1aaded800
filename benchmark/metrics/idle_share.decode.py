"""idle_share.decode: one less the union of the device's kernel, copy and set
intervals inside the decode requests' spans, over those spans (the method of
chip_smoke.busy_share), in percent."""

from benchmark.core.readers import idle_pct


def read(run):
    return idle_pct(run, "decode")
