"""setup_s: process start to the first timed request: imports, the
builds on a checkout's first run, the traffic made from the seed, every
object encoded once, the warm-up."""


def read(run):
    return run.extra["info"]["setup_s"]
