"""fgk_side_by_side_share.encode: the codec's ``fgk steps side by side`` over
its ``fgk steps`` counters (the FGK sharded steps queued on a side stream
that held no earlier step of the request, over every FGK step run), in
percent, over a trace run's encodes; None where no ``fgk steps`` were
counted (a program without the counters)."""


def read(run):
    st = run.stages.get("encode", {})
    steps = st.get("fgk steps")
    if not steps:
        return None
    return 100.0 * st.get("fgk steps side by side", 0) / steps
