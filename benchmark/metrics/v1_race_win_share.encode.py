"""v1_race_win_share.encode: the codec's ``v1 wins`` over its ``v1 races``
counters (races whose v1 blob was smaller than the v3 container), in
percent, over a trace run's window; None where no race ran."""


def read(run):
    st = run.stages.get("encode", {})
    races = st.get("v1 races")
    return 100.0 * st.get("v1 wins", 0) / races if races else None
