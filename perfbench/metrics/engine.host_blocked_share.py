"""Share of the traced window the host spent blocked on token readbacks
(``ServeEngine.blocked_s``)."""


def read(rec):
    return rec["counters"]["blocked_s"] / rec["loop_s"]
