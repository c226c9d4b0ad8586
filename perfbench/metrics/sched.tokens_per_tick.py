"""Output tokens emitted in the traced window per decode tick dispatched
in it (``ServeEngine.ticks``)."""


def read(rec):
    ticks = rec["counters"]["ticks"]
    if ticks <= 0:
        return None
    return rec["loop_tokens"] / ticks
