"""Process start to the window's start: import, CUDA init, the weight
draw, the engine, the warm-up request and the first wave (host clock)."""


def read(rec):
    return rec["setup_s"]
