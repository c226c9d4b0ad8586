"""Every output token the engine emitted inside the window, over the
window's seconds (host clock: a token counts when ``poll`` hands it
back)."""


def read(rec):
    return rec["tokens"] / rec["window_s"]
