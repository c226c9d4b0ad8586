"""Share of the window the host spent enqueuing ticks' device work,
waits on a full launch queue included: the seconds inside the program's
``engine.dispatch`` spans over the window.  Nothing to read without the
program's spans."""


def read(rec):
    prog = rec.get("program")
    if not prog:
        return None
    return sum(e - s for name, s, e, _, _ in prog["spans"]
               if name == "engine.dispatch" and e is not None) \
        / 1e9 / rec["loop_s"]
