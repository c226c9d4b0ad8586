"""1 - device-busy / wall over the traced window: busy is the union of
the raw kineto device records' intervals inside the window."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / rec["loop_s"]
