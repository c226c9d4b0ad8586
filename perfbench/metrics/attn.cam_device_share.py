"""Share of the traced window's device-busy seconds spent on work the
CAM attention backend launched: the device seconds of records whose
launch fell inside an ``attn.cam.*`` program span (gather, score,
kernel 1, stage 1, stage 2, context; ``yardstick.program.attribute``)
over ``busy_s``.  Nothing to read without a device trace or without the
program's spans."""


def read(rec):
    tr = rec.get("trace")
    if not tr or "device_by_span" not in tr or tr["busy_s"] <= 0:
        return None
    return sum(s for name, s in tr["device_by_span"].items()
               if name.startswith("attn.cam.")) / tr["busy_s"]
