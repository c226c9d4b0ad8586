"""Kernel 1 (``bacam_paged_topk_stage1``, the paged BA-CAM scoring and
stage-1 top-k of decode rows) against its roofline, in percent: the
bytes its launches' shapes need (``yardstick.counts.stage1_bytes``) at
3.35 TB/s, over the kernel's device time in the trace.  Nothing to read
where the window launched it never."""

from yardstick.counts import H100_HBM_BYTES_PER_S

KERNEL = "bacam_paged_topk_stage1"


def read(rec):
    tr, launches = rec.get("trace"), rec.get("stage1_bytes")
    if not tr or not launches:
        return None
    dev_s = sum(s for n, s in tr["by_name"].items() if KERNEL in n)
    if dev_s <= 0:
        return None
    return 100.0 * sum(launches) / H100_HBM_BYTES_PER_S / dev_s
