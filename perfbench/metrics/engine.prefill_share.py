"""Share of the traced window's wall time inside ``ServeEngine.poll``
calls during which ``prefill_ticks`` advanced (the harness's own host
spans)."""


def read(rec):
    return sum(b - a for lab, a, b in rec["spans"]
               if lab == "prefill poll") / rec["loop_s"]
