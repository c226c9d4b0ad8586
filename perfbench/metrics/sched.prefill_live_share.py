"""Share of the positions the window's prefill steps computed that were
live prompt tokens: the window's ``prefill_tokens`` over its
``prefill_positions`` (``max_batch`` x the chunk's padded length, a
prefill tick).  Nothing to read where the program has no
``prefill_positions`` or the window prefilled nothing."""


def read(rec):
    c = rec["counters"]
    if not c.get("prefill_positions"):
        return None
    return c["prefill_tokens"] / c["prefill_positions"]
