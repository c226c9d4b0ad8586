"""95th percentile of every gap between two consecutive output tokens of
one request, both inside the window, over all requests (host clock)."""

from yardstick.stats import percentile


def read(rec):
    p = percentile(rec["tpot_s"], 95)
    return None if p is None else p * 1e3
