"""90th percentile, over every request submitted inside the window, of
the time from its submission to its first token; a request with no
first token at the window's end counts with its wait so far (host
clock)."""

from yardstick.stats import percentile


def read(rec):
    return percentile(rec["ttft_s"], 90)
