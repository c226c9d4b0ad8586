"""The whole step's share of the card's bf16 dense peak (989 TFLOP/s), in
percent: the FLOPs the window's tokens need (``yardstick.counts.
step_flops``: weight matmuls of every prefilled and decoded token, the
vocabulary head of every sampled token, the top-k V contextualization)
over the traced window's seconds."""

from yardstick.counts import H100_BF16_FLOPS, step_flops


def read(rec):
    c = rec["counters"]
    sampled = rec["loop_tokens"]
    decoded = sampled - rec["loop_first_tokens"]
    flops = step_flops(rec["model"], c["prefill_tokens"], decoded, sampled)
    if flops <= 0:
        return None
    return 100.0 * flops / (rec["loop_s"] * H100_BF16_FLOPS)
