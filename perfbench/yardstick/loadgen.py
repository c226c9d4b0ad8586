"""The load generator: closed-loop clients drawn from a traffic file.

A traffic file (``perfbench/traffic/<mix>.json``) gives

    loop            "closed": a client sends its next request when its
                    last one finishes (application workers that each
                    wait for a reply)
    clients         number of clients
    max_len         the engine's per-sequence length (prompt + output)
    prompt_len      {"dist": "log_uniform", "min", "max"} tokens
    output_len      the same for the tokens generated
    sampling        {"temperature": 0.0}: greedy
    check_clients   clients whose requests the correctness check records
                    (drawn from the seed)
    check_positions the most positions (prompt + output) the recorded
                    requests may reach together; a request that would
                    pass it is not recorded
    check_tokens    served tokens the correctness sample holds at least

Every client's first request (the first wave) is admitted and prefilled
in set-up and asks for a uniform fraction of its drawn output, so that
completions spread from the window's start.

Lengths are log-uniform, stratified round by round: the r-th requests
of the N clients take the middles of N equal slices of the log-length
range (and of [0, 1] for the first wave's fractions), paired into
(prompt, output) requests and handed to the clients in a fixed order.
Every seed gives the same sizes to the same clients; the seed draws
every token (and the benchmark's weights).  With a few multi-second
prefill ticks in a window, the order of the sizes decides most of a
window's numbers: drawn from the seed, it moved tokens/s by 35% between
seeds where two runs of one seed agreed within 1%.
Token ids are uniform over the vocabulary, drawn per request from
(seed, client, round).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

SEED_MASK = (1 << 63) - 1
PAIRING = 0x5EED  # fixes each round's (prompt, output) pairs


def _rng(*keys: int) -> np.random.Generator:
    return np.random.default_rng([int(k) & SEED_MASK for k in keys])


def _middles(n: int, pairing) -> np.ndarray:
    """The middles of the n slices [i/n, (i+1)/n) of [0, 1), in the
    order of the permutation drawn from ``pairing``."""
    return (pairing.permutation(n) + 0.5) / n


def draw_lengths(spec: dict, u: np.ndarray) -> np.ndarray:
    if spec.get("dist", "log_uniform") != "log_uniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lo, hi = math.log(spec["min"]), math.log(spec["max"] + 1)
    n = np.floor(np.exp(lo + u * (hi - lo))).astype(np.int64)
    return np.clip(n, spec["min"], spec["max"])


class Plan:
    """The requests of every client, drawn from the seed, round by round
    as the clients reach them."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        if traffic.get("loop", "closed") != "closed":
            raise ValueError(f"unknown loop {traffic['loop']!r}")
        if traffic["prompt_len"]["max"] + traffic["output_len"]["max"] \
                > traffic["max_len"]:
            raise ValueError("prompt_len.max + output_len.max > max_len")
        self.traffic = traffic
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.clients = int(traffic["clients"])
        self._rounds: List[Tuple[np.ndarray, np.ndarray]] = []
        order = _rng(self.seed, 4).permutation(self.clients)
        self.watched = {int(c) for c in order[:int(traffic["check_clients"])]}
        self.check_positions = int(traffic["check_positions"])

    def _round(self, r: int) -> Tuple[np.ndarray, np.ndarray]:
        while len(self._rounds) <= r:
            k = len(self._rounds)
            n = self.clients
            # the round's (prompt, output) pairs: the same for every seed
            pairing = _rng(PAIRING, k)
            p = draw_lengths(self.traffic["prompt_len"], _middles(n, pairing))
            o = draw_lengths(self.traffic["output_len"], _middles(n, pairing))
            if k == 0:  # the first wave: a fraction of the output
                frac = _middles(n, pairing)
                o = np.maximum(1, np.ceil(frac * o)).astype(np.int64)
            self._rounds.append((p, o))
        return self._rounds[r]

    def request(self, client: int, r: int) -> Tuple[List[int], int]:
        """(prompt token ids, tokens to generate) of client ``client``'s
        ``r``-th request."""
        p, o = self._round(r)
        rng = _rng(self.seed, 2, client, r)
        prompt = rng.integers(0, self.vocab, int(p[client])).tolist()
        return prompt, int(o[client])
