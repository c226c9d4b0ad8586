"""The plain reference against the program (``repro_torch``) at smoke
size on the CPU, in float32: end to end the reference's logits are the
program's, and step by step every compared number is at rounding."""

import time

import torch

from reference import model as R
from yardstick import cell, check


def _run(root, workload="nemo12b-cam.chat", seed=2**31 + 3):
    out = cell.run(workload, seed, 1.5, False, t_proc0=time.perf_counter(),
                   device="cpu", root=root)
    picked = check.sample(out["finished"], seed, 40)
    assert picked
    cap = out["capture"].states(
        [(rid, len(p) + len(s) - 1, len(s)) for rid, p, s in picked])
    return out, picked, cap


def test_reference_logits_equal_program(smoke_root):
    out, picked, cap = _run(smoke_root)
    m = out["cfg_numbers"]
    ref = R.served_logits(m, out["params"], [(p, s) for _, p, s in picked])
    for r, c in zip(ref, cap):
        got = c["logits"][:, :m["vocab"]]
        torch.testing.assert_close(r, got, atol=2e-5, rtol=2e-5)
        assert torch.equal(r.argmax(dim=1), got.argmax(dim=1))


def test_step_by_step_numbers_at_rounding(smoke_root):
    for workload in ("nemo12b-cam.rag", "bertl-cam.rag"):
        out, picked, cap = _run(smoke_root, workload)
        got = check.program_numbers(out["cfg_numbers"], out["params"],
                                    picked, cap)
        assert got["embed_err"] == 0.0 and got["argmax_miss"] == 0
        assert got["decode_rows"] > 0
        for name in ("attn_err_prefill", "attn_err_decode",
                     "rest_err_prefill", "rest_err_decode", "head_err_max"):
            assert got[name] < 1e-5, (workload, name, got[name])


def test_two_stage_topk_ties_to_lowest_index():
    """Stage 1 keeps the top 2 of each group of 4 keys, stage 2 the top
    k of those; equal scores go to the lower key index."""
    m = {"group_size": 4, "stage1_k": 2, "k_top": 2}
    d = 32
    # one query and 8 keys; the query is all +1, so a key's score is its
    # count of positive entries minus its count of negative ones
    q = torch.ones(1, 8, d)
    plus = [4, 8, 8, 2, 8, 6, 8, 0]  # positive entries of each key
    k = torch.stack([torch.cat([torch.ones(n), -torch.ones(d - n)])
                     for n in plus])[None]
    v = torch.eye(8)[None].repeat(1, 1, 4)[..., :d]
    out = R.camformer_attention(q, k, v, prompt_len=8, m=m)
    # last query sees all 8 keys: groups {0..3}, {4..7}; stage 1 keeps
    # keys 1, 2 (tie at 8 -> lower) and 4, 6; stage 2 keeps 1 and 2
    weights = out[0, -1, :8]
    assert set(torch.nonzero(weights > 0).flatten().tolist()) == {1, 2}
