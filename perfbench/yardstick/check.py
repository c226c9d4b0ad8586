"""The comparison that decides ``correct``.

Once the window has closed and the engine is freed, a sample of the
requests the engine finished is drawn from the seed: the one with
the most served tokens, then others in an order drawn from the seed
until the sample holds the mix's ``check_tokens`` served tokens.  The
program's state of those requests, recorded from the timed path
(``capture``), is held against the plain reference
(``perfbench/reference/model.py``, float32) step by step:

* ``embed_err``: the rows entering layer 0 against the reference's
  embedding of prompt + served[:-1]: exact (limit 0);
* ``attn_err_prefill`` / ``attn_err_decode``: every layer's CAMformer
  attention, run by the reference on the program's input rows (q, k and
  v, the binarization, the scores, both top-k stages, the running key
  scale and the softmax over the survivors all rebuilt from them): the
  distance of each head's output row from the program's, over the
  length of the program's; within each layer the 75th percentile over
  the prompt's rows (filled by prefill ticks) and heads, apart from the
  rows of served tokens (decode ticks), and the largest over the layers;
* ``rest_err_prefill`` / ``rest_err_decode``: the rest of every layer
  (W_o, the residual add, the FFN's norm and SwiGLU), run by the
  reference on the program's input rows and attention output: the
  distance of its update from the program's over the length of the
  program's; within each layer the 90th percentile, the largest over
  the layers, prefill and decode rows apart;
* ``head_err_max``: the final norm and vocabulary head run by the
  reference on the program's last rows, against the program's logits
  at every served position: the largest relative distance;
* ``argmax_miss``: served tokens that are not the best of the program's
  own logits (greedy serving): exact (limit 0).

A percentile stands where the widest reading cannot: a sign that
rounding flips near zero changes a selection and so a head's output by
a large share of its length, at some positions in every run, in the
program and in the control alike; most in the first layer, whose input
rows are the embeddings (PERF.md: there the program's 90th percentile
reads 0.3, 40% of the float8 control's, so attention takes the 75th).
Taken a layer at a time and for each kind of tick apart, a fault in
one layer or in decode ticks alone reaches it.

The control (``control_numbers``) is the reference computed in float8
e4m3, the step below the configuration's bfloat16, put in the
program's place: its own state over the same prompts and tokens,
judged the same way, serving at each position the token it puts
first.
"""

from __future__ import annotations

import numpy as np
import torch

from yardstick import loadgen


def sample(finished, seed: int, target_tokens: int) -> list:
    """(rid, prompt, served) of the request with the most served tokens,
    then others in a seeded order until ``target_tokens`` are held."""
    done = [f[:3] for f in finished if len(f[2]) > 0]
    if not done:
        return []
    first = max(range(len(done)), key=lambda i: (len(done[i][2]), -i))
    rest = [i for i in range(len(done)) if i != first]
    order = loadgen._rng(seed, 3).permutation(len(rest)) if rest else []
    pick = [done[first]]
    held = len(done[first][2])
    for j in order:
        if held >= target_tokens:
            break
        pick.append(done[rest[j]])
        held += len(done[rest[j]][2])
    return pick


def _rel(a, b, dim=-1):
    """|a - b| / |b| along ``dim`` (float64 on the host)."""
    return ((a - b).norm(dim=dim)
            / b.norm(dim=dim).clamp(min=1e-30)).double().cpu()


ATTN_Q = 75  # the percentiles taken within a layer
REST_Q = 90
DIAG_Q = (50, 75, 90, 95, 99, 100)  # calibration's view of the others


def _decode_rows(spans, n: int) -> torch.Tensor:
    """Mask over the ``n`` rows of ``spans_of``: the rows of served
    tokens, which decode ticks fill; the rest are the prompts'."""
    dec = torch.zeros(n, dtype=torch.bool)
    for s0, t, plen in spans:
        dec[s0 + plen:s0 + t] = True
    return dec


def _worst_layer(errs, rows, q):
    """The largest over layers of the ``q``-th percentile of a layer's
    errors (``errs``: a tensor (N, k) a layer) at ``rows``; None where
    ``rows`` holds none."""
    if not bool(rows.any()):
        return None
    return max(float(np.percentile(e[rows].numpy(), q)) for e in errs)


def numbers(m: dict, params: dict, requests, xs, os_, logits, served,
            diag: bool = False):
    """The compared numbers of a model's own state over ``requests``:
    ``xs`` the rows entering every layer and leaving the last
    ((n_layers + 1) tensors (N, d)), ``os_`` every layer's attention
    output before W_o (n_layers tensors (N, H * D)), ``logits`` its
    vocabulary logits at the served positions (n, V) and ``served`` the
    tokens it served there.  ``diag`` adds the calibration's view:
    other percentiles and each layer's."""
    from reference import model as R

    ids, spans = R.spans_of(requests)
    x0 = R.embed(params, ids)
    embed_err = float((xs[0].to(torch.float32) - x0).abs().max())
    attn, rest = [], []
    h, hd = m["n_heads"], m["head_dim"]
    for li, p in enumerate(params["blocks"]):
        xin = xs[li].to(torch.float32)
        o = os_[li].to(torch.float32)
        o_ref = R.attention(p, xin, spans, m, "fp32")
        n = o.shape[0]
        attn.append(_rel(o_ref.reshape(n, h, hd), o.reshape(n, h, hd)))
        out = xs[li + 1].to(torch.float32)
        y = R.after_attention(p, xin, o, "fp32")
        rest.append(_rel(y - xin, out - xin)[:, None])
    dec = _decode_rows(spans, len(ids))
    rows = R.served_rows(spans).to(x0.device)
    lg = logits.to(torch.float32)[:, :m["vocab"]]
    ref = R.head_logits(params, xs[-1][rows].to(torch.float32), m, "fp32")
    tok = torch.as_tensor(served, dtype=torch.long, device=lg.device)
    head = _rel(ref, lg)
    got = dict(
        embed_err=embed_err,
        attn_err_prefill=_worst_layer(attn, ~dec, ATTN_Q),
        attn_err_decode=_worst_layer(attn, dec, ATTN_Q),
        rest_err_prefill=_worst_layer(rest, ~dec, REST_Q),
        rest_err_decode=_worst_layer(rest, dec, REST_Q),
        head_err_max=float(head.max()),
        argmax_miss=int((lg.argmax(dim=1) != tok).sum()),
        decode_rows=int(dec.sum()))
    if diag:
        d = {}
        for stage, errs in (("attn", attn), ("rest", rest)):
            for kind, sel in (("prefill", ~dec), ("decode", dec)):
                for q in DIAG_Q:
                    d[f"{stage}_{kind}_q{q}"] = _worst_layer(errs, sel, q)
                if bool(sel.any()):
                    d[f"{stage}_{kind}_layers_q90"] = [
                        float(np.percentile(e[sel].numpy(), 90))
                        for e in errs]
        for q in DIAG_Q:
            d[f"head_q{q}"] = float(np.percentile(head.numpy(), q))
        got["diag"] = d
    return got


def program_numbers(m, params, picked, captured, diag=False):
    """``numbers`` of the program's recorded state of ``picked``."""
    reqs = [(p, s) for _, p, s in picked]
    xs = [torch.cat([c["x"][li] for c in captured])
          for li in range(captured[0]["x"].shape[0])]
    os_ = [torch.cat([c["o"][li] for c in captured])
           for li in range(captured[0]["o"].shape[0])]
    logits = torch.cat([c["logits"] for c in captured])
    return numbers(m, params, reqs, xs, os_, logits,
                   [t for _, s in reqs for t in s], diag)


def control_numbers(m, params, picked, diag=False):
    """``numbers`` of the float8 control over the same prompts and
    tokens, the token it serves at each position the one it puts
    first."""
    from reference import model as R

    reqs = [(p, s) for _, p, s in picked]
    xs, os_ = R.hidden_states(m, params, reqs, "fp8")
    _, spans = R.spans_of(reqs)
    rows = R.served_rows(spans).to(xs[-1].device)
    logits = R.head_logits(params, xs[-1][rows], m, "fp8")
    return numbers(m, params, reqs, xs, os_, logits,
                   logits.argmax(dim=1).tolist(), diag)


COMPARED = ("embed_err", "attn_err_prefill", "attn_err_decode",
            "rest_err_prefill", "rest_err_decode", "head_err_max",
            "argmax_miss")


def judge(out: dict, limits: dict, seed: int) -> dict:
    """The compared numbers, each with its limit, and ``correct``."""
    picked = sample(out["finished"], seed, out["traffic"]["check_tokens"])
    served = sum(len(s) for _, _, s in picked)
    checks = {}
    ok = bool(picked)
    if picked:
        try:
            captured = out["capture"].states(
                [(rid, len(p) + len(s) - 1, len(s)) for rid, p, s in picked])
        except RuntimeError as e:
            checks["recorded"] = {"value": str(e), "limit": "every position"}
            captured = None
            ok = False
        if captured is not None:
            got = program_numbers(out["cfg_numbers"], out["params"], picked,
                                  captured)
            del captured
            for name in COMPARED:
                lim = float(limits[name]["limit"])
                checks[name] = {"value": got[name], "limit": lim}
                # a number with no rows to read (None) fails
                ok = ok and got[name] is not None and got[name] <= lim
    else:
        for name in COMPARED:
            checks[name] = {"value": None,
                            "limit": float(limits[name]["limit"])}
    checks["tokens_compared"] = {"value": served, "limit": 1}
    checks["failed_requests"] = {"value": out["failed"], "limit": 0}
    checks["tick_errors"] = {"value": out["record"]["tick_errors"],
                             "limit": 0}
    ok = (ok and served >= 1 and out["failed"] == 0
          and out["record"]["tick_errors"] == 0)
    return dict(correct=bool(ok), checks=checks)
