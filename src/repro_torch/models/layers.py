"""Shared model layers: norms, RoPE, sinusoidal positions, the MLPs,
embeddings and the chunked cross-entropy loss, with the shapes of their
parameters."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import partitioning as P

__all__ = ["norm_shapes", "apply_norm", "rope", "sinusoidal_positions",
           "gelu", "mlp_shapes", "apply_mlp", "embed_lookup", "head_matrix",
           "chunked_cross_entropy"]


def norm_shapes(cfg) -> dict:
    """{leaf: (shape, init, axes)} of a norm: a scale, and a bias for
    layer norm."""
    s = {"scale": ((cfg.d_model,), "ones", (None,))}
    if cfg.norm == "layer":
        s["bias"] = ((cfg.d_model,), "zeros", (None,))
    return s


def apply_norm(p, x, cfg, eps: float = 1e-6):
    """RMS or layer norm, computed in float32 and cast back to x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "layer":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:  # rms
        var = (xf**2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Half-split rotary embedding, [x1 cos - x2 sin, x2 cos + x1 sin].

    x: (B, H, S, D); positions: (B, S).
    """
    d = x.shape[-1]
    half = d // 2
    # theta ** e rounded once from float64: the reference's float32 pow
    # gives the nearest float32 at mistral's and yi's (theta, d), where
    # torch's float32 pow is an ulp off in a few channels, which moves an
    # angle by up to 4e-3 rad at position 5e5
    # (tests/test_torch_long_context.py)
    ex = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = (theta ** ex.to(torch.float64)).to(torch.float32)
    ang = positions[:, None, :, None].to(torch.float32) * freqs  # (B,1,S,h)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style absolute embeddings, (B, S) -> (B, S, d) float32:
    [sin, cos] of positions times exp(-log(1e4) * i / (d/2 - 1))."""
    half = d // 2
    f32 = dict(dtype=torch.float32, device=positions.device)
    # float32 operands throughout, as the reference computes them (a
    # Python float factor would enter in double precision, and a
    # division by a Python number is a reciprocal multiply on the card)
    freqs = torch.exp(torch.tensor(-math.log(10000.0), **f32)
                      * torch.arange(half, **f32)
                      / torch.tensor(half - 1, **f32))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def gelu(x):
    """GELU in its tanh form, the default of the reference's
    ``jax.nn.gelu`` (the erf form differs by about 1e-3)."""
    return F.gelu(x, approximate="tanh")


def mlp_shapes(cfg) -> dict:
    """{leaf: (shape, init, axes)} of the MLP: gated for ``silu`` /
    ``geglu``, the plain biased 2-layer MLP (whisper) otherwise."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act in ("silu", "geglu"):
        return {"w_gate": ((d, f), "normal", ("embed", "mlp")),
                "w_up": ((d, f), "normal", ("embed", "mlp")),
                "w_down": ((f, d), "normal", ("mlp", "embed"))}
    return {"w_in": ((d, f), "normal", ("embed", "mlp")),
            "b_in": ((f,), "zeros", (None,)),
            "w_out": ((f, d), "normal", ("mlp", "embed")),
            "b_out": ((d,), "zeros", (None,))}


def apply_mlp(p, x, cfg, seq: bool = False):
    """The gated MLP, (act(x W_gate) * x W_up) W_down with act silu or
    (geglu) tanh-GELU, or the plain gelu(x W_in + b_in) W_out + b_out.

    Inside ``partitioning.model_split`` with the hidden dim split, this
    process holds the columns of W_gate/W_up/W_in and the rows of
    W_down/W_out of its hidden units (``b_in`` is sliced to them): the
    partial products are summed over ``model`` and ``b_out`` is added
    once, after the sum.  With ``seq`` x and the output are this
    process's rows of the split residual stream (``res_seq``)."""
    dt = x.dtype
    w_last = p["w_down"] if "w_gate" in p else p["w_out"]
    split = P.split_here(w_last.shape[0], cfg.d_ff)
    if split:
        P.note_split("mlp_cols", w_last.shape[0])
    x = P.region_in(x, split, seq)
    if "w_gate" in p:
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        act = F.silu(g) if cfg.act == "silu" else gelu(g)
        return P.region_out((act * u) @ p["w_down"].to(dt), split, seq)
    b_in = p["b_in"]
    if split and w_last.shape[0] < cfg.d_ff:
        f = w_last.shape[0]
        b_in = b_in[P.split_rank()[0] * f:(P.split_rank()[0] + 1) * f]
    h = gelu(x @ p["w_in"].to(dt) + b_in.to(dt))
    out = P.region_out(h @ p["w_out"].to(dt), split, seq)
    return out + p["b_out"].to(dt)


def _vocab_split(rows: int, cfg):
    """(split, first row) of a vocabulary block of ``rows`` rows here:
    inside ``model_split`` with the vocabulary split (or a split of size
    1), this process holds rows ``[rank * rows, (rank + 1) * rows)``."""
    if not P.split_here(rows, cfg.padded_vocab):
        return False, 0
    P.note_split("vocab_rows", rows)
    return True, P.split_rank()[0] * rows


def embed_lookup(p, tokens, cfg, dtype):
    """Token embeddings (B, S, d).  Vocab-parallel inside
    ``partitioning.model_split``: each process looks up the tokens of
    its rows, zeros elsewhere, and the sum over ``model`` (one non-zero
    term a token) is the embedding, exactly."""
    tok = p["tok"].to(dtype)
    split, v0 = _vocab_split(tok.shape[0], cfg)
    if not split:
        return tok[tokens.long()]
    local = tokens.long() - v0
    mine = (local >= 0) & (local < tok.shape[0])
    e = tok[torch.clamp(local, 0, tok.shape[0] - 1)]
    return P.exit_split(torch.where(mine[..., None], e,
                                    torch.zeros_like(e)))


def head_matrix(embed_params, cfg, dtype):
    """The (d, V_pad) output projection in ``dtype`` (the transposed
    token embedding when tied)."""
    if cfg.tie_embeddings:
        return embed_params["tok"].to(dtype).T
    return embed_params["head"].to(dtype)


def chunked_cross_entropy(x, embed_params, labels, cfg, *, loss_mask=None,
                          chunk: int = 512, z_loss: float = 1e-4):
    """Mean CE over sequence chunks (the reference's chunking: ``chunk``
    positions at a time, then the remainder), so the float32 logits of the
    whole sequence are never live at once in the forward.

    x: (B, S, d); labels: (B, S) int.  Per chunk the logits are computed
    in x's dtype and taken to float32, vocab-padding columns get -1e9,
    and the loss adds ``z_loss * logsumexp**2``.  Returns (loss, {"ce",
    "tokens"}): loss and ce are sums over the masked positions divided by
    their count (at least 1).

    Inside ``sharding.partitioning.sharded_batch`` x holds this process's
    rows of a sharded batch: the count (and ``tokens``) is then the
    global batch's (summed over the batch axes), so that loss and ce
    summed over the batch axes are the global batch's.

    Vocab-parallel inside ``partitioning.model_split`` with the
    vocabulary split: this process's logits are those of its vocabulary
    rows, and the maximum, the sum of exponentials and the target logit
    are reduced over ``model``.  One formula serves both: unsplit, the
    reductions are the identity.
    """
    b, s, _ = x.shape
    head = head_matrix(embed_params, cfg, x.dtype)
    split, v0 = _vocab_split(head.shape[-1], cfg)
    same = lambda t: t
    red_max = P.model_max if split else same
    red_sum = P.exit_split if split else same
    if split:
        x = P.enter_split(x)
    if loss_mask is None:
        loss_mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    chunk = min(chunk, s)
    n_chunks = s // chunk
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if s > n_chunks * chunk:
        bounds.append((n_chunks * chunk, s))
    cols = v0 + torch.arange(head.shape[-1], device=x.device)
    pad_ok = None
    if head.shape[-1] + v0 > cfg.vocab:  # mask vocab-padding columns
        pad_ok = cols < cfg.vocab
    tot = ce_tot = cnt = 0.0
    for c0, c1 in bounds:
        logits = (x[:, c0:c1] @ head).to(torch.float32)  # (B, c, V_local)
        if pad_ok is not None:
            logits = torch.where(pad_ok, logits,
                                 torch.full_like(logits, -1e9))
        # the maximum carries no gradient (the reference's logsumexp):
        # the sum's gradient is then the softmax, split or not
        m = red_max(logits.detach().amax(-1))
        lse = m + torch.log(red_sum(torch.exp(logits - m[..., None])
                                    .sum(-1)))
        local = labels[:, c0:c1].long() - v0
        mine = (local >= 0) & (local < head.shape[-1])
        gold = torch.gather(logits, -1, torch.clamp(
            local, 0, head.shape[-1] - 1)[..., None])[..., 0]
        gold = red_sum(torch.where(mine, gold, torch.zeros_like(gold)))
        mc = loss_mask[:, c0:c1].to(torch.float32)
        ce = ((lse - gold) * mc).sum()
        tot = tot + (ce + (z_loss * lse**2 * mc).sum())
        ce_tot = ce_tot + ce
        cnt = cnt + mc.sum()
    cnt = torch.clamp(P.batch_sum(cnt), min=1.0)
    return tot / cnt, {"ce": ce_tot / cnt, "tokens": cnt}
