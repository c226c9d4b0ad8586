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
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
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


def apply_mlp(p, x, cfg):
    """The gated MLP, (act(x W_gate) * x W_up) W_down with act silu or
    (geglu) tanh-GELU, or the plain gelu(x W_in + b_in) W_out + b_out."""
    dt = x.dtype
    if "w_gate" in p:
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        act = F.silu(g) if cfg.act == "silu" else gelu(g)
        return (act * u) @ p["w_down"].to(dt)
    h = gelu(x @ p["w_in"].to(dt) + p["b_in"].to(dt))
    return h @ p["w_out"].to(dt) + p["b_out"].to(dt)


def embed_lookup(p, tokens, cfg, dtype):
    return p["tok"].to(dtype)[tokens.long()]


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
    """
    b, s, _ = x.shape
    head = head_matrix(embed_params, cfg, x.dtype)
    if loss_mask is None:
        loss_mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    chunk = min(chunk, s)
    n_chunks = s // chunk
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n_chunks)]
    if s > n_chunks * chunk:
        bounds.append((n_chunks * chunk, s))
    pad_ok = None
    if head.shape[-1] > cfg.vocab:  # mask vocab-padding columns
        pad_ok = torch.arange(head.shape[-1], device=x.device) < cfg.vocab
    tot = ce_tot = cnt = 0.0
    for c0, c1 in bounds:
        logits = (x[:, c0:c1] @ head).to(torch.float32)  # (B, c, V_pad)
        if pad_ok is not None:
            logits = torch.where(pad_ok, logits,
                                 torch.full_like(logits, -1e9))
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels[:, c0:c1, None].long())[..., 0]
        mc = loss_mask[:, c0:c1].to(torch.float32)
        ce = ((lse - gold) * mc).sum()
        tot = tot + (ce + (z_loss * lse**2 * mc).sum())
        ce_tot = ce_tot + ce
        cnt = cnt + mc.sum()
    cnt = torch.clamp(P.batch_sum(cnt), min=1.0)
    return tot / cnt, {"ce": ce_tot / cnt, "tokens": cnt}
