"""Shared model layers: norms, RoPE, the gated MLP, embeddings and the
chunked cross-entropy loss."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["apply_norm", "rope", "apply_mlp", "embed_lookup",
           "head_matrix", "chunked_cross_entropy"]


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


def apply_mlp(p, x, cfg):
    """Gated SiLU MLP: (silu(x W_gate) * x W_up) W_down."""
    if cfg.act != "silu" or "w_gate" not in p:
        raise NotImplementedError(
            f"act={cfg.act!r}: only the gated silu MLP is ported")
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    return (F.silu(g) * u) @ p["w_down"].to(dt)


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
    cnt = torch.clamp(cnt, min=1.0)
    return tot / cnt, {"ce": ce_tot / cnt, "tokens": cnt}
