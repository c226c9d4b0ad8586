"""Shared model layers: norms, RoPE, the gated MLP, embeddings."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["apply_norm", "rope", "apply_mlp", "embed_lookup"]


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
