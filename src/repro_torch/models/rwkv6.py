"""RWKV-6 "Finch" (arXiv:2404.05892): the ``ssm`` family.  An
attention-free LM with a data-dependent decay; CAMformer's attention
does not apply (no QK^T, no KV cache), so the family launches no kernel.

Per layer: a time mix (the WKV recurrence with a per-channel decay w_t
and a bonus u) and a channel mix, each behind a norm and a token shift.
The reference's simplifications are kept: the five shift mixes use
static learned mu, the decay keeps the Finch LoRA delta, and the head
layout is H = d_model / rwkv_head_dim.

Layout, as the other families': ``blocks`` is a list of per-layer dicts
(the reference stacks them for ``lax.scan``; models/convert.py maps the
two).  The state is O(1) in the sequence length and kept as the
reference keeps it, stacked along a leading layers axis: ``tm_prev`` and
``cm_prev`` (L, B, d), the last normed input of each mix, and ``wkv``
(L, B, H, c, c), all float32, written in place.  The reference's scan
returns the two shifts in the compute type; they are stored here in
float32, the same values.  The WKV recurrence runs in float32 as a
sequential loop over time, in the order of the reference's ``lax.scan``.
Under autograd with ``cfg.remat == "full"`` each block of the train path
recomputes in the backward.

Training inside ``sharding.partitioning.model_split`` (the ``tp``
profile) splits the time mix by whole heads and the channel mix by
hidden units over ``model`` (``_time_mix``, ``_channel_mix``); the
residual stream keeps whole rows (the reference constrains it to
``"seq"``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.transformer import (ModelDef, dtype_of,
                                            embed_shapes, last_logits,
                                            run_block)
from repro_torch.sharding import partitioning as P

__all__ = ["LORA", "shapes", "cache_specs", "loss", "prefill", "decode",
           "make_model_def"]

LORA = 64  # width of the decay's LoRA delta


def _heads(cfg):
    return cfg.d_model // cfg.rwkv_head_dim


def _tm_shapes(cfg) -> dict:
    d, c, h = cfg.d_model, cfg.rwkv_head_dim, _heads(cfg)
    hd = ("embed", "heads")
    # mu: the shift mixes of r, k, v, w and g
    return {"mu": ((5, d), "normal", (None, None)),
            "w0": ((d,), "normal", (None,)),  # static decay bias
            "w_lora_a": ((d, LORA), "normal", ("embed", None)),
            "w_lora_b": ((LORA, d), "normal", (None, "embed")),
            "u": ((h, c), "normal", ("heads", None)),  # per-head bonus
            "wr": ((d, d), "normal", hd), "wk": ((d, d), "normal", hd),
            "wv": ((d, d), "normal", hd), "wg": ((d, d), "normal", hd),
            "wo": ((d, d), "normal", ("heads", "embed")),
            "ln_x": ((d,), "ones", (None,))}  # group-norm scale


def _cm_shapes(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"mu": ((2, d), "normal", (None, None)),
            "wk": ((d, f), "normal", ("embed", "mlp")),
            "wv": ((f, d), "normal", ("mlp", "embed")),
            "wr": ((d, d), "normal", ("embed", "embed"))}


def _block_shapes(cfg) -> dict:
    return {"ln1": L.norm_shapes(cfg), "tm": _tm_shapes(cfg),
            "ln2": L.norm_shapes(cfg), "cm": _cm_shapes(cfg)}


def shapes(cfg) -> dict:
    return {"embed": embed_shapes(cfg),
            "blocks": [_block_shapes(cfg) for _ in range(cfg.n_layers)],
            "ln_f": L.norm_shapes(cfg)}


def _shift(x, x_prev):
    """Token shift: x_{t-1} over the chunk x (B, S, d) given the carry-in
    x_prev (B, d), cast to the chunk's dtype."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _wkv(r, k, v, w, u, state):
    """The WKV recurrence over time, float32.  r, k, v, w: (B, S, H, c);
    u: (H, c); state: (B, H, c, c).  Each step reads the old state:
    y_t = r_t . (S + u * k_t v_t^T), then S = w_t * S + k_t v_t^T.
    Returns (y (B, S, H, c), the last state).

    The loop runs time-major with (batch, head) folded into one batch
    axis (``bmm`` for the einsum ``bhi,bhij->bhj`` it equals), inside
    ``_WKV``, whose backward pass is written out."""
    b, s, h, c = r.shape
    steps = lambda x, *tail: x.transpose(0, 1).reshape(s, b * h, *tail)
    inputs = (steps(r, 1, c), steps(k, c, 1), steps(v, 1, c),
              steps(w, c, 1), u.expand(b, h, c).reshape(b * h, c, 1),
              state.reshape(b * h, c, c))
    keep = torch.is_grad_enabled() and any(x.requires_grad for x in inputs)
    y, state = _WKV.apply(keep, *inputs)
    return y.reshape(s, b, h, c).transpose(0, 1), state.reshape(b, h, c, c)


class _WKV(torch.autograd.Function):
    """The WKV loop, time-major: r, v (S, BH, 1, c); k, w (S, BH, c, 1);
    u (BH, c, 1); the state (BH, c, c).  The forward pass records no
    graph (six operations a step) and, when ``keep``, keeps every step's
    incoming state S_{t-1}.  The backward pass runs one reverse loop of
    four operations a step: with X_t = S_{t-1} + u * k_t v_t^T, dr_t =
    dy_t X_t^T and dX_t = r_t^T dy_t (the products autograd forms for the
    step's ``bmm``), and the state's adjoint dS_{t-1} = w_t * dS_t + dX_t;
    then at once d(k_t v_t^T) = u * dX_t + dS_t, dk, dv, dw_t = sum_j
    dS_t * S_{t-1} and du = sum_t,j dX_t * k_t v_t^T.  Each step's
    operation is autograd's on the same operands, so every gradient but
    du (its sum over the steps runs in another order) is the same bit
    for bit, without autograd's nodes a step to create and run."""

    @staticmethod
    def forward(ctx, keep, r, k, v, w, u, state):
        ys, states = [], []
        for r_t, k_t, v_t, w_t in zip(r, k, v, w):
            if keep:
                states.append(state)
            kv = k_t * v_t  # (BH, c, c)
            ys.append(torch.bmm(r_t, state + u * kv))
            state = w_t * state + kv
        if keep:
            ctx.save_for_backward(r, k, v, w, u, torch.stack(states))
        return torch.stack(ys), state

    @staticmethod
    def backward(ctx, dy, d_state):
        r, k, v, w, u, states = ctx.saved_tensors
        kv = k * v
        x = states + u * kv
        d_s, dr, d_x, d_ss = d_state, [], [], []
        for t in range(r.shape[0] - 1, -1, -1):
            d_ss.append(d_s)  # the gradient of S_t
            dr.append(torch.bmm(dy[t], x[t].transpose(1, 2)))
            d_x.append(torch.bmm(r[t].transpose(1, 2), dy[t]))
            d_s = w[t] * d_s + d_x[-1]
        dr, d_x, d_ss = (torch.stack(g[::-1]) for g in (dr, d_x, d_ss))
        d_kv = u * d_x + d_ss
        return (None, dr, (d_kv * v).sum(-1, keepdim=True),
                (d_kv * k).sum(-2, keepdim=True),
                (d_ss * states).sum(-1, keepdim=True),
                (d_x * kv).sum((0, 3))[..., None], d_s)


def _time_mix(p, x, cfg, x_prev, state):
    """x: (B, S, d); x_prev: (B, d); state: (B, H, c, c).  Returns (out,
    the new x_prev (B, d) in x's dtype, the new state float32).

    Inside ``partitioning.model_split`` with the heads split (whole
    heads: ``model_split_plan`` gathers the block whole where the
    resolver would cut inside a head), this process runs its H / m
    heads: ``wr``/``wk``/``wv``/``wg`` columns and ``u``'s rows, the WKV
    loop and the group norm (both head-local), the decay's LoRA and
    ``w0`` and ``ln_x`` sliced to the local channels, and ``wo`` rows,
    whose partial products are summed over ``model``."""
    b, s, d = x.shape
    c = cfg.rwkv_head_dim
    dl = p["wr"].shape[1]  # the channels (whole heads) run here
    split = P.split_here(dl, d)
    c0 = P.split_rank()[0] * dl if split and dl < d else 0
    h = dl // c
    if split:
        P.note_split("tm_heads", h)
        x = P.enter_split(x)
    elif P.split_rank() is not None:  # a head the resolver would cut
        P.note_split("tm_whole_heads", h)
    dt = x.dtype
    f32 = torch.float32
    xs = _shift(x, x_prev)
    xr, xk, xv, xw, xg = (x + (xs - x) * p["mu"][i].to(dt) for i in range(5))
    r = (xr @ p["wr"].to(dt)).reshape(b, s, h, c)
    k = (xk @ p["wk"].to(dt)).reshape(b, s, h, c)
    v = (xv @ p["wv"].to(dt)).reshape(b, s, h, c)
    g = F.silu(xg @ p["wg"].to(dt))
    # the data-dependent decay (the Finch contribution): exp(-exp(..))
    dw = (xw @ p["w_lora_a"].to(dt)) @ p["w_lora_b"][:, c0:c0 + dl].to(dt)
    w = torch.exp(-torch.exp(p["w0"][c0:c0 + dl].to(f32) + dw.to(f32)))
    y, state = _wkv(r.to(f32), k.to(f32), v.to(f32), w.reshape(b, s, h, c),
                    p["u"].to(f32),
                    P.local_part(state, 1, c0 // c, h).to(f32))
    # per-head group norm
    y = y * torch.rsqrt((y**2).mean(dim=-1, keepdim=True) + 1e-6)
    y = (y.reshape(b, s, dl) * p["ln_x"][c0:c0 + dl].to(f32)).to(dt)
    out = (y * g) @ p["wo"].to(dt)
    return (P.exit_split(out) if split else out), x[:, -1], state


def _channel_mix(p, x, cfg, x_prev):
    """Inside ``partitioning.model_split`` with the hidden units split:
    ``wk`` columns and ``wv`` rows here, the partial products summed
    over ``model``; the receptance (``wr``, whole) runs on every
    process."""
    dt = x.dtype
    xs = _shift(x, x_prev)
    xk = x + (xs - x) * p["mu"][0].to(dt)
    xr = x + (xs - x) * p["mu"][1].to(dt)
    split = P.split_here(p["wk"].shape[1], cfg.d_ff)
    if split:
        P.note_split("cm_cols", p["wk"].shape[1])
        xk = P.enter_split(xk)
    k = torch.square(torch.relu(xk @ p["wk"].to(dt)))
    kv = k @ p["wv"].to(dt)
    r = torch.sigmoid(xr @ p["wr"].to(dt))
    return r * (P.exit_split(kv) if split else kv), x[:, -1]


def _apply_block(p, x, cfg, tm_prev, cm_prev, wkv):
    """One block from its carried state; returns (x, tm_prev, cm_prev,
    wkv), the shifts the last rows of the normed inputs."""
    h, tm_prev, wkv = _time_mix(p["tm"], L.apply_norm(p["ln1"], x, cfg),
                                cfg, tm_prev, wkv)
    x = x + h
    h, cm_prev = _channel_mix(p["cm"], L.apply_norm(p["ln2"], x, cfg), cfg,
                              cm_prev)
    return x + h, tm_prev, cm_prev, wkv


def cache_specs(cfg, batch: int, cache_len: int) -> dict:
    """(shape, dtype) leaves of the recurrent state, O(1) in the sequence
    length (``cache_len`` is unused): ``tm_prev`` / ``cm_prev`` (L, B, d)
    and ``wkv`` (L, B, H, c, c), float32."""
    del cache_len
    h, c, d, n = _heads(cfg), cfg.rwkv_head_dim, cfg.d_model, cfg.n_layers
    f32 = torch.float32
    return {"tm_prev": ((n, batch, d), f32), "cm_prev": ((n, batch, d), f32),
            "wkv": ((n, batch, h, c, c), f32)}


def _forward(params, tokens, cfg, caches):
    """Final hidden states (B, S, d).  ``caches`` None is the train path:
    zero state, remat when configured; otherwise the state is read and
    written in place, layer by layer."""
    dt = dtype_of(cfg)
    x = L.embed_lookup(params["embed"], tokens, cfg, dt)
    train = caches is None
    if train:
        zero = {name: torch.zeros(shape[1:], dtype=dtype, device=x.device)
                for name, (shape, dtype) in
                cache_specs(cfg, tokens.shape[0], 0).items()}
    for i, p in enumerate(params["blocks"]):
        state = zero if train else {n: t[i] for n, t in caches.items()}
        x, tm_prev, cm_prev, wkv = run_block(
            _apply_block, cfg, train, p, x, cfg, state["tm_prev"],
            state["cm_prev"], state["wkv"])
        if not train:
            state["tm_prev"].copy_(tm_prev)
            state["cm_prev"].copy_(cm_prev)
            h = wkv.shape[1]  # the heads this process ran
            P.local_part(state["wkv"], 1, P.split_rank()[0] * h
                         if h < state["wkv"].shape[1] else 0,
                         h).copy_(wkv)
    return L.apply_norm(params["ln_f"], x, cfg)


def loss(params, batch, cfg):
    """batch: tokens / labels (B, S) and optional loss_mask, from a zero
    state.  Returns (loss, {"ce", "tokens"})."""
    x = _forward(params, batch["tokens"], cfg, None)
    return L.chunked_cross_entropy(x, params["embed"], batch["labels"], cfg,
                                   loss_mask=batch.get("loss_mask"))


def prefill(params, batch, caches, cfg):
    """The prompt ``tokens`` (B, S) from the state in ``caches`` (zeros
    for a fresh prompt).  Returns (last-token logits (B, V_pad) float32,
    caches)."""
    x = _forward(params, batch["tokens"], cfg, caches)
    return last_logits(params, x, cfg), caches


def decode(params, tokens, pos, kv_len, caches, cfg):
    """One step; tokens (B,).  ``pos`` and ``kv_len`` are unused: the
    positions are implicit in the recurrent state.  Returns (logits
    (B, V_pad) float32, caches)."""
    del pos, kv_len
    x = _forward(params, tokens.reshape(tokens.shape[0], 1), cfg, caches)
    return last_logits(params, x, cfg), caches


def make_model_def() -> ModelDef:
    return ModelDef(shapes=shapes, cache_specs=cache_specs, prefill=prefill,
                    decode=decode, loss=loss)
