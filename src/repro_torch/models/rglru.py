"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427): the ``hybrid``
family.  RG-LRU recurrent blocks and local (sliding-window, MQA)
attention in the reference's 2:1 pattern (rec, rec, attn).

Layout, as the reference's (``models/rglru.py``): ``n_layers`` = periods
of (rec, rec, attn) plus trailing rec layers (26 = 8 periods + 2).  The
parameters keep ``rec1`` / ``rec2`` / ``attn`` as lists of per-period
dicts (the reference stacks them for ``lax.scan``; models/convert.py
maps the two) and the trailing layers as ``tail_rec1``, ``tail_rec2``.

The attention cache is a ring bounded by the window: ``wlen =
min(cache_len, window)`` slots per attention layer, and ``attn_pos``
(B, wlen) the position each slot holds.  Decode writes position p at
slot p mod wlen; attention masks by ``attn_pos``, so camformer decode
takes the plain CAM search there (core/backend.py).  The recurrent state
(the conv window and the RG-LRU state h, float32) is O(1) per layer.
Caches are written in place.  The RG-LRU runs in float32 as a
sequential loop over time, in the order of the reference's ``lax.scan``.
Under autograd with ``cfg.remat == "full"`` each period of the train
path recomputes in the backward (the trailing layers do not, as in the
reference).

Training inside ``sharding.partitioning.model_split`` (the ``tp``
profile) splits the RG-LRU's ``rnn`` channels (``_apply_rec``), the
attention heads (``qheads`` for MQA when ``model`` divides the q heads;
else ``kv_seq``: the attention runs whole, models/attention.py) and the
GeGLU MLP's hidden units over ``model``; the residual stream keeps whole
rows (the reference constrains it to ``"seq"``).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import (attention_block, attn_cache_spec,
                                          attn_shapes)
from repro_torch.models.transformer import (ModelDef, arange_positions,
                                            dtype_of, embed_shapes,
                                            last_logits, run_block)
from repro_torch.sharding import partitioning as P

__all__ = ["RG_C", "shapes", "cache_specs", "loss", "prefill", "decode",
           "make_model_def"]

RG_C = 8.0  # RG-LRU decay sharpness constant


def _layout(cfg):
    """(period, number of periods, trailing rec layers)."""
    period = len(cfg.layer_pattern)  # ("rglru", "rglru", "attn")
    n_periods = cfg.n_layers // period
    return period, n_periods, cfg.n_layers - n_periods * period


def _rec_shapes(cfg) -> dict:
    d, r, w = cfg.d_model, cfg.rnn_width, cfg.conv_width
    return {"ln": L.norm_shapes(cfg),
            "w_gate": ((d, r), "normal", ("embed", "rnn")),
            "w_x": ((d, r), "normal", ("embed", "rnn")),
            "conv_w": ((w, r), "normal", ("conv", "rnn")),
            "conv_b": ((r,), "zeros", (None,)),
            "w_rg": ((r, r), "normal", ("rnn", "rnn"), r**-0.5),
            "b_rg": ((r,), "zeros", (None,)),
            "w_ig": ((r, r), "normal", ("rnn", "rnn"), r**-0.5),
            "b_ig": ((r,), "zeros", (None,)),
            # softplus(lam): the decay rates
            "lam": ((r,), "ones", (None,)),
            "w_out": ((r, d), "normal", ("rnn", "embed")),
            "ln_mlp": L.norm_shapes(cfg), "mlp": L.mlp_shapes(cfg)}


def _attn_layer_shapes(cfg) -> dict:
    return {"ln": L.norm_shapes(cfg), "attn": attn_shapes(cfg),
            "ln_mlp": L.norm_shapes(cfg), "mlp": L.mlp_shapes(cfg)}


def shapes(cfg) -> dict:
    _, n_periods, tail = _layout(cfg)
    s = {"embed": embed_shapes(cfg),
         "rec1": [_rec_shapes(cfg) for _ in range(n_periods)],
         "rec2": [_rec_shapes(cfg) for _ in range(n_periods)],
         "attn": [_attn_layer_shapes(cfg) for _ in range(n_periods)],
         "ln_f": L.norm_shapes(cfg)}
    for i in range(tail):
        s[f"tail_rec{i + 1}"] = _rec_shapes(cfg)
    return s


# ---------------- RG-LRU recurrent block ----------------

def _causal_conv(x, conv_state, w, b):
    """Depthwise causal conv over time, its taps summed in the
    reference's order.  x: (B, S, r); conv_state: (B, W-1, r), the
    previous W-1 inputs.  Returns (out (B, S, r), new conv_state)."""
    width = w.shape[0]
    xx = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = sum(xx[:, i:i + x.shape[1]] * w[i].to(x.dtype)
              for i in range(width)) + b.to(x.dtype)
    new_state = xx[:, -(width - 1):] if width > 1 else conv_state
    return out, new_state


def _rg_lru(a, drive, h):
    """h_t = a_t * h_{t-1} + drive_t over time, float32.  a, drive:
    (B, S, r); h: (B, r).  Returns (every h_t (B, S, r), the last)."""
    ys = _Scan.apply(a, drive, h)
    return ys, ys[:, -1]


class _Scan(torch.autograd.Function):
    """The RG-LRU's loop with its adjoint written out.  The forward pass
    records no graph (two operations a step); the backward pass runs
    G_{t-1} = g_{t-1} + a_t * G_t in one reverse loop (G_t the gradient
    of h_t, g_t that of the output at t), then da_t = G_t * h_{t-1},
    ddrive_t = G_t and dh_0 = a_0 * G_0 at once.  Each product and sum
    is the one autograd forms through the loop (a sum of two terms), so
    the gradients are the same bit for bit, without an autograd node a
    step to create and run."""

    @staticmethod
    def forward(ctx, a, drive, h0):
        ys, h = [], h0
        for a_t, d_t in zip(a.unbind(1), drive.unbind(1)):
            h = a_t * h + d_t
            ys.append(h)
        ys = torch.stack(ys, dim=1)
        ctx.save_for_backward(a, ys, h0)
        return ys

    @staticmethod
    def backward(ctx, g):
        a, ys, h0 = ctx.saved_tensors
        a_s, g_s = a.unbind(1), g.unbind(1)
        grads = [g_s[-1]]
        for t in range(a.shape[1] - 1, 0, -1):
            grads.append(g_s[t - 1] + a_s[t] * grads[-1])
        grads = torch.stack(grads[::-1], dim=1)
        h_prev = torch.cat([h0[:, None], ys[:, :-1]], dim=1)
        return grads * h_prev, grads, a_s[0] * grads[:, 0]


def _apply_rec(p, x, cfg, state):
    """One Griffin recurrent block (+ MLP).  state: {"conv": (B, W-1, r),
    "h": (B, r)}, float32.  Returns (x, new conv state, new h).

    Inside ``partitioning.model_split`` with the ``rnn`` channels split,
    this process runs its r / m channels: ``w_gate``/``w_x`` columns,
    ``conv_w`` channels, the loop over time (per channel, no
    communication) and ``w_out`` rows, whose partial products are summed
    over ``model``; the per-channel vectors (``conv_b``, the gate biases,
    ``lam``) and the state are sliced to the local channels.  ``w_rg``
    and ``w_ig`` hold rows here (the resolver gives ``model`` to the
    first ``rnn`` of their ``("rnn", "rnn")`` axes), so the local
    channels of u times the local rows are a partial sum of every gate
    channel: the two products, stacked, are reduce-scattered over the
    channels, each process keeping the sum's local channels.  That is
    the all-reduce of the partial products with only the needed quarter
    kept, (m - 1) / m of B x S x 2r elements a process, the volume of an
    all-gather of u; the all-gather would also need the matrices'
    columns, which no process holds without gathering both (r, r)
    matrices whole every step."""
    dt = x.dtype
    f32 = torch.float32
    rl = p["w_x"].shape[1]  # the rnn channels run here
    split = P.split_here(rl, cfg.rnn_width)
    c0 = P.split_rank()[0] * rl if split and rl < cfg.rnn_width else 0
    # a whole vector's local channels (a state a sharded serving step
    # hands in is already this process's block)
    here = lambda t: P.local_part(t, t.dim() - 1, c0, rl)
    h_in = L.apply_norm(p["ln"], x, cfg)
    if split:
        P.note_split("rnn", rl)
        h_in = P.enter_split(h_in)
    gate = L.gelu(h_in @ p["w_gate"].to(dt))
    u = h_in @ p["w_x"].to(dt)
    u, conv_state = _causal_conv(u, here(state["conv"]), p["conv_w"],
                                 here(p["conv_b"]))
    rg, ig = u @ p["w_rg"].to(dt), u @ p["w_ig"].to(dt)
    if split:
        rg, ig = P.reduce_scatter(torch.stack([rg, ig], 2), 3).unbind(2)
    r_g = torch.sigmoid(rg + here(p["b_rg"]).to(dt))
    i_g = torch.sigmoid(ig + here(p["b_ig"]).to(dt))
    lam = here(p["lam"]).to(f32)
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))
    a = torch.exp(-RG_C * softplus * r_g.to(f32))
    drive = torch.sqrt(torch.clamp(1.0 - a**2, min=1e-12)) * \
        (i_g * u).to(f32)
    ys, h_last = _rg_lru(a, drive, here(state["h"]).to(f32))
    out = (gate * ys.to(dt)) @ p["w_out"].to(dt)
    x = x + (P.exit_split(out) if split else out)
    x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln_mlp"], x, cfg), cfg)
    return x, conv_state, h_last


def _rec_layer(p, x, cfg, state, train):
    """``_apply_rec``, writing the new state into ``state`` in place
    unless ``train``."""
    x, conv, h = _apply_rec(p, x, cfg, state)
    if not train:  # the channels this process ran
        rl = h.shape[-1]
        c0 = P.split_rank()[0] * rl if rl < state["h"].shape[-1] else 0
        P.local_part(state["conv"], 2, c0, rl).copy_(conv)
        P.local_part(state["h"], 1, c0, rl).copy_(h)
    return x


def _apply_attn(p, x, cfg, cache, positions, cache_index, kv_len,
                kv_positions):
    h, cache = attention_block(
        p["attn"], L.apply_norm(p["ln"], x, cfg), cfg, positions=positions,
        cache=cache, cache_index=cache_index, kv_len=kv_len,
        kv_positions=kv_positions, causal=True, window=cfg.window)
    x = x + h
    x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln_mlp"], x, cfg), cfg)
    return x, cache


# ---------------- caches ----------------

def _rec_state_spec(cfg, batch):
    r, w = cfg.rnn_width, cfg.conv_width
    return {"conv": ((batch, w - 1, r), torch.float32),
            "h": ((batch, r), torch.float32)}


def cache_specs(cfg, batch: int, cache_len: int) -> dict:
    """(shape, dtype) leaves: per-period rec states ``rec1`` / ``rec2``,
    per-period window-bounded attention caches ``attn`` (wlen = min(
    cache_len, window) slots) and their slot positions ``attn_pos``
    (B, wlen) int32, and the trailing layers' states."""
    _, n_periods, tail = _layout(cfg)
    wlen = min(cache_len, cfg.window or cache_len)
    out = {"rec1": [_rec_state_spec(cfg, batch) for _ in range(n_periods)],
           "rec2": [_rec_state_spec(cfg, batch) for _ in range(n_periods)],
           "attn": [attn_cache_spec(cfg, batch, wlen, dtype_of(cfg))
                    for _ in range(n_periods)],
           "attn_pos": ((batch, wlen), torch.int32)}
    for i in range(tail):
        out[f"tail_rec{i + 1}"] = _rec_state_spec(cfg, batch)
    return out


# ---------------- forward ----------------

def _period(p1, p2, pa, x, cfg, s1, s2, ca, positions, cache_index, kv_len,
            kv_positions, train):
    x = _rec_layer(p1, x, cfg, s1, train)
    x = _rec_layer(p2, x, cfg, s2, train)
    x, ca = _apply_attn(pa, x, cfg, ca, positions, cache_index, kv_len,
                        kv_positions)
    return x, ca


def _forward(params, tokens, cfg, caches, *, positions=None,
             cache_index=None, kv_len=None, kv_positions=None):
    """Final hidden states (B, S, d).  ``caches`` None is the train path:
    zero recurrent states, no attention cache, remat when configured."""
    dt = dtype_of(cfg)
    b, s = tokens.shape
    dev = tokens.device
    # the scale is rounded to the compute type before the multiply, as
    # the reference's jnp.asarray(d_model**0.5, dt)
    x = L.embed_lookup(params["embed"], tokens, cfg, dt) * torch.tensor(
        cfg.d_model**0.5, dtype=dt, device=dev)
    if positions is None:
        positions = arange_positions(b, s, dev)
    train = caches is None
    zero = {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, (shape, dtype) in _rec_state_spec(cfg, b).items()
            } if train else None

    def state(key, i=None):  # a rec layer's state (zeros when training)
        if train:
            return zero
        return caches[key] if i is None else caches[key][i]
    _, n_periods, tail = _layout(cfg)
    for i in range(n_periods):
        args = (params["rec1"][i], params["rec2"][i], params["attn"][i], x,
                cfg, state("rec1", i), state("rec2", i),
                None if train else caches["attn"][i], positions,
                cache_index, kv_len, kv_positions, train)
        x, ca = run_block(_period, cfg, train, *args)
        if not train:
            caches["attn"][i] = ca
    for i in range(tail):
        key = f"tail_rec{i + 1}"
        x = _rec_layer(params[key], x, cfg, state(key), train)
    return L.apply_norm(params["ln_f"], x, cfg)


def loss(params, batch, cfg):
    """batch: tokens / labels (B, S) and optional loss_mask.  Returns
    (loss, {"ce", "tokens"})."""
    x = _forward(params, batch["tokens"], cfg, None)
    return L.chunked_cross_entropy(x, params["embed"], batch["labels"], cfg,
                                   loss_mask=batch.get("loss_mask"))


def prefill(params, batch, caches, cfg):
    """The prompt ``tokens`` (B, S) from position 0.  The ring then holds
    the trailing window when S >= wlen (stored from slot 0), else
    positions 0..S-1 in slots 0..S-1 (later slots unwritten, masked by
    kv_len).  Returns (last-token logits (B, V_pad) float32, caches)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _forward(params, tokens, cfg, caches, cache_index=0)
    wlen = caches["attn_pos"].shape[1]
    first = s - wlen if s >= wlen else 0
    caches["attn_pos"].copy_(torch.arange(
        first, first + wlen, dtype=torch.int32,
        device=tokens.device)[None].expand(b, wlen))
    return last_logits(params, x, cfg), caches


def decode(params, tokens, pos, kv_len, caches, cfg):
    """One step; tokens, pos, kv_len (B,).  Each row's position is
    written at its ring slot ``pos mod wlen`` (and into ``attn_pos``).
    Returns (logits (B, V_pad) float32, caches)."""
    b = tokens.shape[0]
    positions = pos.reshape(b, 1).to(torch.int32)
    wlen = caches["attn_pos"].shape[1]
    slots = torch.remainder(pos.to(torch.int32), wlen)
    rows = torch.arange(b, device=tokens.device)
    caches["attn_pos"][rows, slots.long()] = positions[:, 0]
    x = _forward(params, tokens.reshape(b, 1), cfg, caches,
                 positions=positions, cache_index=slots,
                 kv_len=kv_len.to(torch.int32),
                 kv_positions=caches["attn_pos"])
    return last_logits(params, x, cfg), caches


def make_model_def() -> ModelDef:
    return ModelDef(shapes=shapes, cache_specs=cache_specs, prefill=prefill,
                    decode=decode, loss=loss)
