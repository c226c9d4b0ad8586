"""Step functions: train, prefill and serve.

    train_step(state, batch) -> (state, metrics)
    prefill_step(params, batch, caches) -> (logits, caches)
    serve_step(params, tokens, pos, kv_len, caches) -> (logits, caches)

``md`` is the family's ``ModelDef`` (``models.get_model_def(cfg)``:
dense, MoE, VLM, encoder-decoder or Griffin hybrid); its
``cache_specs(cfg, batch, cache_len)`` gives the caches the prefill and
serve steps take (``models.init_pools`` allocates them).  Each step
casts the parameters to the config's compute type first (a no-op for
parameters already in it) and calls the model's entry point; the batch
goes through as given, so a VLM batch takes ``batch["image_embeds"]``
(B, P, d) and an audio batch ``batch["audio_features"]`` (B, enc_len,
d) beside ``batch["tokens"]``.
The reference's sharding assembly (mesh specs of every argument) has no
counterpart: the port runs on one device.
"""

from __future__ import annotations

import torch

from repro_torch.models.module import (cast_params, init_params,
                                       tree_leaves, tree_map)
from repro_torch.models.transformer import dtype_of
from repro_torch.train.optimizer import adamw, cosine_schedule

__all__ = ["METRIC_KEYS", "make_value_and_grad", "make_train_step",
           "init_state", "make_prefill_step", "make_serve_step"]

METRIC_KEYS = ("loss", "grad_norm", "lr", "ce", "tokens",
               "moe_aux_loss", "moe_drop_frac")


def make_value_and_grad(md, cfg):
    """``fn(params, batch) -> (loss, aux, grads)``: the model's loss on
    the compute-type copy of the float32 masters, and its gradient with
    respect to the masters (the cast runs inside the graph)."""
    dt = dtype_of(cfg)

    def value_and_grad(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, aux = md.loss(cast_params(live, dt), batch, cfg)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
        return (loss.detach(), {k: v.detach() for k, v in aux.items()},
                tree_map(lambda _: next(grads), live))

    return value_and_grad


def make_train_step(md, cfg, *, peak_lr=3e-4, warmup=2000,
                    total_steps=100_000, accum: int = 1):
    """Returns (train_step, optimizer).  state = {"params", "opt": {"m",
    "v", "step"}} with float32 masters (``init_state``); the step updates
    it in place and returns it with the metrics of ``METRIC_KEYS``
    (float32 0-d tensors; nothing is read back to the host).  With
    ``accum > 1`` the batch is cut along its rows into ``accum``
    microbatches whose gradients and losses are averaged (the other
    metrics are then 0, as in the reference)."""
    opt = adamw(cosine_schedule(peak_lr, warmup, total_steps))
    value_and_grad = make_value_and_grad(md, cfg)

    def train_step(state, batch):
        params = state["params"]
        if accum == 1:
            loss, aux, grads = value_and_grad(params, batch)
        else:  # microbatched gradient accumulation
            gsum = tree_map(torch.zeros_like, params)
            loss = 0.0
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                mb_loss, _, g = value_and_grad(params, mb)
                torch._foreach_add_(tree_leaves(gsum), tree_leaves(g))
                loss = loss + mb_loss
            torch._foreach_div_(tree_leaves(gsum), float(accum))
            grads, loss, aux = gsum, loss / accum, {}
        params, opt_state, ostats = opt.update(grads, state["opt"], params)
        raw = {"loss": loss, **ostats, **aux}
        metrics = {k: torch.as_tensor(raw.get(k, 0.0), dtype=torch.float32)
                   for k in METRIC_KEYS}
        return {"params": params, "opt": opt_state}, metrics

    return train_step, opt


def init_state(cfg, opt, *, seed: int = 0, device="cuda") -> dict:
    """A fresh train state: seeded float32 masters (``init_params``) and
    the optimizer's zeros."""
    params = init_params(cfg, device=device, seed=seed)
    return {"params": params, "opt": opt.init(params)}


def make_prefill_step(md, cfg):
    dt = dtype_of(cfg)

    def prefill_step(params, batch, caches):
        return md.prefill(cast_params(params, dt), batch, caches, cfg)

    return prefill_step


def make_serve_step(md, cfg):
    dt = dtype_of(cfg)

    def serve_step(params, tokens, pos, kv_len, caches):
        return md.decode(cast_params(params, dt), tokens, pos, kv_len,
                         caches, cfg)

    return serve_step
