"""Self-speculative decoding: binary-draft / target-verify multi-token
ticks.

The drafter is the same model with every layer forced to
``cfg.spec_backend`` (``binary`` by default), drafting from its own page
pools on the target's page table.  Each tick it proposes up to
``spec_k`` tokens per decoding slot, and the target stack scores all
``m = spec_k + 1`` positions in one Sq > 1 pass (the model's
``verify_paged``).

Exactness: the emitted tokens are the TARGET's keyed samples.  Position
j of the verify pass samples at generated-token index ``index + j``, the
draw sequential decode would make there, and draft ``d_j`` is accepted
iff it equals ``s_{j-1}``, up to the first mismatch.  So the accepted
prefix is token for token the sequential output at any temperature.  The
drafter samples with the same keyed draws at the same indices, so where
it agrees with the target its draft is accepted by construction.

Cache discipline: target and drafter share one page table.  The drafter
runs ``m`` single-token steps so its pool stays in lockstep with the
verify writes (the last step only writes KV; steps past a row's
``n_tok`` run with ``kv_len == 0``, the inert-row contract).  Rejected
positions are rolled back on the host (``Scheduler.resolve_spec``); on
the device they sit beyond ``kv_len`` until overwritten.  ``k_scale``
keeps sequential-decode semantics: ``repair_k_scale`` rebuilds the
target's running mean at the accepted length from the ``k_means`` stash,
and ``select_k_scale`` picks the drafter's per-step snapshot.

The pools are per-layer lists of dicts, updated in place, as everywhere
in the port; a backend's write replaces the ``k_scale`` tensor rather
than writing into it, so a reference taken before a step is a snapshot.
"""

from __future__ import annotations

import torch

from repro_torch.serving import sampler as S

__all__ = ["draft_config", "sample_positions_keyed", "accept_prefix",
           "repair_k_scale", "select_k_scale", "build_spec_prefill",
           "build_spec_step"]


def draft_config(cfg):
    """The drafter's config: the same architecture with every layer's
    attention forced to ``cfg.spec_backend`` (weights are shared)."""
    return cfg.replace(layer_backends=None, attn_backend=cfg.spec_backend)


def sample_positions_keyed(logits, keys, index, temps, top_ks, top_ps):
    """``sample_step_keyed`` over every position of a verify batch.

    logits: (B, M, V); index: (B, M) generated-token index per position;
    keys/temps/top_ks/top_ps: per-slot rows shared across positions.
    Returns (B, M) int32.  The sampler is row-wise, so the positions run
    as B * M rows of one call.
    """
    b, m, v = logits.shape
    rep = lambda x: x.repeat_interleave(m, dim=0)
    out = S.sample_step_keyed(logits.reshape(b * m, v), rep(keys),
                              index.reshape(b * m), rep(temps), rep(top_ks),
                              rep(top_ps))
    return out.reshape(b, m)


def accept_prefix(drafts, samples, n_tok):
    """Accepted tokens per row INCLUDING the bonus token, (B,) int32.

    drafts: (B, M) the verify inputs (column 0 the previous token,
    columns 1.. the proposals); samples: (B, M) the target's samples;
    n_tok: (B,) valid positions per row.  ``drafts[:, j]`` is accepted
    iff it equals ``samples[:, j - 1]`` and every earlier draft was; rows
    with ``n_tok == 0`` get 0.
    """
    b, m = drafts.shape
    if m > 1:
        j = torch.arange(1, m, dtype=torch.int32, device=drafts.device)[None]
        ok = (drafts[:, 1:] == samples[:, :-1]) & (j < n_tok[:, None])
        acc = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1)
    else:
        acc = torch.zeros((b,), dtype=torch.int64, device=drafts.device)
    return torch.where(n_tok > 0, acc + 1,
                       torch.zeros_like(acc)).to(torch.int32)


def repair_k_scale(caches, old_scales, pos, base, n_tok, n_valid):
    """Roll every layer's ``k_scale`` back from ``n_tok`` written
    positions to the ``n_valid`` accepted ones, exactly, in place.

    ``old_scales``: each layer's pre-verify ``k_scale`` (or None).  The
    verify pass stashed the chunk's per-position key means in
    ``k_means``, so ``s' = (s0 * n0 + sum(means[:kept])) / (n0 + kept)``
    with ``n0 = pos - base``.  Rows with nothing rejected, and inert rows,
    keep the post-verify value.
    """
    n0 = (pos - base).to(torch.float32)[:, None]
    w = n_tok.to(torch.float32)[:, None]
    kept = n_valid.to(torch.float32)[:, None]
    exact = (kept >= w) | (w <= 0)
    for layer, s0 in zip(caches, old_scales):
        if "k_scale" not in layer or "k_means" not in layer:
            continue
        cum = torch.cumsum(layer["k_means"], dim=-1)  # (B, H, m)
        ix = torch.clamp(n_valid.long() - 1, 0, cum.shape[-1] - 1)
        ix = ix.reshape(-1, 1, 1).expand(*cum.shape[:-1], 1)
        kept_sum = torch.gather(cum, -1, ix)[..., 0]
        fixed = (s0 * n0 + kept_sum) / torch.clamp(n0 + kept, min=1.0)
        layer["k_scale"] = torch.where(exact, layer["k_scale"], fixed)
    return caches


def _kscales(caches):
    """Each layer's ``k_scale`` tensor (None where the backend keeps no
    running scale)."""
    return [layer.get("k_scale") for layer in caches]


def select_k_scale(caches, snaps, n_valid):
    """Drafter-side rollback, in place: each row's ``k_scale`` becomes the
    snapshot after its LAST accepted draft step, ``n_valid - 1``.

    ``snaps``: per-step ``_kscales`` lists (length m).  Rows with
    ``n_valid == 0`` were inert all tick, so snapshot 0 holds their
    untouched value.
    """
    idx = torch.clamp(n_valid.long() - 1, 0, len(snaps) - 1)
    for i, layer in enumerate(caches):
        if "k_scale" not in layer:
            continue
        stk = torch.stack([s[i] for s in snaps], dim=-1)  # (B, H, m)
        ix = idx.reshape(-1, 1, 1).expand(*stk.shape[:-1], 1)
        layer["k_scale"] = torch.gather(stk, -1, ix)[..., 0]
    return caches


def _sampler(hot: bool):
    if hot:
        return S.sample_step_keyed
    return lambda logits, *_: S.greedy(logits)


def build_spec_prefill(md, cfg, dcfg, hot: bool):
    """The prefill step with speculation on: the target prefill (its
    last-token sample is the slot's first token) plus a drafter prefill
    over the same chunk batch, so the drafter's pool holds the prompt KV
    before the slot's first speculative tick."""
    sample = _sampler(hot)

    def fn(params, batch, caches, dcaches, pt, keys, index, temps, top_ks,
           top_ps):
        logits, caches = md.prefill_paged(params, batch, caches, pt, cfg)
        _, dcaches = md.prefill_paged(params, batch, dcaches, pt, dcfg)
        first = sample(logits, keys, index, temps, top_ks, top_ps)
        return first, caches, dcaches

    return fn


def build_spec_step(md, cfg, dcfg, m: int, hot: bool):
    """The speculative decode step of one tick.

    Per live row with ``n_tok`` positions from ``pos`` and generated-token
    index ``index``:

      1. DRAFT: ``m`` lockstep drafter steps, sampling proposals with the
         target's keyed draws at the same indices; steps past ``n_tok``
         are inert, and the last step only writes KV;
      2. VERIFY: the target scores all ``m`` positions in one Sq > 1 pass
         and draws its samples ``s_0 .. s_{m-1}``;
      3. ACCEPT: ``n_valid = accepted + 1`` tokens are emitted;
      4. REPAIR: both pools' ``k_scale`` roll back to the accepted count;
         the token buffer takes the last valid sample.

    Returns ``(packed (B, m + 1) int32 — samples ++ n_valid, the tick's
    single readback — tok_buf (B,), caches, dcaches)``.
    """
    sample = _sampler(hot)

    def fn(params, tok_prev, fresh, fresh_mask, live_mask, pos, n_tok,
           caches, dcaches, pt, base, keys, index, temps, top_ks, top_ps):
        pos = pos.to(torch.int32)
        n_tok = n_tok.to(torch.int32)
        index = index.to(torch.int32)
        t0 = torch.where(live_mask, torch.where(fresh_mask, fresh, tok_prev),
                         torch.zeros_like(tok_prev))
        old_scales = _kscales(caches)

        # -- 1. draft: m lockstep single-token steps
        toks, tok, snaps = [t0], t0, []
        zero = torch.zeros_like(pos)
        for j in range(m):
            kvl = torch.where(live_mask & (j < n_tok), pos + j + 1, zero)
            dlogits, dcaches = md.decode_paged(params, tok, pos + j, kvl,
                                               dcaches, pt, dcfg, base=base)
            snaps.append(_kscales(dcaches))
            if j < m - 1:
                tok = sample(dlogits, keys, index + j, temps, top_ks, top_ps)
                toks.append(tok)
        drafts = torch.stack(toks, dim=1)  # (B, m)

        # -- 2. verify: one Sq > 1 target pass
        lens = torch.where(live_mask, pos + n_tok, zero)
        batch = {"tokens": drafts, "lens": lens, "offsets": pos,
                 "scale_base": base}
        logits, caches = md.verify_paged(params, batch, caches, pt, cfg)
        idx = index[:, None] + torch.arange(m, dtype=torch.int32,
                                            device=pos.device)[None]
        if hot:
            samples = sample_positions_keyed(logits, keys, idx, temps,
                                             top_ks, top_ps)
        else:
            samples = S.greedy(logits)

        # -- 3. accept-prefix
        n_valid = accept_prefix(drafts, samples, n_tok)

        # -- 4. repair + token buffer
        caches = repair_k_scale(caches, old_scales, pos, base, n_tok, n_valid)
        dcaches = select_k_scale(dcaches, snaps, n_valid)
        last = torch.gather(
            samples, 1, torch.clamp(n_valid.long() - 1, 0, m - 1)[:, None])
        tok_buf = torch.where(live_mask, last[:, 0], tok_prev)
        packed = torch.cat([samples, n_valid[:, None]], dim=1)
        return packed, tok_buf, caches, dcaches

    return fn
