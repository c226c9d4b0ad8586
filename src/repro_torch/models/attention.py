"""Model-level attention block: projections, RoPE and dispatch to the
layer's ``AttentionBackend`` (core/backend.py), over a paged pool, a
contiguous cache (a ring of rotated positions included) or the encoder
keys of cross-attention."""

from __future__ import annotations

import torch

from repro_torch.core.backend import AttentionBackend, get_backend
from repro_torch.models.layers import rope
from repro_torch.sharding import partitioning as P

__all__ = ["attn_shapes", "attn_cache_spec", "attention_block",
           "tp_local_decode", "tp_gather", "attn_strategy", "select_kv"]


def _resolve_backend(cfg, backend=None) -> AttentionBackend:
    if isinstance(backend, AttentionBackend):
        return backend
    return get_backend(backend or cfg.backend)


def attn_shapes(cfg) -> dict:
    """{leaf: (shape, init, axes)} of one attention sub-block's
    projections."""
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {"wq": ((d, q), "normal", ("embed", "heads")),
         "wk": ((d, kv), "normal", ("embed", "kv_heads")),
         "wv": ((d, kv), "normal", ("embed", "kv_heads")),
         "wo": ((q, d), "normal", ("heads", "embed"))}
    if cfg.qkv_bias:
        s.update(bq=((q,), "zeros", (None,)), bk=((kv,), "zeros", (None,)),
                 bv=((kv,), "zeros", (None,)))
    return s


def attn_cache_spec(cfg, batch: int, cache_len: int, dtype, backend=None):
    """{leaf: (shape, dtype)} of one layer's contiguous self-attention
    cache (delegates to the layer's backend)."""
    return _resolve_backend(cfg, backend).cache_spec(cfg, batch, cache_len,
                                                     dtype)


def tp_local_decode(bk, q, cache, k, v, positions, page_table, kv_len, cfg,
                    scale_base, rank: int, tp: int):
    """One process's share of paged attention over a head-sharded pool
    (tensor-parallel serving, serving/sharded.py): q/k/v, which carry
    every head, are cut to process ``rank``'s contiguous heads (kv heads
    ``[i*hl, (i+1)*hl)`` own q heads ``[i*g*hl, (i+1)*g*hl)``) as
    contiguous tensors, and the backend's paged write and attention run
    unchanged on the slice and on ``cache``, this process's pool slice.
    Returns (out (B, H / tp, S, D), cache); ``tp_gather`` reassembles the
    heads.  One process can run every rank's share in turn (the tests
    do); the served path gathers through the group."""
    hl = cache["v_pages"].shape[1]
    if hl * tp != cfg.n_kv_heads:
        raise ValueError(f"a pool slice of {hl} kv heads is not 1/{tp} of "
                         f"n_kv_heads={cfg.n_kv_heads}")
    g = cfg.n_heads // cfg.n_kv_heads
    q = q[:, rank * g * hl:(rank + 1) * g * hl].contiguous()
    k = k[:, rank * hl:(rank + 1) * hl].contiguous()
    v = v[:, rank * hl:(rank + 1) * hl].contiguous()
    return bk.paged_decode(q, cache, k, v, positions, page_table, kv_len,
                           cfg, base=scale_base)


def tp_gather(out, mesh):
    """Per-process head slices (B, H / tp, S, D) concatenated along heads
    in rank order over the tp ``mesh``'s group: an all-gather, pure
    concatenation, so every process holds the same full-head output."""
    import torch.distributed as dist

    tp = mesh.size()
    local = out.transpose(0, 1).contiguous()  # heads first: rank order
    full = torch.empty((tp * local.shape[0],) + tuple(local.shape[1:]),
                       dtype=local.dtype, device=local.device)
    dist.all_gather_into_tensor(full, local, group=mesh.get_group("tp"))
    return full.transpose(0, 1)


def _tp_paged_decode(bk, q, cache, k, v, positions, page_table, kv_len, cfg,
                     scale_base):
    """Paged attention over this process's head slice of the pool, inside
    a tensor-parallel serving step (``launch/mesh.tp_scope``)."""
    from repro_torch.launch.mesh import get_tp_scope

    mesh = get_tp_scope()
    if mesh is None:
        raise ValueError(
            f"a pool of {cache['v_pages'].shape[1]} kv heads (the config "
            f"has {cfg.n_kv_heads}) outside a tensor-parallel serving step")
    out, cache = tp_local_decode(bk, q, cache, k, v, positions, page_table,
                                 kv_len, cfg, scale_base,
                                 mesh.get_local_rank("tp"), mesh.size())
    return tp_gather(out, mesh), cache


def attn_strategy(cfg, model=None, training: bool = True) -> str:
    """The attention split over a ``model`` axis of size ``model`` (the
    reference's ``_attn_strategy``): ``heads`` when the kv heads divide
    (everything head-local), ``qheads`` when only the q heads do (q heads
    split, K and V whole), else ``kv_seq`` in training and ``q_seq`` in
    inference.  ``none`` without a ``model`` axis.

    Under ``kv_seq`` the reference's training attention constrains K and
    V to ``("batch", None, "att_kv_seq", "head_dim")`` and Q to
    ``("batch", None, None, "head_dim")``, but no rule table has an
    ``att_kv_seq`` key, so its resolver leaves those dims unsharded and
    the attention runs whole, replicated over ``model``: the train step
    here runs it on whole weights too (``model_split_plan``'s
    ``"whole"``).  ``q_seq`` belongs to the sharded serving steps, which
    are not ported."""
    if model is None:
        return "none"
    if cfg.n_kv_heads % model == 0:
        return "heads"
    if cfg.n_heads % model == 0:
        return "qheads"
    return "kv_seq" if training else "q_seq"


def select_kv(k, v, q0: int, hq: int, cfg):
    """Under ``qheads`` (whole K and V, ``hq`` local q heads from q head
    ``q0``): the kv heads of the local q heads when the split follows the
    groups, else one copy of its kv head for each local q head."""
    g = cfg.n_heads // cfg.n_kv_heads
    if q0 % g == 0 and hq % g == 0:
        return k[:, q0 // g:(q0 + hq) // g], v[:, q0 // g:(q0 + hq) // g]
    idx = torch.arange(q0, q0 + hq, device=k.device) // g
    return k[:, idx], v[:, idx]


def _project(p, x, cfg, split: bool = False, seq: bool = False,
             cross_kv=None):
    """QKV projections (+ optional bias) into (B, heads, S, head_dim);
    with ``cross_kv`` (cross-attention) K and V are those given.

    With ``split`` (training inside ``partitioning.model_split``): the
    heads of this process.  ``wq`` (and ``wk``/``wv`` under ``heads``)
    then hold this process's columns and the biases are sliced to them;
    under ``qheads`` K and V are whole, and each local q head takes its
    kv head's (``select_kv``).  With ``seq`` x holds this process's rows
    of the split residual stream and the region runs on the gathered
    sequence (``partitioning.region_in``)."""
    dt, d = x.dtype, cfg.head_dim
    hq = p["wq"].shape[1] // d
    rank = P.split_rank()[0] if split else 0
    q0 = rank * hq if hq < cfg.n_heads else 0
    x = P.region_in(x, split, seq)
    b, s, _ = x.shape
    q = x @ p["wq"].to(dt)
    if "bq" in p:
        q = q + p["bq"][q0 * d:(q0 + hq) * d].to(dt)
    q = q.reshape(b, s, hq, d).transpose(1, 2)
    if cross_kv is None:
        hk = p["wk"].shape[1] // d
        k0 = rank * hk if hk < cfg.n_kv_heads else 0
        k = x @ p["wk"].to(dt)
        v = x @ p["wv"].to(dt)
        if "bk" in p:
            k = k + p["bk"][k0 * d:(k0 + hk) * d].to(dt)
            v = v + p["bv"][k0 * d:(k0 + hk) * d].to(dt)
        k = k.reshape(b, s, hk, d).transpose(1, 2)
        v = v.reshape(b, s, hk, d).transpose(1, 2)
    else:
        k, v = cross_kv
    if hq < cfg.n_heads and k.shape[1] == cfg.n_kv_heads:  # qheads
        k, v = select_kv(k, v, q0, hq, cfg)
    if split:
        P.note_split("attn_q_heads", hq)
        P.note_split("attn_kv_heads", k.shape[1])
    return q, k, v


def attention_block(p, x, cfg, *, positions, cache=None, cache_index=None,
                    kv_len=None, kv_positions=None, page_table=None,
                    scale_base=None, causal: bool = True, window=None,
                    cross_kv=None, backend=None, seq: bool = False):
    """Attention sub-block.  Returns (out (B, S, d_model), cache).

    x: (B, S, d_model); positions: (B, S).  Modes, as the reference's:

      train:          no cache: attention over the fresh K/V;
      paged serving:  ``cache`` is this layer's pool dict and
                      ``page_table`` (B, NP) is set (with ``kv_len``):
                      prefill chunks and decode rows splice into pages
                      and attend through the page table;
      prefill:        contiguous ``cache``, ``kv_len`` None: attention
                      over the fresh K/V, written at ``cache_index``
                      (default 0);
      decode:         contiguous ``cache`` and ``kv_len`` (B,): write at
                      ``cache_index`` (an int or (B,)), then attend over
                      the cache's valid slots; ``kv_positions`` (B, L)
                      gives the position each slot holds (a ring cache,
                      whose slots are rotated), else slot i holds
                      position i;
      cross-attention: ``cross_kv`` = (k, v) (B, H_kv, S_enc, D) from
                      the encoder: no RoPE, no cache write, non-causal
                      attention on the layer's backend (the paper's
                      Sec. IV-C: a CAM search over the encoder keys).

    ``causal`` and ``window`` (default ``cfg.window``) mask the fresh
    K/V of train and prefill; decode is causal.  Caches are updated in
    place.

    Training inside ``partitioning.model_split`` runs this process's
    heads (``_project``), cross-attention too (its K/V projected from
    the memory with this process's ``wk``/``wv`` columns, models/
    encdec.py), and sums the partial outputs over ``model``; with
    ``seq`` (the decoder-only stack's ``res_seq``) x and the output are
    this process's rows of the residual stream.
    """
    bk = _resolve_backend(cfg, backend)
    # training inside ``model_split``: this process's heads
    split = cache is None and P.split_here(p["wq"].shape[1], cfg.q_dim)
    if cache is None and not split and P.split_rank() is not None:
        P.note_split("attn_whole_heads", cfg.n_heads)  # kv_seq: whole
    q, k, v = _project(p, x, cfg, split, seq, cross_kv)
    b, s = q.shape[0], q.shape[2]
    if cross_kv is not None:
        out = bk.prefill(q, k, v, cfg, causal=False)
    else:
        if cfg.use_rope:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        if page_table is not None and cache is not None:
            if kv_len is None:
                raise ValueError("paged cache needs page_table and kv_len")
            if cache["v_pages"].shape[1] != cfg.n_kv_heads:
                # a head-sharded pool slice: tensor-parallel serving
                out, cache = _tp_paged_decode(bk, q, cache, k, v, positions,
                                              page_table, kv_len, cfg,
                                              scale_base)
            else:
                out, cache = bk.paged_decode(q, cache, k, v, positions,
                                             page_table, kv_len, cfg,
                                             base=scale_base)
        elif cache is not None and "v" not in cache:
            # a paged pool reached the contiguous path: fail loudly
            raise ValueError("paged cache needs page_table and kv_len")
        else:
            index = 0 if cache_index is None else cache_index
            if cache is not None and kv_len is not None:
                out, cache = bk.decode(q, cache, k, v, index, kv_len,
                                       positions, cfg,
                                       kv_positions=kv_positions,
                                       window=window)
            else:
                cache = bk.write_cache(cache, k, v, index, cfg)
                out = bk.prefill(q, k, v, cfg, causal=causal,
                                 positions=positions,
                                 window=window or cfg.window)
    out = out.transpose(1, 2).reshape(b, s, -1) @ p["wo"].to(x.dtype)
    return P.region_out(out, split, seq), cache
