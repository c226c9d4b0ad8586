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
           "tp_local_decode", "tp_gather", "attn_strategy"]


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
    ``"whole"``).  ``q_seq`` is the sharded serving steps' (launch/
    steps.py): a prompt chunk's query rows split over ``model``
    (``att_q_seq``) when the axis divides them, K and V whole, softmax
    and AV local, the output rows entering ``wo`` split and gathered
    after it (``attention_block``); a decode row, or a chunk the axis
    does not divide, runs whole."""
    if model is None:
        return "none"
    if cfg.n_kv_heads % model == 0:
        return "heads"
    if cfg.n_heads % model == 0:
        return "qheads"
    return "kv_seq" if training else "q_seq"


def _heads_of(t, q0: int, hq: int, cfg):
    """Under ``qheads`` (``t``'s dim 1 holds every kv head, ``hq`` local q
    heads from q head ``q0``): the kv heads of the local q heads when the
    split follows the groups, else one copy of its kv head for each local
    q head."""
    g = cfg.n_heads // cfg.n_kv_heads
    if q0 % g == 0 and hq % g == 0:
        return t[:, q0 // g:(q0 + hq) // g]
    return t[:, torch.arange(q0, q0 + hq, device=t.device) // g]


def _project(p, x, cfg, split: bool = False, seq: bool = False,
             cross_kv=None, q_rows: bool = False, q_cols: bool = False):
    """QKV projections (+ optional bias) into (B, heads, S, head_dim);
    with ``cross_kv`` (cross-attention) K and V are those given.

    With ``split`` (inside ``partitioning.model_split``): the heads of
    this process.  ``wq`` (and ``wk``/``wv`` under ``heads``) then hold
    this process's columns and the biases are sliced to them; under
    ``qheads`` K and V come back whole (all kv heads, as the cache holds
    them) and ``attention_block`` gives each local q head its kv head's
    (``_heads_of``).  With ``seq`` x holds this process's rows of the
    split residual stream and the region runs on the gathered sequence
    (``partitioning.region_in``).  With ``q_rows`` (``q_seq``) Q is
    projected from this process's rows of x only.

    A serving step may keep a projection's stored column block where
    its heads do not divide (launch/steps.py, few token rows): this
    process then projects its columns and the features are all-gathered
    (``partitioning.gather_split``), whole Q (``q_cols``) or whole K and
    V on every process."""
    dt, d = x.dtype, cfg.head_dim
    rank = P.split_rank()[0] if P.split_rank() is not None else 0
    x = P.region_in(x, split, seq)
    b, s, _ = x.shape
    xq = P.local_seq(x) if q_rows else x
    q = xq @ p["wq"].to(dt)
    cols = p["wq"].shape[1]
    if q_cols:  # this process's columns of Q, gathered whole
        if "bq" in p:
            q = q + p["bq"][rank * cols:(rank + 1) * cols].to(dt)
        P.note_split("attn_q_cols", cols)
        q = P.gather_split(q, -1)
        hq, q0 = cfg.n_heads, 0
    else:
        hq = cols // d
        q0 = rank * hq if hq < cfg.n_heads else 0
        if "bq" in p:
            q = q + p["bq"][q0 * d:(q0 + hq) * d].to(dt)
    q = q.reshape(b, xq.shape[1], hq, d).transpose(1, 2)
    if cross_kv is None:
        kc = p["wk"].shape[1]
        c0 = rank * kc if kc < cfg.kv_dim else 0
        k = x @ p["wk"].to(dt)
        v = x @ p["wv"].to(dt)
        if "bk" in p:
            k = k + p["bk"][c0:c0 + kc].to(dt)
            v = v + p["bv"][c0:c0 + kc].to(dt)
        if kc < cfg.kv_dim and cfg.n_kv_heads % P.split_rank()[1]:
            P.note_split("attn_kv_cols", kc)  # whole K and V everywhere
            k, v = P.gather_split(k, -1), P.gather_split(v, -1)
        k = k.reshape(b, s, -1, d).transpose(1, 2)
        v = v.reshape(b, s, -1, d).transpose(1, 2)
    else:
        k, v = cross_kv
    if split:
        P.note_split("attn_q_heads", hq)
        P.note_split("attn_kv_heads", (
            _heads_of(k, q0, hq, cfg) if _qheads(hq, k, cfg) else k).shape[1])
    return q, k, v


def _qheads(hq: int, k, cfg) -> bool:
    """Whether ``hq`` local q heads run against whole K/V ``k``."""
    return hq < cfg.n_heads and k.shape[1] == cfg.n_kv_heads


def _attend_cache(bk, q, cache, heads, q0, kv_len, q_pos, cfg,
                  kv_positions, window):
    """The backend's attention of q over the written contiguous cache.
    Under ``qheads`` the cache holds every kv head: each local q head
    reads its kv head's (``heads``), unless the cache's sequence splits
    along ``model`` too, where the processes of a shard group hold
    different q heads: every process then gathers all the q heads
    (B, H, Sq, D), merges the shards' attention for all of them and
    keeps its own."""
    if heads(cache["v"]) is cache["v"]:
        return bk.attend(q, cache, kv_len, q_pos, cfg,
                         kv_positions=kv_positions, window=window)
    if P.cache_seq_over_model():
        hq = q.shape[1]
        out = bk.attend(P.gather_split(q, 1), cache, kv_len, q_pos, cfg,
                        kv_positions=kv_positions, window=window)
        return out[:, q0:q0 + hq]
    view = {n: heads(t) if t.dim() > 1 else t for n, t in cache.items()}
    return bk.attend(q, view, kv_len, q_pos, cfg, kv_positions=kv_positions,
                     window=window)


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

    Inside ``partitioning.model_split`` (the train step, and the sharded
    serving steps of launch/steps.py) this runs this process's heads
    (``_project``), cross-attention too (its K/V projected from the
    memory with this process's ``wk``/``wv`` columns, models/encdec.py),
    and sums the partial outputs over ``model``; with ``seq`` (the
    decoder-only stack's ``res_seq``) x and the output are this
    process's rows of the residual stream.  A contiguous cache then
    holds this process's kv heads (``heads``) or all of them
    (``qheads``: written whole, each local q head reading its kv head),
    and possibly only its block of the sequence
    (``partitioning.cache_seq_split``: the backend writes the positions
    the block holds and merges the shards' attention).  A serving chunk
    whose heads do not divide splits its query rows (``q_seq``:
    ``partitioning.q_seq_here``): Q and the output rows are this
    process's, K and V whole and written whole, and the rows are
    all-gathered after ``wo``.
    """
    bk = _resolve_backend(cfg, backend)
    at = P.split_rank()
    # a serving step kept wq's stored column block though the heads do
    # not divide (launch/steps.py): the projections' columns, whole heads
    cols = (at is not None and p["wq"].shape[1] < cfg.q_dim
            and cfg.n_heads % at[1] != 0)
    split = not cols and P.split_here(p["wq"].shape[1], cfg.q_dim)
    qseq = (cache is not None and not seq and not cols
            and P.q_seq_here(x.shape[1], split))
    if qseq:
        P.note_split("attn_q_rows", x.shape[1] // at[1])
    elif not split and at is not None:
        P.note_split("attn_whole_heads", cfg.n_heads)  # kv_seq: whole
    q, k, v = _project(p, x, cfg, split, seq, cross_kv, q_rows=qseq,
                       q_cols=cols)
    b, s = q.shape[0], q.shape[2]
    hq = q.shape[1]
    q0 = P.split_rank()[0] * hq if split and hq < cfg.n_heads else 0
    heads = (lambda t: _heads_of(t, q0, hq, cfg)) if _qheads(hq, k, cfg) \
        else (lambda t: t)
    if qseq:  # this process's query rows
        rows = s * P.split_rank()[0]
        q_pos = positions[:, rows:rows + s]
    else:
        q_pos = positions
    if cross_kv is not None:
        out = bk.prefill(q, heads(k), heads(v), cfg, causal=False)
    else:
        if cfg.use_rope:
            q = rope(q, q_pos, cfg.rope_theta)
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
            cache = bk.write_cache(cache, k, v, index, cfg)
            if cache is not None and kv_len is not None:
                out = _attend_cache(bk, q, cache, heads, q0, kv_len, q_pos,
                                    cfg, kv_positions, window)
            else:
                out = bk.prefill(q, heads(k), heads(v), cfg, causal=causal,
                                 positions=q_pos,
                                 window=window or cfg.window)
    out = out.transpose(1, 2).reshape(b, s, -1)
    if cols:  # wo's rows of this process's columns; the parts summed
        r = p["wo"].shape[0]
        return P.exit_split(out[..., at[0] * r:(at[0] + 1) * r]
                            @ p["wo"].to(x.dtype)), cache
    out = out @ p["wo"].to(x.dtype)
    if qseq:
        return P.whole_seq(out), cache
    return P.region_out(out, split, seq), cache
