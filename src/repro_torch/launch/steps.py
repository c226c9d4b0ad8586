"""Step functions: train, prefill and serve.

    train_step(state, batch) -> (state, metrics)
    prefill_step(params, batch, caches) -> (logits, caches)
    serve_step(params, tokens, pos, kv_len, caches) -> (logits, caches)

``md`` is the family's ``ModelDef`` (``models.get_model_def(cfg)``:
dense, MoE, VLM, encoder-decoder, Griffin hybrid or RWKV-6); its
``cache_specs(cfg, batch, cache_len)`` gives the caches the prefill and
serve steps take (``models.init_pools`` allocates them).  Each step
casts the parameters to the config's compute type first (a no-op for
parameters already in it) and calls the model's entry point; the batch
goes through as given, so a VLM batch takes ``batch["image_embeds"]``
(B, P, d) and an audio batch ``batch["audio_features"]`` (B, enc_len,
d) beside ``batch["tokens"]``.

The sharding assembly is the reference's: ``params_specs``,
``state_specs``, ``batch_specs`` and ``cache_specs_trees`` give every
argument's shapes and specs (``sharding/partitioning.py``) on a mesh, and
``named`` turns specs into DTensor placements on a live mesh.  With
``mesh=``, ``make_train_step`` is the sharded step (see its docstring),
``init_state`` gives a state of DTensor blocks, and ``batch_row_axes``
names the mesh axes a batch's rows are split over; ``make_prefill_step``
and ``make_serve_step`` are the sharded serving steps
(``_sharded_serve``) over ``serve_params`` / ``init_caches`` blocks and
``local_rows``, and ``serve_shares`` runs every rank's share of them in
one process.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.launch.inputs import batch_axes, input_specs, \
    serve_input_specs
from repro_torch.models.module import (cast_params, init_params, param_axes,
                                       tree_leaves, tree_map)
from repro_torch.models.transformer import dtype_of
from repro_torch.sharding import partitioning as P
from repro_torch.train.optimizer import (adamw, cosine_schedule,
                                         sharded_global_norm)

__all__ = ["METRIC_KEYS", "make_value_and_grad", "make_train_step",
           "model_split_plan", "model_shares", "share_params",
           "init_state", "make_prefill_step", "make_serve_step",
           "params_specs", "state_specs", "batch_specs", "cache_specs_trees",
           "cache_axes", "named", "batch_row_axes", "shard_tree",
           "map_specs", "serve_params", "init_caches", "local_rows",
           "serve_shares"]

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
                    total_steps=100_000, accum: int = 1, mesh=None,
                    row_axes=None):
    """Returns (train_step, optimizer).  state = {"params", "opt": {"m",
    "v", "step"}} with float32 masters (``init_state``); the step updates
    it in place and returns it with the metrics of ``METRIC_KEYS``
    (float32 0-d tensors; nothing is read back to the host).  With
    ``accum > 1`` the batch is cut along its rows into ``accum``
    microbatches whose gradients and losses are averaged (the other
    metrics are then 0, as in the reference).

    With a live ``mesh`` the step is sharded (``_sharded_step``): the
    state's params, m and v are DTensor blocks per ``PARAM_RULES``
    (``init_state(..., mesh=)``), the batch is this process's rows, split
    over the mesh axes ``row_axes`` (default ``batch_row_axes(mesh)``),
    and the metrics are the global batch's."""
    opt = adamw(cosine_schedule(peak_lr, warmup, total_steps))
    value_and_grad = make_value_and_grad(md, cfg)
    if mesh is not None:
        if row_axes is None:
            row_axes = batch_row_axes(mesh)
        return _sharded_step(md, cfg, opt, value_and_grad, accum, mesh,
                             tuple(row_axes)), opt

    def train_step(state, batch):
        params = state["params"]
        loss, aux, grads = _accumulate(value_and_grad, params, batch, accum)
        params, opt_state, ostats = opt.update(grads, state["opt"], params)
        raw = {"loss": loss, **ostats, **aux}
        metrics = {k: torch.as_tensor(raw.get(k, 0.0), dtype=torch.float32)
                   for k in METRIC_KEYS}
        return {"params": params, "opt": opt_state}, metrics

    return train_step, opt


def _accumulate(value_and_grad, params, batch, accum):
    """(loss, aux, grads) of the batch, or with ``accum > 1`` the means
    over its ``accum`` row microbatches of the losses and the float32
    gradients (aux then empty)."""
    if accum == 1:
        return value_and_grad(params, batch)
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    loss = 0.0
    for i in range(accum):
        mb = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])[i]
              for k, v in batch.items()}
        mb_loss, _, g = value_and_grad(params, mb)
        torch._foreach_add_(tree_leaves(gsum), tree_leaves(g))
        loss = loss + mb_loss
    torch._foreach_div_(tree_leaves(gsum), float(accum))
    return loss / accum, {}, gsum


# the families whose stack is models/transformer.lm_hidden: the ones
# whose residual stream the ``tp`` profile splits along the sequence
# (``res_seq``; the recurrent and encoder-decoder stacks keep ``"seq"``,
# as in the reference)
RES_SEQ_FAMILIES = ("dense", "moe", "vlm")


def model_split_plan(cfg, on_model, model: int, seq: bool = False) -> dict:
    """How the ``model``-split step treats each parameter, a tree in the
    structure of the parameters, for the ``tp`` profile on a mesh with a
    ``model`` axis of size ``model`` (``_sharded_step``); ``on_model`` is
    the tree of whether each leaf is split along ``model`` in storage
    (its resolved spec), ``seq`` whether the residual stream splits
    (``res_seq``):

      ``"split"``: kept split along ``model`` where the resolved spec put
          it; the model code runs on the local block (attention heads,
          MLP columns and rows, vocabulary rows, experts, RG-LRU
          channels, RWKV-6 heads) and its gradient is the local block's;
      ``"partial"``: gathered whole, but used only inside a split region
          or on this process's rows of the split stream (``wk``/``wv``
          under ``qheads``, the attention biases of split heads, the
          MLP's ``b_in``, the MoE router, the RG-LRU's per-channel
          vectors, RWKV-6's shift mixes, decay and group-norm scale;
          under ``seq`` the block norms, ``ln_f`` and ``b_out``): each
          process's gradient is its part, summed over ``model``;
      ``"whole"``: gathered whole and used whole (norms, ``b_out``, a
          block the resolver left unsplit, attention whose heads do not
          divide, an RWKV-6 time mix the resolver would cut inside a
          head): each process's gradient is the whole one."""
    from repro_torch.models.attention import attn_strategy

    strategy = attn_strategy(cfg, model)

    def module(mod, kind):
        if kind == "attn":  # heads follow wq; whole K/V serve the local q
            heads = strategy in ("heads", "qheads") and mod["wq"]
            return {k: ("whole" if not heads
                        else "split" if k in ("wq", "wo") or (
                            k in ("wk", "wv") and strategy == "heads"
                            and on)
                        else "partial") for k, on in mod.items()}
        if kind == "ffn" and "router" in mod:  # MoE: experts split
            experts = mod["w_gate"]
            return {k: ("whole" if not experts else
                        "partial" if k == "router" else "split")
                    for k in mod}
        if kind == "ffn":  # MLP: hidden units split
            mlp = mod["w_down"] if "w_down" in mod else mod["w_out"]
            return {k: ("partial" if k == "b_out" and seq
                        else "whole" if not mlp or k == "b_out"
                        else "partial" if k == "b_in" else "split")
                    for k in mod}
        if kind == "rec":  # RG-LRU: rnn channels split
            return {k: ("whole" if not mod["w_x"] else
                        "split" if on else "partial")
                    for k, on in mod.items()}
        if kind == "tm":  # RWKV-6 time mix: whole heads split
            heads = mod["wr"] and (cfg.d_model // cfg.rwkv_head_dim) \
                % model == 0
            return {k: ("whole" if not heads else
                        "split" if on else "partial")
                    for k, on in mod.items()}
        if kind == "cm":  # RWKV-6 channel mix: hidden units split
            return {k: ("split" if mod["wk"] and k in ("wk", "wv")
                        else "whole") for k in mod}
        if kind == "embed":  # vocabulary rows
            return {k: "split" if on else "whole" for k, on in mod.items()}
        if seq and kind in ("ln1", "ln2", "ln_f"):  # on local rows
            return dict.fromkeys(mod, "partial")
        return dict.fromkeys(mod, "whole")

    kinds = {"self_attn": "attn", "cross_attn": "attn", "mlp": "ffn"}

    def walk(node, kind=""):
        if isinstance(node, list):
            return [walk(v, kind) for v in node]
        leaves = {k: v for k, v in node.items()
                  if not isinstance(v, (dict, list))}
        if kind.startswith(("rec", "tail_rec")):
            kind = "rec"
        hows = module(leaves, kinds.get(kind, kind)) if leaves else {}
        return {k: hows[k] if k in hows else walk(v, k)
                for k, v in node.items()}

    return walk(on_model)


def _model_dim(spec):
    """The dimension a spec splits along ``model`` (None: none)."""
    for d, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple)
                                and "model" in entry):
            return d
    return None


def model_shares(md, cfg, model: int, seq: bool = False,
                 serve: bool = False):
    """(plan, dims) of the ``model`` split over a ``model`` axis of size
    ``model`` (the ``tp`` profile's specs on a (1, model) mesh; with
    ``serve`` the served weights' ``SERVE_PARAM_RULES``):
    ``model_split_plan``'s tree and, for each leaf, the dimension its
    ``"split"`` block is cut along (None for a leaf used whole), for
    ``share_params``."""
    from repro_torch.launch.mesh import MeshShape

    _, specs = params_specs(md, cfg, MeshShape(("data", "model"),
                                               (1, model)), serve=serve)
    plan = model_split_plan(
        cfg, map_specs(lambda sp: _model_dim(sp) is not None, specs), model,
        seq)
    return plan, map_specs(lambda sp, h: _model_dim(sp) if h == "split"
                           else None, specs, plan)


def share_params(params, dims, rank: int, size: int):
    """Rank ``rank``'s parameters of a ``model`` split of ``size`` from
    whole ones: each leaf's block along its dimension of ``dims``
    (``model_shares``), a view, so a backward pass through the share
    writes the block's gradient into the whole leaf's."""
    def block(t, d):
        if d is None:
            return t
        n = t.shape[d] // size
        return t.narrow(d, rank * n, n)

    return map_specs(block, params, dims)


def _sharded_step(md, cfg, opt, value_and_grad, accum, mesh, row_axes):
    """The train step on ``mesh``, each process holding its blocks of the
    state and its rows of the batch (split over ``row_axes``):

      1. every parameter is cast to the compute type and gathered over
         the mesh: whole, or, under the ``tp`` profile on a mesh with a
         ``model`` axis, over the other axes only where
         ``model_split_plan`` keeps it split along ``model``;
      2. ``value_and_grad`` runs on this process's rows inside
         ``sharded_batch``: its loss is this process's share of the
         global batch's (sums over the local rows divided by global
         counts, models/layers.py and models/moe.py), so the gradients
         of the processes along ``row_axes`` sum to the global gradient.
         With the ``model`` split it runs inside ``model_split`` too:
         the processes along ``model`` run the same rows, each on its
         blocks of the split regions (attention heads, cross-attention
         included, MLP hidden units, vocabulary rows, experts, RG-LRU
         channels, RWKV-6 heads: models/attention.py, layers.py,
         moe.py, rglru.py, rwkv6.py), and compute the same loss; for a
         family of ``RES_SEQ_FAMILIES`` whose P + S the ``model`` axis
         divides, each also holds only its rows of the residual stream
         between blocks (``res_seq``, models/transformer.lm_hidden);
      3. each gradient is summed over ``row_axes``, and over ``model``
         where it is a part (``"partial"`` leaves), and this process
         keeps its block (``Partial`` -> the parameter's placements: a
         reduce-scatter where the block is split along a summed axis,
         an all-reduce where it is replicated along one, a local slice
         along the others, whose processes computed the same rows; a
         ``"split"`` leaf's gradient is already its block along
         ``model``);
      4. AdamW updates the local blocks in place, clipped by the global
         norm (``sharded_global_norm``: each distinct block once);
      5. the metrics are summed over ``row_axes``: the global batch's
         (``tokens`` is already the global count).

    Attention whose heads do not divide ``model`` (``kv_seq``) runs whole
    on every process, as the reference's does: no rule table there has
    the ``att_kv_seq`` key its K/V constraint names, so its resolver
    replicates them (``models/attention.attn_strategy``).  The ``dp``
    profile gathers every parameter whole: its compute splits over the
    batch axes only.  The returned step's ``model_plan`` is the plan of
    the last step (None without the split)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    dt = dtype_of(cfg)
    names = tuple(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    split = P.get_parallelism_profile() == "tp" and "model" in names
    model = P.axis_sizes(mesh)["model"] if split else 1
    on_model = lambda p: p.placements[names.index("model")].is_shard()
    plans = {}  # model_split_plan's trees, by whether res_seq applies

    def counted(p):  # the first copy of a block replicated along a dim
        return all(c == 0 for c, pl in zip(coord, p.placements)
                   if pl.is_replicate())

    def gathered(p, h):  # the placements a leaf is gathered to
        return tuple(pl if a == "model" and h == "split" else Replicate()
                     for a, pl in zip(names, p.placements))

    def reduce_block(g, p, h):
        src = tuple(Partial() if a in row_axes
                    or (a == "model" and h == "partial")
                    else pl for a, pl in zip(names, gathered(p, h)))
        g = DTensor.from_local(g.to(torch.float32), mesh, src,
                               run_check=False)
        return g.redistribute(mesh, p.placements).to_local()

    def train_step(state, batch):
        params = state["params"]
        length = batch["tokens"].shape[1] + (
            batch["image_embeds"].shape[1] if "image_embeds" in batch
            else 0)
        seq = (split and cfg.family in RES_SEQ_FAMILIES
               and (model == 1 or length % model == 0))
        if seq not in plans:
            plans[seq] = (model_split_plan(cfg, tree_map(on_model, params),
                                           model, seq) if split
                          else tree_map(lambda _: "whole", params))
        plan = plans[seq]
        train_step.model_plan = plan if split else None
        with torch.no_grad():
            full = tree_map(lambda p, h: p.to(dt).redistribute(
                mesh, gathered(p, h)).to_local(), params, plan)
        ctx = P.model_split(mesh) if split else contextlib.nullcontext()
        with P.sharded_batch(mesh, row_axes), ctx:
            loss, aux, grads = _accumulate(value_and_grad, full, batch,
                                           accum)
            del full
            grads = tree_map(reduce_block, grads, params, plan)
            raw = {"loss": loss, **aux}
            keys = [k for k in ("loss", "ce", "moe_aux_loss",
                                "moe_drop_frac") if k in raw]
            sums = P.batch_sum(torch.stack(
                [torch.as_tensor(raw[k], dtype=torch.float32,
                                 device=loss.device) for k in keys]))
        raw.update(zip(keys, sums.unbind()))
        local = lambda tree: tree_map(lambda t: t.to_local(), tree)
        norm = sharded_global_norm(grads, tree_map(counted, params))
        _, opt_state, ostats = opt.update(
            grads, {"m": local(state["opt"]["m"]),
                    "v": local(state["opt"]["v"]),
                    "step": state["opt"]["step"]}, local(params), norm=norm)
        raw.update(ostats)
        metrics = {k: torch.as_tensor(raw.get(k, 0.0), dtype=torch.float32)
                   for k in METRIC_KEYS}
        return {"params": params,
                "opt": dict(state["opt"], step=opt_state["step"])}, metrics

    train_step.model_plan = None
    return train_step


def init_state(cfg, opt, *, seed: int = 0, device="cuda", mesh=None) -> dict:
    """A fresh train state: seeded float32 masters (``init_params``) and
    the optimizer's zeros.  With a live ``mesh``, params, m and v are
    DTensors holding this process's blocks (``state_specs``); every
    process draws the same masters and keeps its block."""
    params = init_params(cfg, device=device, seed=seed)
    if mesh is None:
        return {"params": params, "opt": opt.init(params)}
    from repro_torch.models import get_model_def

    plc = named(mesh, params_specs(get_model_def(cfg), cfg, mesh)[1])
    params = shard_tree(params, mesh, plc)
    zeros = lambda: tree_map(torch.zeros_like, params)
    return {"params": params, "opt": {"m": zeros(), "v": zeros(),
                                      "step": torch.zeros(
                                          (), dtype=torch.int32)}}


def make_prefill_step(md, cfg, mesh=None):
    """``prefill_step(params, batch, caches) -> (logits, caches)``: the
    prompt from position 0, the caches written in place, the last
    position's logits (B, V_pad) float32.  With a live ``mesh`` the
    sharded step (``_sharded_serve``)."""
    if mesh is not None:
        return _sharded_serve(md, cfg, mesh, "prefill")
    dt = dtype_of(cfg)

    def prefill_step(params, batch, caches):
        return md.prefill(cast_params(params, dt), batch, caches, cfg)

    return prefill_step


def make_serve_step(md, cfg, mesh=None):
    """``serve_step(params, tokens, pos, kv_len, caches) -> (logits,
    caches)``: one decode step, tokens / pos / kv_len (B,).  With a live
    ``mesh`` the sharded step (``_sharded_serve``)."""
    if mesh is not None:
        return _sharded_serve(md, cfg, mesh, "decode")
    dt = dtype_of(cfg)

    def serve_step(params, tokens, pos, kv_len, caches):
        return md.decode(cast_params(params, dt), tokens, pos, kv_len,
                         caches, cfg)

    return serve_step


# cache leaves whose sequence split the sharded serving steps undo around
# the call (all-gathered, then this process's block written back): the
# encoder memory every step rereads whole, and a ring's slot positions
_SEQ_GATHERED = ("memory", "attn_pos")


def _leaf_names(tree, name=""):
    """Each leaf's key, in the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: _leaf_names(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaf_names(v, name) for v in tree]
    return name


def _seq_dim(name: str):
    """The sequence dim of a cache leaf (None: it has none)."""
    axes = _CACHE_AXES[name]
    return axes.index("kv_seq") if "kv_seq" in axes else None


def _serve_split(mesh, row_axes) -> bool:
    """Whether the serving steps split the compute over ``model``: the
    mesh has the axis and the batch's rows do not take it (under the
    ``dp`` profile a batch that every axis divides does; each process
    then runs its rows whole)."""
    return "model" in mesh.mesh_dim_names and "model" not in row_axes


def _sharded_serve(md, cfg, mesh, kind):
    """The prefill (``kind`` "prefill") or decode step on ``mesh``, one
    process a device, as the reference's jitted steps with explicit
    shardings (its ``launch/dryrun.py``):

      * ``params`` are DTensor blocks under ``SERVE_PARAM_RULES``
        (``serve_params``), cast to the compute type; under the split a
        block ``model_split_plan`` keeps split is used as it is, every
        other leaf is gathered whole;
      * ``caches`` are DTensor blocks under ``CACHE_RULES``
        (``init_caches``), written in place: heads over ``model`` where
        they divide, the sequence over what the batch and heads left
        (``kv_seq``), the recurrent states' channels and heads over
        ``model``; ``_SEQ_GATHERED`` leaves are gathered whole along the
        sequence around the call and this process's block written back;
      * the batch (``batch`` dict, or tokens / pos / kv_len) is this
        process's rows over ``batch_row_axes`` of the caches' batch
        (``local_rows``);
      * the logits come back as DTensor blocks on ``("batch", "vocab")``
        under ``ACT_RULES``: ``full_tensor()`` is the unsharded step's.

    The model runs inside ``partitioning.model_split`` when
    ``_serve_split`` (each process its heads, or under ``q_seq`` its
    query rows, MLP columns, experts, vocabulary rows, RG-LRU channels,
    RWKV-6 heads) and inside ``partitioning.cache_seq_split`` over the
    attention caches' sequence axes, under ``torch.no_grad``.  Every
    process of the mesh calls the step with the same global shapes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    dt = dtype_of(cfg)
    names = tuple(mesh.mesh_dim_names)
    sizes = P.axis_sizes(mesh)
    on_model = lambda p: p.placements[names.index("model")].is_shard()
    plans = {}

    def gathered(p, h):  # the placements a parameter is used at
        return tuple(pl if a == "model" and h == "split" else Replicate()
                     for a, pl in zip(names, p.placements))

    def seq_axes(c, dim):  # the mesh axes splitting dim of a cache leaf
        return tuple(a for a, pl in zip(names, c.placements)
                     if isinstance(pl, Shard) and pl.dim == dim)

    def serve_step(params, *args):
        caches = args[-1]
        rows = _global_batch(caches)
        row_axes = batch_row_axes(mesh, rows)
        split = _serve_split(mesh, row_axes)
        columns = split and _local_columns(cfg, args)
        if (split, columns) not in plans:
            plans[split, columns] = (model_split_plan(
                cfg, tree_map(on_model, params), sizes["model"])
                if split else tree_map(lambda _: "whole", params))
            if columns:
                plans[split, columns] = _keep_columns(
                    plans[split, columns], tree_map(on_model, params), kind)
        plan = plans[split, columns]
        leaf_names = _leaf_names(caches)
        attn = set()
        back = []  # (DTensor leaf, whole-along-seq local tensor, dim)

        def local(c, name):
            dim = _seq_dim(name)
            if name not in _SEQ_GATHERED or not seq_axes(c, dim):
                if name in ("k", "v", "k_packed"):
                    attn.add(seq_axes(c, dim))
                return c.to_local()
            whole = c.redistribute(mesh, tuple(
                Replicate() if a in seq_axes(c, dim) else pl
                for a, pl in zip(names, c.placements))).to_local()
            back.append((c, whole, dim))
            return whole

        with torch.no_grad():
            full = tree_map(lambda p, h: p.to(dt).redistribute(
                mesh, gathered(p, h)).to_local(), params, plan)
            given = map_specs(local, caches, leaf_names)
            local_caches = map_specs(lambda t: t, given)
            if len(attn) > 1:
                raise ValueError(f"the attention caches split their "
                                 f"sequence differently: {sorted(attn)}")
            seq = attn.pop() if attn else ()
            ctx = P.model_split(mesh) if split else contextlib.nullcontext()
            with ctx, P.cache_seq_split(mesh, seq):
                if kind == "prefill":
                    logits, _ = md.prefill(full, args[0], local_caches, cfg)
                else:
                    logits, _ = md.decode(full, *args[:3], local_caches,
                                          cfg)
            _write_back(given, local_caches)
            for c, whole, dim in back:  # this process's block of the seq
                n = c.to_local().shape[dim]
                shard = 0
                for a in seq_axes(c, dim):
                    shard = shard * sizes[a] + mesh.get_local_rank(a)
                c.to_local().copy_(whole.narrow(dim, shard * n, n))
        spec = P.resolve_spec(("batch", "vocab"), (rows, cfg.padded_vocab),
                              mesh, P.ACT_RULES)
        return DTensor.from_local(logits, mesh, P.placements(spec, mesh),
                                  run_check=False), caches

    return serve_step


def _write_back(given, after):
    """Copy into each tensor of ``given`` the tensor a step left at its
    place in ``after`` where the step replaced it (a backend may assign
    a cache leaf anew, as camformer's running ``k_scale``)."""
    map_specs(lambda g, a: None if a is g else g.copy_(a), given, after)


def _tokens(args) -> int:
    """This process's token rows in a serving step's inputs: the batch
    dict's tokens and prefix embeddings (prefill), or the decode
    tokens."""
    first = args[0]
    if not isinstance(first, dict):
        return first.shape[0]
    rows, length = first["tokens"].shape
    return rows * (length + (first["image_embeds"].shape[1]
                             if "image_embeds" in first else 0))


def _local_columns(cfg, args) -> bool:
    """Whether a serving step keeps the attention projections' stored
    column blocks where the heads do not divide (``_keep_columns``):
    with fewer token rows a process than d_model, all-gathering the
    projected features moves less than gathering the weights (tokens x
    columns against d_model x columns elements)."""
    return _tokens(args) < cfg.d_model


def _keep_columns(plan, on_model, kind):
    """The serving plan with self-attention's projections kept as their
    stored column blocks (split along ``model`` in storage) where the
    train step's plan gathers them whole: ``wk`` / ``wv`` under
    ``qheads`` (``"partial"``), and in a decode step, whose single query
    row ``q_seq`` cannot split, every projection of an attention run
    whole (``"whole"``).  The model code then projects its columns and
    all-gathers the features, and sums ``wo``'s row blocks
    (``models/attention.py``)."""
    def keep(name, how, on):
        if not on or how == "split":
            return how
        if name in ("wk", "wv") and how == "partial":
            return "split"
        if (kind == "decode" and how == "whole"
                and name in ("wq", "wk", "wv", "wo")):
            return "split"
        return how

    def walk(node, on, key=""):
        if isinstance(node, list):
            return [walk(n, o, key) for n, o in zip(node, on)]
        if not isinstance(node, dict):
            return node
        if key in ("attn", "self_attn") and "wq" in node:
            return {k: keep(k, h, on[k]) for k, h in node.items()}
        return {k: walk(v, on[k], k) for k, v in node.items()}

    return walk(plan, on_model)


def _global_batch(caches) -> int:
    """The global batch of a tree of cache DTensors (their global
    shapes), read off a leaf with a ``batch`` axis."""
    found = []

    def visit(c, name):
        axes = _CACHE_AXES[name]
        if not found and "batch" in axes:
            found.append(c.shape[axes.index("batch")])

    map_specs(visit, caches, _leaf_names(caches))
    return found[0]


def serve_params(params, md, cfg, mesh):
    """Whole served weights (the same on every process) -> DTensors of
    this process's blocks under ``SERVE_PARAM_RULES``."""
    return shard_tree(params, mesh, named(
        mesh, params_specs(md, cfg, mesh, serve=True)[1]))


def init_caches(md, cfg, batch: int, cache_len: int, mesh=None,
                device="cuda"):
    """Zero caches for ``batch`` rows of ``cache_len`` (``md.cache_specs``):
    whole tensors, or with a live ``mesh`` DTensors of this process's
    blocks under ``CACHE_RULES`` (``cache_specs_trees``), allocated at
    the block's size."""
    from repro_torch.models.transformer import init_pools

    if mesh is None:
        return init_pools(md.cache_specs(cfg, batch, cache_len), device)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    tree, specs = cache_specs_trees(md, cfg, batch, cache_len, mesh)

    def block(leaf, spec):
        shape, dtype = leaf
        plc = P.placements(spec, mesh)
        local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                         plc)
        return DTensor.from_local(
            torch.zeros(local, dtype=dtype, device=device), mesh, plc,
            run_check=False, shape=torch.Size(shape),
            stride=_contiguous_stride(shape))

    return map_specs(block, tree, specs)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def local_rows(tree, mesh, global_batch: int):
    """This process's rows (dim 0) of whole batch tensors (a tensor or a
    dict of them), split over ``batch_row_axes(mesh, global_batch)``
    major-to-minor."""
    axes = batch_row_axes(mesh, global_batch)
    sizes = P.axis_sizes(mesh)
    n = math.prod(sizes[a] for a in axes)
    k = 0
    for a in axes:
        k = k * sizes[a] + mesh.get_local_rank(a)
    cut = lambda t: t.narrow(0, k * (t.shape[0] // n), t.shape[0] // n)
    return {key: cut(t) for key, t in tree.items()} \
        if isinstance(tree, dict) else cut(tree)


def serve_shares(md, cfg, kind, params, args, caches, model: int):
    """Every rank's share of the sharded serving step's split over a
    ``model`` axis of ``model`` in turn in this process (share mode:
    ``partitioning.run_shares``), from whole ``params`` and ``caches``
    and the whole batch ``args`` (``(batch,)`` for ``kind`` "prefill",
    ``(tokens, pos, kv_len)`` for "decode"), on a (1, model) mesh's
    specs: each rank runs on its parameter blocks (``share_params``
    with ``model_shares(..., serve=True)``) and on its blocks of the
    caches split along ``model`` (views: its writes land in ``caches``),
    the attention caches' sequence split along ``model`` inside
    ``cache_seq_split`` where ``CACHE_RULES`` puts it there.  A leaf not
    split along ``model`` (or a ``_SEQ_GATHERED`` one) is each rank's
    own copy, rank 0's written back after.  Returns each rank's logits
    (its vocabulary block where the vocabulary splits)."""
    from repro_torch.launch.mesh import MeshShape

    mesh = MeshShape(("data", "model"), (1, model))
    plan, dims = model_shares(md, cfg, model, serve=True)
    if _local_columns(cfg, args):  # as the live step chooses
        _, specs = params_specs(md, cfg, mesh, serve=True)
        plan = _keep_columns(plan, map_specs(
            lambda sp: _model_dim(sp) is not None, specs), kind)
        dims = map_specs(lambda sp, h: _model_dim(sp) if h == "split"
                         else None, specs, plan)
    shapes = map_specs(lambda leaf: tuple(leaf.shape), caches)
    cspecs = P.tree_pspecs(cache_axes(shapes), shapes, mesh,
                           P.CACHE_RULES)
    cdims = map_specs(_model_dim, cspecs)
    names = _leaf_names(caches)
    attn = set()
    map_specs(lambda d, n: attn.add(d == _seq_dim(n))
              if n in ("k", "v", "k_packed") else None, cdims, names)
    seq = ("model",) if True in attn else ()
    copies = []

    def block(t, d, n, rank):
        if d is None or n in _SEQ_GATHERED:
            c = t.clone()
            copies.append((rank, t, c))
            return c
        size = t.shape[d] // model
        return t.narrow(d, rank * size, size)

    def share(rank):
        given = map_specs(lambda t, d, n: block(t, d, n, rank), caches,
                          cdims, names)
        mine = map_specs(lambda t: t, given)
        p = share_params(params, dims, rank, model)
        if kind == "prefill":
            out = md.prefill(p, args[0], mine, cfg)[0]
        else:
            out = md.decode(p, *args, mine, cfg)[0]
        _write_back(given, mine)
        return out

    dt = dtype_of(cfg)
    params = cast_params(params, dt)
    with torch.no_grad(), P.cache_seq_split(None, seq):
        outs = P.run_shares(share, model)
    for rank, t, c in copies:
        if rank == 0:
            t.copy_(c)
    return outs


# ---------------- sharding assembly ----------------

def map_specs(fn, tree, *rest):
    """``fn`` over the leaves of a dict/list tree (and the matching
    leaves of ``rest``), whose leaves may be tuples (shapes, specs,
    placements), which ``tree_map`` would walk into."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def params_specs(md, cfg, mesh, *, serve: bool = False):
    """(shape tree, spec tree) of the parameters on ``mesh``: the float32
    masters under ``PARAM_RULES``, or with ``serve`` the served weights
    under ``SERVE_PARAM_RULES``."""
    shapes = map_specs(lambda leaf: tuple(leaf[0]), md.shapes(cfg))
    rules = P.SERVE_PARAM_RULES if serve else P.PARAM_RULES
    return shapes, P.tree_pspecs(param_axes(cfg), shapes, mesh, rules)


def state_specs(md, cfg, mesh):
    """(shape tree, spec tree) of the full train state: params, m and v
    share the parameters' specs, ``step`` is a replicated scalar."""
    shapes, pspecs = params_specs(md, cfg, mesh)
    return ({"params": shapes, "opt": {"m": shapes, "v": shapes,
                                       "step": ()}},
            {"params": pspecs, "opt": {"m": pspecs, "v": pspecs,
                                       "step": ()}})


def batch_specs(cfg, shape_name, mesh, *, serve=False):
    """({name: (shape, dtype)}, {name: spec}) of a batch under
    ``ACT_RULES``."""
    specs = (serve_input_specs if serve else input_specs)(cfg, shape_name)
    axes = batch_axes(cfg, shape_name, serve=serve)
    return specs, {k: P.resolve_spec(axes[k], specs[k][0], mesh, P.ACT_RULES)
                   for k in specs}


# logical axes of each contiguous-cache leaf (the reference's
# ``cache_specs``; the port keeps a per-layer list where the reference
# stacks along a leading ``layers`` axis, RWKV-6's state excepted)
_CACHE_AXES = {
    "k": ("batch", "kv_heads", "kv_seq", "head_dim"),
    "v": ("batch", "kv_heads", "kv_seq", "head_dim"),
    "k_packed": ("batch", "kv_heads", "kv_seq", None),
    "k_scale": ("batch", "kv_heads"),
    "conv": ("batch", "conv", "rnn"),
    "h": ("batch", "rnn"),
    "attn_pos": ("batch", "kv_seq"),
    "memory": ("batch", "kv_seq", "embed"),
    "tm_prev": ("layers", "batch", "embed"),
    "cm_prev": ("layers", "batch", "embed"),
    "wkv": ("layers", "batch", "heads", None, None),
}


def cache_axes(tree):
    """The logical-axes tree of a cache-spec tree (``md.cache_specs``)."""
    if isinstance(tree, list):
        return [cache_axes(v) for v in tree]
    return {k: cache_axes(v) if isinstance(v, (dict, list))
            else _CACHE_AXES[k] for k, v in tree.items()}


def cache_specs_trees(md, cfg, batch: int, cache_len: int, mesh):
    """(cache-spec tree of (shape, dtype), spec tree) under
    ``CACHE_RULES``."""
    tree = md.cache_specs(cfg, batch, cache_len)
    shapes = map_specs(lambda leaf: tuple(leaf[0]), tree)
    return tree, P.tree_pspecs(cache_axes(tree), shapes, mesh, P.CACHE_RULES)


def named(mesh, specs):
    """A spec tree -> the tree of its DTensor placements on ``mesh``."""
    return map_specs(lambda spec: P.placements(spec, mesh), specs)


def batch_row_axes(mesh, global_batch: int | None = None) -> tuple:
    """The mesh axes a batch of ``global_batch`` rows is split over
    (``ACT_RULES["batch"]``); by default those of a batch that every axis
    divides."""
    rows = global_batch or math.prod(P.axis_sizes(mesh).values())
    entry = P.resolve_spec(("batch",), (rows,), mesh, P.ACT_RULES)[0]
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def shard_tree(tree, mesh, plc):
    """Whole tensors (the same on every process) -> DTensors of this
    process's blocks, sliced locally (no communication)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.train.checkpoint import local_block

    return map_specs(lambda t, p: DTensor.from_local(
        local_block(t, mesh, p).clone(), mesh, p, run_check=False),
        tree, plc)

