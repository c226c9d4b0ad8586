"""One rank of the port's 4-process gloo run of the sharded contiguous
prefill and serve steps (a helper of ``tests/test_torch_serve_split.py``,
not a test module).

    python tests/torch_serve_worker.py RANK WORLD OUT_DIR

Rendezvous through a file under OUT_DIR (no TCP port).  For each case of
``CASES`` every rank loads the whole parameters the test wrote
(OUT_DIR/params_<name>.pt, the JAX package's weights through
``from_jax_params``), builds make_mesh_for(4, its model size) under its
profile, hands ``make_prefill_step(mesh=)`` / ``make_serve_step(mesh=)``
its blocks (``serve_params``, ``init_caches``, ``local_rows``) and runs
the prompt (OUT_DIR/prompt_<name>.pt) and ``STEPS`` greedy steps.  Each
rank writes the gathered logits, the greedy tokens, the gathered caches
and the regions' local extents (``SPLIT_SEEN``) to OUT_DIR/rank<RANK>.pt.
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

# (name, arch, smoke overrides, model-axis size, batch, profile)
CASES = (
    # heads: 4 kv heads over model = 2, rows over data = 2
    ("camformer", "camformer-bert", dict(attn_backend="camformer"), 2, 4,
     "tp"),
    ("dense_m4", "camformer-bert", dict(attn_backend="dense"), 4, 4, "tp"),
    # MoE (qheads: 4 q heads on 1 kv head; experts over model); no token
    # is dropped at capacity_factor = E / k, so the per-process dispatch
    # groups give the unsharded routing
    ("granite", "granite-moe-3b-a800m",
     dict(n_experts_padded=8, capacity_factor=4.0), 2, 4, "tp"),
    # q_seq prefill and a kv_seq-split ring: 6 q heads on 1 kv head at 4
    ("rg_q_seq", "recurrentgemma-2b", dict(n_heads=6), 4, 2, "tp"),
    # qheads at 2 with the ring split over model too
    ("rg_qheads", "recurrentgemma-2b", dict(n_heads=6), 2, 2, "tp"),
    # B = 1 distributed CAM search: the cache sequence over (data, model)
    ("dist_topk", "mistral-nemo-12b",
     dict(attn_backend="camformer", distributed_topk=True), 2, 1, "tp"),
    # dp: the rows take every axis, each process runs its row whole
    ("dp", "camformer-bert", dict(attn_backend="dense"), 2, 4, "dp"),
)
PROMPT_LEN, CACHE_LEN, STEPS = 16, 32, 8


def _plain(tree):
    """DTensor leaves gathered whole, as plain tensors."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    return tree.full_tensor() if hasattr(tree, "full_tensor") else tree


def run_case(out_dir, name, arch, over, model, batch, profile):
    """Prefill and ``STEPS`` greedy decode steps on make_mesh_for(4,
    model): the logits of every step, the tokens, the caches."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import get_model_def
    from repro_torch.sharding import partitioning as P

    P.set_parallelism_profile(profile)
    try:
        cfg = smoke_config(arch, **over)
        md = get_model_def(cfg)
        mesh = make_mesh_for(4, model)
        params = S.serve_params(
            torch.load(os.path.join(out_dir, f"params_{name}.pt")), md,
            cfg, mesh)
        prompt = torch.load(os.path.join(out_dir, f"prompt_{name}.pt"))
        caches = S.init_caches(md, cfg, batch, CACHE_LEN, mesh,
                               device="cpu")
        prefill = S.make_prefill_step(md, cfg, mesh=mesh)
        serve = S.make_serve_step(md, cfg, mesh=mesh)
        P.SPLIT_SEEN.clear()
        logits, caches = prefill(params, S.local_rows(
            {"tokens": prompt}, mesh, batch), caches)
        logits = logits.full_tensor()
        outs, toks = [logits], []
        for i in range(STEPS):
            tok = logits.argmax(-1).to(torch.int32)
            toks.append(tok)
            pos = torch.full((batch,), PROMPT_LEN + i, dtype=torch.int32)
            logits, caches = serve(params, *(S.local_rows(t, mesh, batch)
                                             for t in (tok, pos, pos + 1)),
                                   caches)
            logits = logits.full_tensor()
            outs.append(logits)
        return dict(logits=outs, tokens=toks, caches=_plain(caches),
                    seen=dict(P.SPLIT_SEEN))
    finally:
        P.set_parallelism_profile("tp")


def main():
    rank, world, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
        rank=rank, world_size=world)
    try:
        res = {case[0]: run_case(out_dir, *case) for case in CASES}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
