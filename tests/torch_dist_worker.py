"""One rank of the port's 4-process gloo run (a helper of
``tests/test_torch_distributed.py``, not a test module).

    python tests/torch_dist_worker.py RANK WORLD OUT_DIR

Rendezvous through a file under OUT_DIR (no TCP port).  Each rank runs
the port's distributed pieces on inputs made from numpy seeds and writes
what it saw to OUT_DIR/rank<RANK>.pt; the test compares the ranks with
one another and with the JAX package in the pytest process.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

SEED = 0
TRAIN_CASES = (  # (name, arch, smoke overrides)
    ("granite", "granite-moe-3b-a800m", dict(n_experts_padded=8)),
    ("camformer", "camformer-bert", dict(attn_backend="camformer")),
)
TRAIN_STEPS = 3


def _np(t):
    return t.detach().cpu().numpy()


def _local_tree(tree):
    """{path: (local block, sharded mesh dims)} of a state's leaves."""
    from torch.distributed.tensor import DTensor

    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        elif isinstance(node, DTensor):
            out["/".join(path)] = (_np(node.to_local()), tuple(
                i for i, p in enumerate(node.placements) if p.is_shard()))
    walk(tree, ())
    return out


def train_part(out_dir):
    """The sharded train step on make_mesh_for(4, 2) from the JAX
    package's initial state (restored onto the mesh), under the dp and
    then the tp profile: 3 steps' metrics, AdamW's m after step 1,
    gathered ((1 - b1) x the clipped gradients), and every rank's blocks
    after the last step; then a checkpoint on (2, 2) restored onto
    (4, 1)."""
    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.launch.elastic import rescale_state, verify_rescale
    from repro_torch.launch.mesh import make_mesh_for, set_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model_def
    from repro_torch.sharding.partitioning import set_parallelism_profile
    from repro_torch.train.checkpoint import host_state, save_checkpoint
    from repro_torch.train.data import SyntheticLMData

    SHAPES["tiny"] = dict(seq_len=64, global_batch=8, kind="train")
    mesh = make_mesh_for(4, 2)
    set_mesh(mesh)
    res = {}

    def run(name, arch, over):
        cfg = smoke_config(arch, **over)
        md = get_model_def(cfg)
        data = SyntheticLMData(cfg, "tiny", seed=1, device="cpu", mesh=mesh)
        step, opt = make_train_step(md, cfg, warmup=1, mesh=mesh,
                                    row_axes=data.row_axes)
        # the JAX package's initial state, written by the test
        state, _ = rescale_state(os.path.join(out_dir, f"jax_{name}"), md,
                                 cfg, mesh)
        metrics, grads1 = [], None
        for i in range(TRAIN_STEPS):
            state, m = step(state, data.batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:  # (1 - b1) times the clipped gradients
                grads1 = host_state(state["opt"]["m"])
        return cfg, md, data, state, dict(
            metrics=metrics, grads1=grads1, rows=list(data.rows),
            blocks=_local_tree(state["params"]))

    # the dp profile: rows over (data, model), embed over both too, so
    # every gradient is Partial over every axis
    set_parallelism_profile("dp")
    try:
        for name, arch, over in TRAIN_CASES:
            res["dp_" + name] = run(name, arch, over)[-1]
    finally:
        set_parallelism_profile("tp")
    for name, arch, over in TRAIN_CASES:
        cfg, md, data, state, res[name] = run(name, arch, over)
        if name == "camformer":  # one step as two microbatches
            step2, _ = make_train_step(md, cfg, warmup=1, accum=2, mesh=mesh,
                                       row_axes=data.row_axes)
            fresh, _ = rescale_state(os.path.join(out_dir, f"jax_{name}"),
                                     md, cfg, mesh)
            res["accum2"] = {k: float(v) for k, v in
                             step2(fresh, data.batch(0))[1].items()}
            ck = os.path.join(out_dir, "ckpt_22")
            save_checkpoint(ck, state, TRAIN_STEPS)
            mesh_b = make_mesh_for(4, 1)
            state_b, at = rescale_state(ck, md, cfg, mesh_b)
            res["rescale"] = dict(step=at, same=verify_rescale(state,
                                                               state_b),
                                  blocks=_local_tree(state_b["params"]))
            if dist.get_rank() == 0:
                res["saved_state"] = host_state(state)
            else:
                host_state(state)
    set_mesh(None)
    return res


def jax_ckpt_part(out_dir):
    """The JAX package's checkpoint (written by the test) restored onto
    (2, 2): this rank's blocks."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.elastic import rescale_state
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import get_model_def

    cfg = smoke_config("codeqwen1.5-7b")
    state, at = rescale_state(os.path.join(out_dir, "jax_ckpt"),
                              get_model_def(cfg), cfg, make_mesh_for(4, 2))
    return dict(step=at, blocks=_local_tree(state))


def pipeline_part():
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.pipeline import pipeline_forward

    s, mb, d = 4, 3, 16
    rng = np.random.default_rng(SEED)
    ws = torch.from_numpy((rng.standard_normal((s, d, d)) / d**0.5)
                          .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((5, mb, d)).astype(np.float32))
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("pipe",))
    return _np(pipeline_forward(lambda w, h: torch.tanh(h @ w), ws, x, mesh))


def compression_part():
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding.compression import compressed_psum_leaf

    g = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (4, 64)).astype(np.float32))
    grp = init_device_mesh("cpu", (4,), mesh_dim_names=("pod",)).get_group(
        "pod")
    mine = g[dist.get_rank()]
    err = torch.zeros_like(mine)
    first, _ = compressed_psum_leaf(mine, err, grp)
    acc = torch.zeros(64, dtype=torch.float64)
    for _ in range(60):
        est, err = compressed_psum_leaf(mine, err, grp)
        acc += est.double()
    return dict(first=_np(first), avg=_np(acc / 60))


def cam_part():
    """The test's distributed CAM search case on (2, 2): B = 1, 4 heads on
    2 kv heads, head_dim 128, S = 64 (16 a shard), k_top 8.  The search
    on the whole cache, and a ``distributed_topk`` decode through
    ``decode`` that writes its key and value at position 40 (the third
    shard's) into the whole cache, beside the flag-off decode."""
    from repro_torch.configs import smoke_config
    from repro_torch.core import bacam
    from repro_torch.core.backend import get_backend
    from repro_torch.core.binarize import sign_pm1
    from repro_torch.launch.mesh import make_mesh_for, set_mesh

    cfg = smoke_config("codeqwen1.5-7b", head_dim=128, n_heads=4,
                       n_kv_heads=2).replace(attn_backend="camformer",
                                             k_top=8, group_size=4,
                                             stage1_k=2)
    rng = np.random.default_rng(SEED + 3)
    k_raw = torch.from_numpy(rng.standard_normal((1, 2, 64, 128)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 64, 128)).astype(
        np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 4, 1, 128)).astype(
        np.float32))
    k_new = torch.from_numpy(rng.standard_normal((1, 2, 1, 128)).astype(
        np.float32))
    v_new = torch.from_numpy(rng.standard_normal((1, 2, 1, 128)).astype(
        np.float32))
    cache = {"k_packed": bacam.pack_bits(sign_pm1(k_raw)), "v": v,
             "k_scale": k_raw.abs().mean(dim=(2, 3))}
    pos = torch.full((1, 1), 40, dtype=torch.int32)
    kvl = torch.full((1,), 41, dtype=torch.int32)
    bk = get_backend("camformer")
    fresh = lambda: {k: t.clone() for k, t in cache.items()}

    def decode(flag):
        return bk.decode(q, fresh(), k_new, v_new,
                         torch.full((1,), 40, dtype=torch.int32), kvl, pos,
                         cfg.replace(distributed_topk=flag))

    local = bk._cache_attend(q, cache, kvl, pos, cfg)
    dec_off, cache_off = decode(False)
    set_mesh(make_mesh_for(4, 2))
    try:
        dist_out = bk._distributed_attend(q, cache, kvl, pos, cfg)
        dec, cache_on = decode(True)
    finally:
        set_mesh(None)
    return dict(local=_np(local), dist=_np(dist_out), dec=_np(dec),
                dec_off=_np(dec_off),
                cache={k: _np(t) for k, t in cache_on.items()},
                cache_off={k: _np(t) for k, t in cache_off.items()})


def cli_part(out_dir):
    from repro_torch.launch import train

    trainer = train.main([
        "--arch", "camformer-bert", "--smoke", "--steps", "2", "--devices",
        "4", "--model-parallel", "2", "--device", "cpu", "--ckpt-every",
        "2", "--ckpt-dir", os.path.join(out_dir, "cli_ckpt")])
    return dict(log=trainer.metrics_log, rows=list(trainer.data.rows))


def main():
    rank, world, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
        rank=rank, world_size=world)
    res, took = {}, {}
    try:
        for name, part in (("train", lambda: train_part(out_dir)),
                           ("jax_ckpt", lambda: jax_ckpt_part(out_dir)),
                           ("pipeline", pipeline_part),
                           ("compression", compression_part),
                           ("cam", cam_part),
                           ("cli", lambda: cli_part(out_dir))):
            t0 = time.perf_counter()
            res[name] = part()
            took[name] = time.perf_counter() - t0
        res["seconds"] = took
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
