"""The port's step counts (``utils/hlo.py``) and roofline arithmetic
(``launch/analysis.py``) against the reference's.

  * The reference's three ``tests/test_hlo_analysis.py`` cases, for an
    eager loop: a 10-step loop counts 10x, 4 x 3 nested loops count 12x,
    a program without a loop counts once with 0 collective bytes.
  * An all-gather and an all-reduce of known blocks under a fake group
    count the reference's ring bytes: max(in, out), an all-reduce twice.
  * ``roofline_terms`` equals the reference's function on the same
    stats dict with the reference module's constants set to the port's
    H100 ones (``monkeypatch``, in this test only).
  * Per-device FLOPs of two smoke cells, a ``train_4k`` step and a
    ``decode_32k`` step of ``codeqwen1.5-7b`` at f32 smoke width on the
    dense backend, with the shapes cut to smoke size, on a (2, 4) mesh:
    the port's count (the sharded step on the meta device as rank 0 of a
    fake group of 8) within 2% of the reference's ``analyze_hlo`` of its
    compiled step on 8 host devices.  The reference runs once for the
    module, in a subprocess that sets ``XLA_FLAGS`` before it imports
    jax.  Both count matrix products only: neither counts elementwise
    work, the embedding gather or its scatter-add gradient, which in
    both packages are no dot.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.configs import SHAPES, smoke_config
from repro_torch.launch import analysis as TA
from repro_torch.utils.hlo import analyze_step

ROOT = Path(__file__).resolve().parents[1]
# (arch, overrides, shape name, the shape cut to smoke size)
CELLS = {
    "train": ("codeqwen1.5-7b", dict(attn_backend="dense"), "smoke_train",
              dict(seq_len=64, global_batch=8, kind="train")),
    "decode": ("codeqwen1.5-7b", dict(attn_backend="dense"), "smoke_decode",
               dict(seq_len=128, global_batch=8, kind="decode")),
}


def test_loop_flops_count_every_iteration():
    w, x = torch.randn(128, 128), torch.randn(128, 128)

    def f(c):
        for _ in range(10):
            c = c @ w
        return c.sum()

    _, r = analyze_step(f, x)
    assert abs(r["flops"] - 10 * 2 * 128**3) / (10 * 2 * 128**3) < 0.01


def test_nested_loops_compose():
    w, x = torch.randn(64, 64), torch.randn(64, 64)

    def f(c):
        for _ in range(4):
            for _ in range(3):
                c = c @ w
        return c.sum()

    _, r = analyze_step(f, x)
    want = 12 * 2 * 64**3
    assert abs(r["flops"] - want) / want < 0.01


def test_no_loop_program_counts_once():
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    _, r = analyze_step(lambda: (a @ b).sum())
    want = 2 * 64 * 32 * 16
    assert abs(r["flops"] - want) / want < 0.01
    assert r["collective_bytes"] == 0
    assert r["dot_bytes"] == 4 * (64 * 32 + 32 * 16 + 64 * 16)


@pytest.fixture
def fake_group():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world

    fake_world(8)
    yield
    dist.destroy_process_group()


def test_collective_bytes_follow_the_ring_model(fake_group):
    import torch.distributed as dist

    block = torch.zeros(4, 256)  # 4 KiB

    def f():
        out = torch.empty(8 * 4, 256)
        dist.all_gather_into_tensor(out, block)
        dist.all_reduce(block)

    _, r = analyze_step(f)
    assert r["collectives"] == {
        "all-gather": {"count": 1.0, "bytes": 8 * 4096.0},
        "all-reduce": {"count": 1.0, "bytes": 2 * 4096.0}}
    assert r["collective_bytes"] == 10 * 4096.0


def test_roofline_terms_match_the_reference(monkeypatch):
    from repro.configs import get_config as j_config
    from repro.launch import analysis as JA

    from repro_torch.configs import get_config

    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(JA, name, getattr(TA, name))
    stats = {"flops": 3.1e13, "dot_bytes": 2.2e11,
             "collective_bytes": 4.5e9}
    for arch, shape in (("granite-moe-3b-a800m", "train_4k"),
                        ("mistral-nemo-12b", "decode_32k")):
        got = TA.roofline_terms(stats, get_config(arch), shape, 3 * 10**9,
                                256)
        want = JA.roofline_terms(stats, j_config(arch), shape, 3 * 10**9, 256)
        assert got["dominant"] == want["dominant"]
        assert got["per_device"] == want["per_device"]
        for key in set(want) - {"dominant", "per_device"}:
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
        assert set(got) == set(want)
    assert (TA.PEAK_FLOPS, TA.HBM_BW, TA.LINK_BW) == (989e12, 3.35e12, 50e9)


REFERENCE = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
    import jax
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import SHAPES, smoke_config
    from repro.launch.steps import (METRIC_KEYS, batch_specs,
                                    cache_specs_trees, make_serve_step,
                                    make_train_step, params_specs,
                                    state_specs)
    from repro.models import get_model_def
    from repro.sharding.partitioning import ACT_RULES, resolve_spec
    from repro.utils import compat
    from repro.utils.hlo import analyze_hlo

    cells = json.loads(sys.argv[1])
    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    compat.set_mesh(mesh)
    out = {}
    for name, (arch, over, shape, sh) in cells.items():
        SHAPES[shape] = sh
        cfg = smoke_config(arch, **over)
        md = get_model_def(cfg)
        if sh["kind"] == "train":
            step, _ = make_train_step(md, cfg)
            s_sds, s_sh = state_specs(md, cfg, mesh)
            b_sds, b_sh = batch_specs(cfg, shape, mesh)
            m_sh = {k: NamedSharding(mesh, P()) for k in METRIC_KEYS}
            fn = jax.jit(step, in_shardings=(s_sh, b_sh),
                         out_shardings=(s_sh, m_sh))
            args = (s_sds, b_sds)
        else:
            step = make_serve_step(md, cfg)
            p_sds, p_sh = params_specs(md, cfg, mesh, serve=True)
            b_sds, b_sh = batch_specs(cfg, shape, mesh, serve=True)
            c_sds, c_sh = cache_specs_trees(md, cfg, sh["global_batch"],
                                            sh["seq_len"], mesh)
            l_sh = NamedSharding(mesh, resolve_spec(
                ("batch", "vocab"), (sh["global_batch"], cfg.vocab), mesh,
                ACT_RULES))
            fn = jax.jit(step, in_shardings=(p_sh, b_sh["tokens"],
                                             b_sh["pos"], b_sh["kv_len"],
                                             c_sh),
                         out_shardings=(l_sh, c_sh))
            args = (p_sds, b_sds["tokens"], b_sds["pos"], b_sds["kv_len"],
                    c_sds)
        with mesh:
            text = fn.lower(*args).compile().as_text()
        out[name] = analyze_hlo(text)["flops"]
    print(json.dumps(out))
''')


@pytest.fixture(scope="module")
def reference_flops():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", REFERENCE, json.dumps(CELLS)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", list(CELLS))
def test_counted_flops_match_analyze_hlo(cell, reference_flops, fake_group):
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh_for

    arch, over, shape, sh = CELLS[cell]
    SHAPES[shape] = sh
    try:
        mesh = make_mesh_for(8, 4)
        with torch.device("meta"):
            _, _, fn, args, _, _ = D.build_cell(
                arch, shape, mesh, None, config=smoke_config(arch, **over))
            _, stats = analyze_step(fn, *args)
    finally:
        del SHAPES[shape]
    want = reference_flops[cell]
    assert abs(stats["flops"] - want) <= 0.02 * want, (stats["flops"], want)
