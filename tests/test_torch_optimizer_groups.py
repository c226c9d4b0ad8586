"""The AdamW update run group by group (``train/optimizer.py``): bit for
bit the update of one ``torch._foreach_*`` call a stage over every leaf
(kept here as the oracle), whatever the group bound, and its temporaries
bounded by the group, not by the tree."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.train import optimizer as t_opt

ROOT = Path(__file__).resolve().parents[1]
F32 = torch.float32


def all_leaves_update(grads, state, params, schedule, b1=0.9, b2=0.95,
                      eps=1e-8, weight_decay=0.1, clip_norm=1.0, norm=None):
    """The update as one ``_foreach`` call a stage over all leaves: the
    formula the grouped update must equal bit for bit."""
    f = lambda x: float(torch.as_tensor(x, dtype=F32))
    step = state["step"] + 1
    lr = schedule(step)
    stepf = step.to(F32)
    bc1 = f(1 - torch.tensor(b1, dtype=F32) ** stepf)
    bc2 = f(1 - torch.tensor(b2, dtype=F32) ** stepf)
    lr_f = f(lr)
    norm = t_opt.global_norm(grads) if norm is None else norm
    g = torch._foreach_mul([x.to(F32) for x in tree_leaves(grads)],
                           torch.clamp(clip_norm / (norm + 1e-9), max=1.0))
    m, v, p = (tree_leaves(state["m"]), tree_leaves(state["v"]),
               tree_leaves(params))
    torch._foreach_mul_(m, f(b1))
    torch._foreach_add_(m, torch._foreach_mul(g, f(1 - b1)))
    torch._foreach_mul_(v, f(b2))
    gg = torch._foreach_mul(g, f(1 - b2))
    torch._foreach_mul_(gg, g)
    torch._foreach_add_(v, gg)
    den = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(m, bc1)
    torch._foreach_div_(u, den)
    torch._foreach_add_(u, torch._foreach_mul(p, f(weight_decay)))
    torch._foreach_sub_(p, torch._foreach_mul(u, lr_f))
    return {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": norm, "lr": lr}


# leaves of 7000, 300, 500, 60, 4000 and 40 floats: with a bound of 4096
# floats the first is a group of its own, the next three share one, and
# the fifth and sixth another
BOUND = 4096 * 4


def _tree(rng, scale=1.0):
    def leaf(*shape):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    return {"a": leaf(70, 100), "b": {"c": leaf(300), "d": leaf(5, 100)},
            "e": leaf(60), "f": [leaf(40, 100), leaf(40)]}


def _copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def test_groups_straddle_the_bound(monkeypatch):
    monkeypatch.setattr(t_opt, "GROUP_BYTES", BOUND)
    leaves = tree_leaves(_tree(np.random.default_rng(0)))
    assert [x.numel() for x in leaves] == [7000, 300, 500, 60, 4000, 40]
    assert t_opt._groups(leaves) == [[0], [1, 2, 3], [4, 5]]


@pytest.mark.parametrize("sharded", [False, True])
def test_grouped_update_equals_the_all_leaves_formula(monkeypatch, sharded):
    """Params, m, v, grad norm and lr over 3 updates, the first clipped;
    ``sharded``: the norm handed in (``norm=``), as the sharded step
    does, here the norm of the gradients scaled by 1.5."""
    monkeypatch.setattr(t_opt, "GROUP_BYTES", BOUND)
    rng = np.random.default_rng(3)
    schedule = t_opt.cosine_schedule(1e-2, 2, 10)
    opt = t_opt.adamw(schedule)
    params = _tree(rng)
    want_p = _copy(params)
    state = opt.init(params)
    want_s = opt.init(want_p)
    for i in range(3):
        grads = _tree(rng, 3.0 if i == 0 else 0.1)
        before = _copy(grads)
        norm = 1.5 * t_opt.global_norm(grads) if sharded else None
        params, state, stats = opt.update(grads, state, params, norm=norm)
        want_s, want_stats = all_leaves_update(grads, want_s, want_p,
                                               schedule, norm=norm)
        assert _equal(grads, before), "the update changed its gradients"
        assert _equal(params, want_p)
        assert _equal(state["m"], want_s["m"])
        assert _equal(state["v"], want_s["v"])
        for key in ("grad_norm", "lr"):
            assert torch.equal(stats[key], want_stats[key]), key
        assert int(state["step"]) == int(want_s["step"]) == i + 1
    assert not _equal(params, _tree(np.random.default_rng(3)))


LEAF_FLOATS = 12 * 2**20  # 48 MiB: above glibc's largest mmap threshold
N_LEAVES = 8

# the peak is the process's own VmHWM: getrusage's ru_maxrss carries the
# parent's peak across fork and exec, and a test worker's may be GBs
RSS_PROBE = f"""
import json
import torch
from repro_torch.train import optimizer as t_opt

n, k = {LEAF_FLOATS}, {N_LEAVES}
t_opt.GROUP_BYTES = 4 * n
tree = lambda value: [torch.full((n,), value) for _ in range(k)]
params, grads = tree(0.5), tree(0.1)
opt = t_opt.adamw(t_opt.constant_schedule(1e-3))
state = {{"m": tree(0.01), "v": tree(0.02),
         "step": torch.zeros((), dtype=torch.int32)}}


def kib(field):
    status = open("/proc/self/status").read()
    return int(status.split(field + ":")[1].split()[0])


before = kib("VmRSS")
opt.update(grads, state, params)
print(json.dumps({{"rise_kib": kib("VmHWM") - before,
                  "tree_kib": 4 * n * k // 1024}}))
"""


def test_update_peak_rss_bounded_by_groups():
    """p, m, v and g of 8 leaves of 48 MiB resident, the bound one leaf:
    peak RSS during ``update`` rises by at most 0.75 of a tree (with one
    ``_foreach`` call a stage over all leaves it rises by 3 trees)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", RSS_PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["rise_kib"] <= 0.75 * got["tree_kib"], got
