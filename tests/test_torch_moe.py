"""The port's MoE FFN (``models/moe.py``) against the JAX reference's
``apply_moe`` on the same numpy inputs (f32, CPU).

The routing is integer work and must match exactly: the chosen experts
``eidx``, each choice's buffer position and its keep mask.  The
reference keeps those inside ``apply_moe``, so ``_reference_routing``
transcribes its routing in jnp step for step (the per-slot loop with the
running ``fill``) and is itself pinned to the reference by rebuilding
the reference's output from it bit for bit.  Outputs to 1e-5, aux values
to 1e-6.

Cases: smoke ``granite-moe-3b-a800m`` (8 real experts padded to 48) and
smoke ``moonshot-v1-16b-a3b`` (8, no padding); one dispatch group and
two (B*S = 16 and 128); a router biased to one expert, which forces
drops; a zeroed router (all probabilities tie: experts 0..k-1 in order);
the named ValueError where B*S is not a multiple of the group; the
expert leaves' init shapes and std; the weight bridge for ``moe`` and
``vlm``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import get_model_def as j_model_def
from repro.models.moe import apply_moe as j_apply_moe
from repro.models.moe import moe_specs as j_moe_specs
from repro.models.module import init_params as j_init

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import from_jax_params, init_params
from repro_torch.models import moe as M

ARCHS = ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b")


def _reference_routing(p, x, cfg):
    """The reference's routing (``src/repro/models/moe.py``), step for
    step: (eidx, pos, keep) per (group, token, slot) and the output built
    from the reference's own dispatch and combine tensors."""
    b, s, d = x.shape
    e, k, ep = cfg.n_experts, cfg.experts_per_token, cfg.padded_experts
    t = b * s
    gt = min(M.MOE_GROUP, t)
    g = t // gt
    cap = max(1, int(-(-gt * k * cfg.capacity_factor // e)))
    xg = x.reshape(g, gt, d)
    logits = xg.astype(jnp.float32) @ p["router"].astype(jnp.float32)
    if ep > e:
        logits = jnp.where(jnp.arange(ep) < e, logits, -1e9)
    probs = jax.nn.softmax(logits, axis=-1)
    gates, eidx = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    disp = jnp.zeros((g, gt, ep, cap), x.dtype)
    comb = jnp.zeros((g, gt, ep, cap), jnp.float32)
    fill = jnp.zeros((g, ep), jnp.int32)
    pos_s, keep_s = [], []
    for slot in range(k):
        oh_e = jax.nn.one_hot(eidx[..., slot], ep, dtype=jnp.int32)
        pos = jnp.cumsum(oh_e, axis=1) - oh_e + fill[:, None, :]
        fill = fill + oh_e.sum(axis=1)
        keep = (pos < cap) & (oh_e > 0)
        pos_s.append(jnp.take_along_axis(pos, eidx[..., slot:slot + 1],
                                         -1)[..., 0])
        keep_s.append(keep.any(-1))
        oh_c = (jax.nn.one_hot(jnp.clip(pos, 0, cap - 1), cap,
                               dtype=jnp.float32) * keep[..., None])
        disp = disp + oh_c.astype(x.dtype)
        comb = comb + oh_c * gates[..., slot][..., None, None]
    buf = jnp.einsum("gtec,gtd->gecd", disp, xg)
    gte = jnp.einsum("gecd,edf->gecf", buf, p["w_gate"])
    up = jnp.einsum("gecd,edf->gecf", buf, p["w_up"])
    y = jnp.einsum("gecf,efd->gecd", jax.nn.silu(gte) * up, p["w_down"])
    out = jnp.einsum("gtec,gecd->gtd", comb.astype(x.dtype), y)
    return (np.asarray(eidx), np.stack(pos_s, -1), np.stack(keep_s, -1),
            np.asarray(gates), np.asarray(out.reshape(b, s, d)))


def _params(cfg, router=None):
    """One MoE FFN's parameters from the reference's init (numpy)."""
    p = jax.tree.map(np.array,
                     j_init(j_moe_specs(cfg), jax.random.PRNGKey(3)))
    if router == "zero":
        p["router"] = np.zeros_like(p["router"])
    elif router == "biased":  # expert 3 wins slot 0 for every token
        p["router"][:, 3] += 1.0
    return p


def _both(arch, b, s, router=None):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    p = _params(jcfg, router)
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    if router == "biased":
        x = np.abs(x)  # positive activations: the +1 column dominates
    jout, jaux = j_apply_moe({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jcfg)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tout, taux = M.apply_moe(tp, torch.from_numpy(x), tcfg)
    gt = M.group_size(b * s)
    troute = M.route(tp["router"], torch.from_numpy(x).reshape(-1, gt,
                                                               x.shape[-1]),
                     tcfg, M.capacity(tcfg, gt))
    return (p, x, jcfg, (np.asarray(jout), jaux),
            (tout.numpy(), taux), troute)


def _check(p, x, jcfg, ref, port, route):
    (jout, jaux), (tout, taux) = ref, port
    eidx, pos, keep, gates, rebuilt = _reference_routing(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(rebuilt, jout)  # the transcription
    np.testing.assert_array_equal(route.eidx.numpy(), eidx)
    np.testing.assert_array_equal(route.pos.numpy(), pos)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    np.testing.assert_allclose(route.gates.numpy(), gates, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-5)
    for name in ("moe_aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-6, atol=1e-6)
    return eidx, keep


@pytest.mark.parametrize("b,s", [(2, 8), (2, 64)])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, b, s):
    p, x, jcfg, ref, port, route = _both(arch, b, s)
    _check(p, x, jcfg, ref, port, route)
    assert route.eidx.shape == (b * s // min(64, b * s), min(64, b * s),
                                jcfg.experts_per_token)
    assert int(route.eidx.max()) < jcfg.n_experts  # no padded expert


@pytest.mark.parametrize("arch", ARCHS)
def test_biased_router_drops_tokens(arch):
    p, x, jcfg, ref, port, route = _both(arch, 2, 64, router="biased")
    eidx, keep = _check(p, x, jcfg, ref, port, route)
    assert np.all(eidx[..., 0] == 3)
    assert not keep.all()
    assert float(port[1]["moe_drop_frac"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_zeroed_router_ties_pick_lowest_experts(arch):
    p, x, jcfg, ref, port, route = _both(arch, 2, 8, router="zero")
    eidx, keep = _check(p, x, jcfg, ref, port, route)
    k = jcfg.experts_per_token
    np.testing.assert_array_equal(eidx, np.broadcast_to(np.arange(k),
                                                        eidx.shape))
    np.testing.assert_allclose(route.gates.numpy(), 1.0 / k, rtol=1e-6)
    # every token of the group queues on the same k experts
    cap = M.capacity(t_smoke(arch), 16)
    np.testing.assert_array_equal(keep[0, :, 0], np.arange(16) < cap)


def test_group_remainder_raises_named_error():
    cfg = t_smoke("granite-moe-3b-a800m")
    p = {k: torch.from_numpy(v) for k, v in _params(cfg).items()}
    x = torch.zeros((3, 32, cfg.d_model))  # B*S = 96, group 64
    with pytest.raises(ValueError, match=r"B\*S=96 .* gt=64"):
        M.apply_moe(p, x, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_expert_leaves_shapes_and_std(arch):
    cfg = t_smoke(arch)
    ffn = init_params(cfg, device="cpu", seed=0)["blocks"][0]["ffn"]
    d, f, ep = cfg.d_model, cfg.d_ff, cfg.padded_experts
    shapes = {"router": (d, ep), "w_gate": (ep, d, f), "w_up": (ep, d, f),
              "w_down": (ep, f, d)}
    assert {k: tuple(v.shape) for k, v in ffn.items()} == shapes
    # the reference's stds: d**-0.5 for the router, fan-in over the
    # last-but-one axis for the expert stacks (f**-0.5 for w_down)
    want = {"router": d**-0.5, "w_gate": d**-0.5, "w_up": d**-0.5,
            "w_down": f**-0.5}
    ref = j_init(j_moe_specs(j_smoke(arch)), jax.random.PRNGKey(0))
    for name, std in want.items():
        assert abs(float(ffn[name].std()) / std - 1) < 0.05, name
        assert abs(float(np.asarray(ref[name]).std()) / std - 1) < 0.05, name


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llava-next-mistral-7b"])
def test_weight_bridge_moe_and_vlm(arch):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    md = j_model_def(jcfg)
    params_np = jax.tree.map(np.asarray,
                             j_init(md.specs(jcfg), jax.random.PRNGKey(0)))
    tp = from_jax_params(params_np, tcfg, device="cpu")
    assert len(tp["blocks"]) == tcfg.n_layers
    for i, blk in enumerate(tp["blocks"]):
        for mod, leaves in params_np["blocks"].items():
            assert set(blk[mod]) == set(leaves)
            for name, arr in leaves.items():
                np.testing.assert_array_equal(blk[mod][name].numpy(), arr[i])
    own = init_params(tcfg, device="cpu", seed=1)
    for mod, leaves in own["blocks"][0].items():
        for name, t in leaves.items():
            assert tuple(t.shape) == params_np["blocks"][mod][name].shape[1:]
