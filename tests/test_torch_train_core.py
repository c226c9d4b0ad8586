"""The port's training numerics against the JAX reference, on the same
numpy inputs: the straight-through sign (forward bit-exact, gradient
exact), the straight-through estimator's (absent) effect on the exact
BA-CAM path, the three HAD distillation losses (1e-6), the chunked cross
entropy with a remainder chunk and vocab padding (loss and gradients,
1e-5), and the schedules, clipping and three AdamW updates fed identical
gradients (1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core.attention import AttentionSpec as JSpec
from repro.core.attention import attention as j_attention
from repro.core import binarize as j_bin
from repro.core import had as j_had
from repro.models import layers as j_layers
from repro.train import optimizer as j_opt

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.attention import AttentionSpec as TSpec
from repro_torch.core.attention import attention as t_attention
from repro_torch.core import binarize as t_bin
from repro_torch.core import had as t_had
from repro_torch.models import layers as t_layers
from repro_torch.train import optimizer as t_opt


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def test_sign_ste_forward_and_gradient():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-2, 2, 61), [0.0, 1.0, -1.0]]).astype(
        np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jy, jg = jax.value_and_grad(
        lambda x: jnp.sum(j_bin.sign_ste(x) * w))(jnp.asarray(x))
    tx = _t(x, grad=True)
    ty = t_bin.sign_ste(tx)
    (ty * _t(w)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(),
                                  np.asarray(j_bin.sign_ste(jnp.asarray(x))))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tx.grad.numpy(),
                                  w * (np.abs(x) <= 1.0))
    # binarize_qk(trainable=True) returns the hard sign's values
    q = _t(x.reshape(2, 32))
    for a, b in zip(t_bin.binarize_qk(q, q, trainable=True),
                    t_bin.binarize_qk(q, q)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["binary", "camformer"])
def test_ste_gives_no_gradient_on_the_exact_path(mode):
    """The signs are packed into integer words before the scores are
    formed, which cuts the straight-through gradient: q and k learn only
    through the HAD scales, and ``trainable_binarize`` True and False give
    identical gradients, in the reference and in the port."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((2, 4, 16, 32)).astype(np.float32)
               for _ in range(3))
    k, v = k[:, :2], v[:, :2]  # GQA, G = 2
    w = rng.standard_normal((2, 4, 16, 32)).astype(np.float32)

    def jax_grads(trainable):
        spec = JSpec(mode=mode, k_top=4, group_size=4,
                     trainable_binarize=trainable)
        f = lambda q, k: jnp.sum(j_attention(q, k, jnp.asarray(v), spec)
                                 * w)
        return [np.asarray(g) for g in
                jax.grad(f, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(k))]

    def port_grads(trainable):
        spec = TSpec(mode=mode, k_top=4, group_size=4,
                     trainable_binarize=trainable)
        tq, tk = _t(q, grad=True), _t(k, grad=True)
        (t_attention(tq, tk, _t(v), spec) * _t(w)).sum().backward()
        return [tq.grad.numpy(), tk.grad.numpy()]

    j_on, j_off, t_on, t_off = (jax_grads(True), jax_grads(False),
                                port_grads(True), port_grads(False))
    for a, b in zip(j_on, j_off):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_on, t_off):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_on, j_on):
        assert np.abs(b).max() > 0  # the scales carry a gradient
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_had_losses():
    rng = np.random.default_rng(2)
    shape = (2, 3, 8, 16)
    t_logits = rng.standard_normal(shape).astype(np.float32) * 3
    s_logits = rng.standard_normal(shape).astype(np.float32) * 3
    mask = np.tril(np.ones((8, 16), bool), k=8)[None, None]
    ties_t = rng.integers(-3, 3, shape).astype(np.float32)  # many ties
    ties_s = rng.integers(-3, 3, shape).astype(np.float32)
    jt, js = jnp.asarray(t_logits), jnp.asarray(s_logits)
    tt, ts = _t(t_logits), _t(s_logits)
    pairs = [
        (t_had.attention_kl(tt, ts), j_had.attention_kl(jt, js)),
        (t_had.attention_kl(tt, ts, torch.from_numpy(mask)),
         j_had.attention_kl(jt, js, jnp.asarray(mask))),
        (t_had.had_loss(torch.tensor(1.5), tt, ts, torch.from_numpy(mask),
                        alpha=0.3),
         j_had.had_loss(1.5, jt, js, jnp.asarray(mask), alpha=0.3)),
        (t_had.row_topk_overlap(tt, ts, k=4),
         j_had.row_topk_overlap(jt, js, k=4)),
        (t_had.row_topk_overlap(_t(ties_t), _t(ties_s), k=5),
         j_had.row_topk_overlap(jnp.asarray(ties_t), jnp.asarray(ties_s),
                                k=5)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("tied", [False, True])
def test_chunked_cross_entropy_loss_and_gradients(tied):
    """S = 10 in chunks of 4 (two chunks and a remainder of 2), vocab 250
    padded to 256, a random loss mask; gradients of x and the head."""
    kw = dict(vocab=250, tie_embeddings=tied)
    jc, tc = j_smoke("camformer-bert", **kw), t_smoke("camformer-bert", **kw)
    assert tc.padded_vocab == 256
    rng = np.random.default_rng(3)
    b, s, d = 2, 10, tc.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    embed = {"tok": rng.standard_normal((256, d)).astype(np.float32) * 0.1}
    if not tied:
        embed["head"] = rng.standard_normal((d, 256)).astype(np.float32) * 0.1
    labels = rng.integers(0, 250, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32)

    def jloss(x, e):
        return j_layers.chunked_cross_entropy(
            x, e, jnp.asarray(labels), jc, loss_mask=jnp.asarray(mask),
            chunk=4)

    (jl, jaux), (jgx, jge) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), jax.tree.map(jnp.asarray, embed))
    tx = _t(x, grad=True)
    te = {k: _t(v, grad=True) for k, v in embed.items()}
    tl, taux = t_layers.chunked_cross_entropy(
        tx, te, torch.from_numpy(labels), tc,
        loss_mask=torch.from_numpy(mask), chunk=4)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-5)
    for key in ("ce", "tokens"):
        np.testing.assert_allclose(float(taux[key].detach()),
                                   float(jaux[key]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5)
    for k in embed:  # an untied ``tok`` takes no gradient (None here)
        got = te[k].grad if te[k].grad is not None else torch.zeros_like(
            te[k])
        np.testing.assert_allclose(got.numpy(), np.asarray(jge[k]),
                                   rtol=1e-5, atol=1e-5)
    # the padding columns take no gradient
    head = te["tok"].grad.T if tied else te["head"].grad
    assert float(head[:, 250:].abs().max()) == 0.0


def test_schedules_and_clipping():
    jcos = j_opt.cosine_schedule(3e-4, warmup=3, total=10)
    tcos = t_opt.cosine_schedule(3e-4, warmup=3, total=10)
    for step in range(13):
        np.testing.assert_allclose(
            float(tcos(torch.tensor(step, dtype=torch.int32))),
            float(jcos(jnp.int32(step))), rtol=1e-6, atol=0)
    assert float(t_opt.constant_schedule(1e-3)(5)) == float(
        j_opt.constant_schedule(1e-3)(5))
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": {"c": rng.standard_normal((3,)).astype(np.float32) * 4}}
    ttree = {"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}}
    jtree = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(float(t_opt.global_norm(ttree)),
                               float(j_opt.global_norm(jtree)), rtol=1e-6)
    for max_norm in (0.5, 100.0):  # clipped, and left alone
        (tc, tn), (jc, jn) = (t_opt.clip_by_global_norm(ttree, max_norm),
                              j_opt.clip_by_global_norm(jtree, max_norm))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        np.testing.assert_allclose(tc["a"].numpy(), np.asarray(jc["a"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tc["b"]["c"].numpy(),
                                   np.asarray(jc["b"]["c"]), rtol=1e-6,
                                   atol=1e-7)


def test_adamw_three_updates():
    """Three updates fed identical gradients (the first one clipped):
    params, m, v, step, grad norm and learning rate to 1e-6."""
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": {"c": rng.standard_normal((3,)).astype(np.float32)}}
    jo = j_opt.adamw(j_opt.cosine_schedule(1e-2, 2, 10))
    to = t_opt.adamw(t_opt.cosine_schedule(1e-2, 2, 10))
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    ts = to.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * (3.0 if i == 0 else 0.1)).astype(
                                        np.float32), params)
        jp, js, jst = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tst = to.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tst[key]), float(jst[key]),
                                       rtol=1e-6)
        for tt, jt in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            for t_leaf, j_leaf in zip(jax.tree.leaves(
                    jax.tree.map(lambda t: t.numpy(), tt)),
                    jax.tree.leaves(jt)):
                np.testing.assert_allclose(t_leaf, np.asarray(j_leaf),
                                           rtol=1e-6, atol=1e-6)
        assert int(ts["step"]) == int(js["step"]) == i + 1
