"""The port's keyed sampler and the speculation bookkeeping against the
JAX reference.

  * threefry ``fold_in`` + 32-bit bits: bit-exact against
    ``jax.random.bits(jax.random.fold_in(key, i), (V,))`` over 64
    (key, index) pairs, the uniform floats bit-exact too;
  * the Gumbel noise ``-log(-log(u))``: each of its two logs within
    1 ulp of XLA's on the same input (torch and XLA:CPU round ``log``
    differently in the last place; the outer log of a value near 1
    amplifies that in relative terms, so the stages are held apart);
  * ``sample_step_keyed`` draws identical at temperature 0.9 with per-row
    top-k / top-p and greedy rows mixed in, and ``sample_step`` /
    ``sample`` under one key;
  * ``draft_config``, ``sample_positions_keyed``, ``accept_prefix``,
    ``repair_k_scale`` and ``select_k_scale`` exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (jax_threefry_partitionable=True)
from repro.serving import sampler as JS
from repro.serving import speculate as JSP

from repro_torch.serving import prng
from repro_torch.serving import sampler as TS
from repro_torch.serving import speculate as TSP


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.all(np.sign(a) == np.sign(b))
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _keys(rng, n):
    return rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("v", [1, 97, 1024])
def test_fold_in_bits_bit_exact(v):
    rng = np.random.default_rng(v)
    keys = _keys(rng, 64)
    idx = rng.integers(0, 2**31, 64).astype(np.int32)
    idx[:4] = [0, 1, 2**31 - 1, 7]
    fold = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(idx))
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (v,)))(fold))
    tkeys = prng.fold_in(torch.from_numpy(keys.astype(np.int64)),
                         torch.from_numpy(idx))
    np.testing.assert_array_equal(tkeys.numpy().astype(np.uint32),
                                  np.asarray(fold))
    bits = prng.random_bits(tkeys, v)
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), want)
    tiny = np.finfo(np.float32).tiny
    want_u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (v,), minval=tiny, maxval=1.0))(fold))
    np.testing.assert_array_equal(prng.uniform_tiny(bits).numpy(), want_u)


def test_gumbel_noise_within_one_ulp_per_log():
    rng = np.random.default_rng(0)
    keys = _keys(rng, 64)
    idx = rng.integers(0, 10_000, 64).astype(np.int32)
    v = 512
    fold = jax.vmap(jax.random.fold_in)(jnp.asarray(keys), jnp.asarray(idx))
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (v,)))(fold))
    tkeys = prng.fold_in(torch.from_numpy(keys.astype(np.int64)),
                         torch.from_numpy(idx))
    u = prng.uniform_tiny(prng.random_bits(tkeys, v))
    inner = -torch.log(u)
    j_inner = -np.asarray(jax.jit(jnp.log)(jnp.asarray(u.numpy())))
    assert _ulps(inner.numpy(), j_inner).max() <= 1
    outer = -torch.log(torch.from_numpy(j_inner))
    j_outer = -np.asarray(jax.jit(jnp.log)(jnp.asarray(j_inner)))
    assert _ulps(outer.numpy(), j_outer).max() <= 1
    # the composed noise: XLA's own gumbel is the composition of its two
    # logs, and the port's differs from it only through them
    np.testing.assert_array_equal(j_outer, want)
    got = prng.gumbel(tkeys, v).numpy()
    t = j_inner.astype(np.float64)
    bound = (np.spacing(np.abs(want)) + np.spacing(t.astype(np.float32)) / t
             + np.spacing(np.abs(want)))
    assert np.all(np.abs(got - want) <= bound)


def _rows(seed, b, v):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    logits[0, :5] = logits[0, 5]  # ties at the top-k / top-p cut
    keys = np.stack([JS.request_key(seed, r) for r in range(b)])
    idx = rng.integers(0, 1000, b).astype(np.int32)
    temps = np.where(np.arange(b) % 4 == 1, 0.0, 0.9).astype(np.float32)
    top_ks = rng.choice([0, 1, 5, 40], b).astype(np.int32)
    top_ps = rng.choice([1.0, 0.95, 0.5], b).astype(np.float32)
    return logits, keys, idx, temps, top_ks, top_ps


def _t(*xs):
    return [torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                             else x) for x in xs]


@pytest.mark.parametrize("seed", range(6))
def test_sample_step_keyed_draws_identical(seed):
    logits, keys, idx, temps, top_ks, top_ps = _rows(seed, 16, 301)
    want = np.asarray(JS.sample_step_keyed(
        *[jnp.asarray(x) for x in (logits, keys, idx, temps, top_ks,
                                   top_ps)]))
    got = TS.sample_step_keyed(*_t(logits, keys, idx, temps, top_ks,
                                   top_ps))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # greedy rows are the argmax; a hot row's draw depends on its index
    greedy = temps == 0
    np.testing.assert_array_equal(want[greedy], logits[greedy].argmax(-1))


@pytest.mark.parametrize("seed", range(3))
def test_sample_step_and_sample_identical(seed):
    logits, _, _, temps, top_ks, top_ps = _rows(seed, 8, 211)
    key = np.asarray(jax.random.PRNGKey(seed))
    tkey = torch.from_numpy(key.astype(np.int64))
    want = np.asarray(JS.sample_step(
        jnp.asarray(logits), jnp.asarray(key), *[jnp.asarray(x) for x in (
            temps, top_ks, top_ps)]))
    got = TS.sample_step(*_t(logits), tkey, *_t(temps, top_ks, top_ps))
    np.testing.assert_array_equal(got.numpy(), want)
    for kw in (dict(temperature=0.7, top_k=20, top_p=0.9),
               dict(temperature=1.3), dict(temperature=0.0)):
        want = np.asarray(JS.sample(jnp.asarray(logits), jnp.asarray(key),
                                    **kw))
        got = TS.sample(torch.from_numpy(logits), tkey, **kw)
        np.testing.assert_array_equal(got.numpy(), want)


def test_sample_positions_keyed_identical():
    b, m, v = 4, 3, 97
    logits, keys, _, temps, top_ks, top_ps = _rows(11, b, m * v)
    logits = logits.reshape(b, m, v)
    idx = (np.arange(b)[:, None] * 5 + np.arange(m)[None]).astype(np.int32)
    want = np.asarray(JSP.sample_positions_keyed(
        *[jnp.asarray(x) for x in (logits, keys, idx, temps, top_ks,
                                   top_ps)]))
    got = TSP.sample_positions_keyed(*_t(logits, keys, idx, temps, top_ks,
                                         top_ps))
    np.testing.assert_array_equal(got.numpy(), want)


def test_draft_config_matches_reference():
    from repro.configs import smoke_config as j_smoke

    from repro_torch.configs import smoke_config as t_smoke

    for kw in (dict(attn_backend="camformer", spec_k=2),
               dict(layer_backends=("dense", "camformer"), spec_k=3,
                    spec_backend="dense")):
        jd = JSP.draft_config(j_smoke("mistral-nemo-12b", **kw))
        td = TSP.draft_config(t_smoke("mistral-nemo-12b", **kw))
        for f in ("attn_backend", "layer_backends", "spec_k", "spec_backend",
                  "n_layers"):
            assert getattr(td, f) == getattr(jd, f), f


@pytest.mark.parametrize("m", [1, 2, 4])
def test_accept_prefix_exact(m):
    rng = np.random.default_rng(m)
    b = 64
    samples = rng.integers(0, 3, (b, m)).astype(np.int32)
    drafts = rng.integers(0, 3, (b, m)).astype(np.int32)
    drafts[: b // 2, 1:] = samples[: b // 2, :-1]  # all accepted
    n_tok = rng.integers(0, m + 1, b).astype(np.int32)
    want = np.asarray(JSP.accept_prefix(jnp.asarray(drafts),
                                        jnp.asarray(samples),
                                        jnp.asarray(n_tok)))
    got = TSP.accept_prefix(*_t(drafts, samples, n_tok))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_repair_and_select_k_scale_exact():
    rng = np.random.default_rng(3)
    b, h, m, layers = 6, 2, 4, 3
    pos = rng.integers(4, 40, b).astype(np.int32)
    base = np.minimum(pos, rng.integers(0, 8, b)).astype(np.int32)
    n_tok = np.array([4, 4, 2, 0, 3, 1], np.int32)
    n_valid = np.array([1, 4, 2, 0, 2, 1], np.int32)
    new, old = [], []
    for i in range(layers):
        new.append({"k_scale": rng.uniform(0.5, 2, (b, h)).astype(np.float32),
                    "k_means": rng.uniform(0, 2, (b, h, m)).astype(
                        np.float32)})
        old.append({"k_scale": rng.uniform(0.5, 2, (b, h)).astype(
            np.float32)})
    new.append({"k_pages": np.zeros(2, np.float32)})  # a dense layer
    old.append({"k_pages": np.zeros(2, np.float32)})
    stats = (pos, base, n_tok, n_valid)
    want = JSP.repair_k_scale(
        tuple({k: jnp.asarray(x) for k, x in d.items()} for d in new),
        tuple({k: jnp.asarray(x) for k, x in d.items()} for d in old),
        *[jnp.asarray(x) for x in stats])
    got = TSP.repair_k_scale(
        [{k: torch.from_numpy(x) for k, x in d.items()} for d in new],
        [None if "k_scale" not in d else torch.from_numpy(d["k_scale"])
         for d in old], *_t(*stats))
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))

    snaps = [[rng.uniform(0.5, 2, (b, h)).astype(np.float32)
              for _ in range(layers)] + [None] for _ in range(m)]
    final = [{"k_scale": s} for s in snaps[-1][:layers]] + [{"k_pages": 0}]
    want = JSP.select_k_scale(
        tuple({k: jnp.asarray(x) for k, x in d.items()} for d in final),
        [tuple(None if s is None else jnp.asarray(s) for s in step)
         for step in snaps], jnp.asarray(n_valid))
    got = TSP.select_k_scale(
        [{k: torch.as_tensor(x) for k, x in d.items()} for d in final],
        [[None if s is None else torch.from_numpy(s) for s in step]
         for step in snaps], torch.from_numpy(n_valid))
    for g, w in zip(got[:layers], want[:layers]):
        np.testing.assert_array_equal(g["k_scale"].numpy(),
                                      np.asarray(w["k_scale"]))
