"""Core numerics of the PyTorch port against the JAX reference: the
config registry, sign/pack/popcount scoring, two-stage top-k on inputs
full of ties, and the top-k softmax weights.

Inputs are made with numpy from a seed and fed to both packages.
Integer outputs must be bit-exact; floats match to 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.core import bacam as jbacam
from repro.core import topk as jtopk
from repro.core.attention import topk_softmax_weights as j_weights
from repro.core.binarize import sign_pm1 as j_sign

import repro_torch.configs as tcfg
from repro_torch.core import bacam as tbacam
from repro_torch.core import topk as ttopk
from repro_torch.core.attention import topk_softmax_weights as t_weights
from repro_torch.core.binarize import had_scales, sign_pm1 as t_sign


def _as_i32(x) -> np.ndarray:
    """JAX uint32 words as int32 carrying the same bits."""
    return np.asarray(x).view(np.int32)


def _signed_input(rng, shape):
    """Normal values with exact zeros, negative zeros and tiny values
    planted, so the sign of zero is exercised."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    n = flat.size
    flat[rng.choice(n, n // 8, replace=False)] = 0.0
    flat[rng.choice(n, n // 16, replace=False)] = -0.0
    flat[rng.choice(n, n // 16, replace=False)] = 1e-30
    return x


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_config_registry_matches_reference(arch):
    assert tcfg.list_archs() == jcfg.list_archs()
    want = dataclasses.asdict(jcfg.get_config(arch))
    got = dataclasses.asdict(tcfg.get_config(arch))
    assert got == want
    assert (dataclasses.asdict(tcfg.smoke_config(arch))
            == dataclasses.asdict(jcfg.smoke_config(arch)))
    assert tcfg.get_config(arch).padded_vocab == \
        jcfg.get_config(arch).padded_vocab


def test_sign_pm1_sends_zero_to_minus_one():
    x = np.array([-2.0, -0.0, 0.0, 1e-30, -1e-30, 3.0], np.float32)
    got = t_sign(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_sign(jnp.asarray(x))))
    np.testing.assert_array_equal(got, [-1, -1, -1, 1, -1, 1])
    np.testing.assert_allclose(
        had_scales(torch.from_numpy(x)).numpy(), [np.abs(x).mean()],
        rtol=1e-6)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_pack_unpack_hamming_bit_exact(d):
    rng = np.random.default_rng(d)
    q = _signed_input(rng, (2, 3, 5, d))
    k = _signed_input(rng, (2, 3, 7, d))
    tq, tk = tbacam.pack_bits(torch.from_numpy(q)), \
        tbacam.pack_bits(torch.from_numpy(k))
    jq, jk = jbacam.pack_bits(jnp.asarray(q)), jbacam.pack_bits(jnp.asarray(k))
    assert tq.dtype == torch.int32
    np.testing.assert_array_equal(tq.numpy(), _as_i32(jq))
    np.testing.assert_array_equal(tk.numpy(), _as_i32(jk))
    # words with the sign bit set are negative int32 values
    assert (tq < 0).any()
    np.testing.assert_array_equal(tbacam.unpack_bits(tq, d).numpy(),
                                  np.asarray(jbacam.unpack_bits(jq, d)))
    got = tbacam.hamming_scores_packed(tq, tk, d)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbacam.hamming_scores_packed(jq, jk, d)))


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(0)
    words = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    words[:4] = [0, -1, -2**31, 2**31 - 1]
    want = np.array([bin(int(w) & 0xFFFFFFFF).count("1") for w in words])
    got = tbacam.popcount32(torch.from_numpy(words)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,group,s1,n", [(8, 4, 2, 64), (32, 16, 2, 256),
                                          (5, 4, 3, 30), (40, 16, 2, 64)])
def test_two_stage_topk_ties_bit_exact(k, group, s1, n):
    """Scores drawn from a handful of integers: ties everywhere.  Both
    stages must pick the lowest index among equals, like lax.top_k; the
    last case asks for more than there are candidates (NEG_INF padding),
    the third has N not a multiple of the group."""
    rng = np.random.default_rng(k * n)
    scores = rng.integers(-3, 4, (3, 4, n)).astype(np.float32) * 16
    where = rng.random((3, 4, n)) < 0.8
    where[0, 0] = False  # a fully masked row
    jv, ji = jtopk.two_stage_topk(jnp.asarray(scores), k=k, group_size=group,
                                  stage1_k=s1, where=jnp.asarray(where))
    tv, ti = ttopk.two_stage_topk(torch.from_numpy(scores), k=k,
                                  group_size=group, stage1_k=s1,
                                  where=torch.from_numpy(where))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32


def test_topk_softmax_weights():
    rng = np.random.default_rng(3)
    top_v = rng.integers(-64, 65, (2, 3, 4, 8)).astype(np.float32)
    top_v[0, 0, 0, 3:] = jtopk.NEG_INF  # fewer than k valid
    top_v[1, 2, 1, :] = jtopk.NEG_INF  # nothing valid
    temp = rng.uniform(0.2, 2.0, (2, 3, 4, 1)).astype(np.float32)
    jw, jvalid = j_weights(jnp.asarray(top_v), jnp.asarray(temp), 0.125)
    tw, tvalid = t_weights(torch.from_numpy(top_v), torch.from_numpy(temp),
                           0.125)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-5)
    assert np.all(tw.numpy()[1, 2, 1] == 0)
