"""The BA-CAM device model of the port (``core/bacam.py``: the tiled
scores with a SAR ADC and keyed matchline noise; ``serving/prng.normal``),
the rest of ``core/`` (single-stage top-k, recall, the Hoeffding bound,
the energy/system simulator) and ``attention(..., rng=)`` against the
JAX reference on the CPU.  Inputs are made with numpy from a seed and
fed to both packages; these are the reference's own checks
(``tests/test_core.py``) held as parity cases.

What must match, and how closely:

* the threefry bits: bit for bit;
* the normals: within ``NORMAL_ULP`` units in the last place (the
  distance between the float32 bit patterns).  Both sides draw the same
  bits, map them to the same uniform and evaluate XLA's ErfInv with the
  same constants, one fused multiply-add a Horner step, so the only
  difference is ``log1p(-u**2)``: XLA's own approximation on one side,
  the C library's on the other, each within an ulp or two of the true
  value.  Through the polynomial in w (its relative sensitivity to w is
  below 1 where w < 5, and the sqrt(w) branch halves it) that is at most
  2 ulp of erfinv, and the final multiply by sqrt(2) rounds once more:
  4 ulp.  (Measured: 3.)
* ADC scores: equal, except on elements whose noisy match count lies
  within 1e-5 of an ADC rounding boundary (a normal an ulp apart may
  round to the other code there); their number is printed;
* noisy scores without the ADC and attention outputs: 1e-5;
  gradients through ``sign_ste``: 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (AttentionSpec as JSpec, attention as j_attention,
                        bacam_scores as j_scores,
                        binary_scores_exact as j_exact,
                        hoeffding_drop_bound as j_hoeffding,
                        single_stage_topk as j_single,
                        topk_recall as j_recall,
                        two_stage_topk as j_two_stage)
from repro.core import bacam as j_bacam
from repro.core import energy as j_energy

import repro_torch.core as tcore
from repro_torch.core import bacam as t_bacam
from repro_torch.core import energy as t_energy
from repro_torch.core.binarize import binarize_qk
from repro_torch.serving import prng

NORMAL_ULP = 4
BOUNDARY = 1e-5  # match counts this close to an ADC boundary may differ
CAM_W = 64


def _pm1(rng, shape):
    return np.where(rng.standard_normal(shape) > 0, 1.0, -1.0).astype(
        np.float32)


def _key(seed):
    """A raw key: the reference's uint32 pair, the port's int64 pair."""
    k = np.asarray(jax.random.PRNGKey(seed))
    return jnp.asarray(k), torch.from_numpy(k.astype(np.int64))


def _ulp(got, want):
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


def _noisy_matches(qb, kb, tkey, sigma, cam_w=CAM_W):
    """The port's match counts per tile after noise and clip, (...,
    Sq, Sk, tiles): where they sit against the ADC's boundaries."""
    d = qb.shape[-1]
    qt = torch.from_numpy(qb).reshape(*qb.shape[:-1], d // cam_w, cam_w)
    kt = torch.from_numpy(kb).reshape(*kb.shape[:-1], d // cam_w, cam_w)
    m = (torch.einsum("...qtc,...ktc->...qkt", qt, kt) + cam_w) * 0.5
    m = m + prng.normal(tkey, m.shape, scale=sigma * cam_w)
    return torch.clamp(m, 0.0, float(cam_w)).numpy()


def _near_boundary(m, bits, cam_w=CAM_W):
    """Elements whose count is within BOUNDARY of a rounding boundary of
    round(m / cam_w * (2**bits - 1))."""
    t = m.astype(np.float64) * ((1 << bits) - 1) / cam_w
    return np.abs(t - np.floor(t) - 0.5) * cam_w / ((1 << bits) - 1) \
        < BOUNDARY


# ---------------- the keyed normal ----------------

@pytest.mark.parametrize("seed,shape", [(9, (4, 16, 32, 1)),
                                        (0, (3, 5, 7)),
                                        (1234, (2, 3, 1, 8, 40, 4))])
def test_random_bits_bit_exact(seed, shape):
    jkey, tkey = _key(seed)
    n = int(np.prod(shape))
    want = np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).reshape(-1)
    got = prng.random_bits(tkey, n).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 9, 77])
def test_normals_within_ulp_bound(seed):
    jkey, tkey = _key(seed)
    shape = (4, 1 << 15)
    want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    got = prng.normal(tkey, shape).numpy()
    ulp = _ulp(got, want)
    print(f"normals: {int((ulp > 0).sum())} of {ulp.size} differ, at most "
          f"{int(ulp.max())} ulp")
    assert ulp.max() <= NORMAL_ULP
    # a constant scale folds into sqrt(2), as XLA folds a jitted product
    want = np.asarray(jax.jit(lambda k: 0.896 * jax.random.normal(
        k, shape, jnp.float32))(jkey))
    assert _ulp(prng.normal(tkey, shape, scale=0.896).numpy(),
                want).max() <= NORMAL_ULP


def test_erfinv_matches_xla_both_branches():
    """Uniform inputs over (-1, 1), the w >= 5 branch near +-1, and +-1
    itself (+-inf)."""
    rng = np.random.default_rng(0)
    near_one = 1.0 - rng.uniform(0, 1e-3, 4096)
    x = np.concatenate([rng.uniform(-1, 1, 1 << 16), near_one, -near_one,
                        [1.0, -1.0, 0.0]]).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = prng.erfinv_f32(torch.from_numpy(x)).numpy()
    assert (np.abs(x) ** 2 > 1 - math.exp(-5)).sum() > 1000  # w >= 5
    np.testing.assert_array_equal(got[-3:], want[-3:])
    assert _ulp(got[:-3], want[:-3]).max() <= 2


# ---------------- the device model ----------------

@pytest.mark.parametrize("bits", [6, 7])
def test_adc_readout_matches_reference(bits):
    """Every integer count (at 7 bits count 32 lies exactly on a
    boundary: both round half to even) and random counts away from the
    boundaries."""
    rng = np.random.default_rng(1)
    m = rng.uniform(0, 64, 4096).astype(np.float32)
    m = np.concatenate([np.arange(65, dtype=np.float32),
                        m[~_near_boundary(m, bits)]])
    got = t_bacam.adc_readout(torch.from_numpy(m), bits=bits).numpy()
    want = np.asarray(j_bacam.adc_readout(jnp.asarray(m), bits=bits))
    np.testing.assert_array_equal(got, want)
    if bits == 7:  # 7 bits cover [0, 64] exactly
        np.testing.assert_array_equal(got[:65], np.arange(65))


def test_adc_seven_bits_exact_six_bits_sub_lsb():
    rng = np.random.default_rng(2)
    qb, kb = _pm1(rng, (4, 16, 64)), _pm1(rng, (4, 32, 64))
    tq, tk = torch.from_numpy(qb), torch.from_numpy(kb)
    exact = t_bacam.binary_scores_exact(tq, tk)
    np.testing.assert_array_equal(exact.numpy(), np.asarray(
        j_exact(jnp.asarray(qb), jnp.asarray(kb))))
    for bits in (6, 7):
        got = t_bacam.bacam_scores(tq, tk, exact=False, adc_bits=bits)
        want = j_scores(jnp.asarray(qb), jnp.asarray(kb), exact=False,
                        adc_bits=bits)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if bits == 7:
            assert torch.equal(got, exact)
        else:
            assert (got - exact).abs().max() <= 4  # sub-LSB a count


def test_matchline_noise_matches_reference():
    """sigma = 1.4% of full scale, no ADC: the noisy scores (1e-5) and
    the paper's noise level; with the 6-bit ADC the scores are equal
    away from its rounding boundaries."""
    rng = np.random.default_rng(3)
    qb, kb = _pm1(rng, (8, 32, 64)), _pm1(rng, (8, 32, 64))
    jkey, tkey = _key(9)
    tq, tk = torch.from_numpy(qb), torch.from_numpy(kb)
    got = t_bacam.bacam_scores(tq, tk, exact=False, noise_sigma=0.014,
                               rng=tkey)
    want = np.asarray(j_scores(jnp.asarray(qb), jnp.asarray(kb),
                               exact=False, noise_sigma=0.014, rng=jkey))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    exact = t_bacam.binary_scores_exact(tq, tk)
    rel = float((got - exact).abs().mean()) / (2 * 64)
    assert 0.002 < rel < 0.03  # about 1.4% with gaussian folding
    got = t_bacam.bacam_scores(tq, tk, exact=False, adc_bits=6,
                               noise_sigma=0.014, rng=tkey).numpy()
    want = np.asarray(j_scores(jnp.asarray(qb), jnp.asarray(kb),
                               exact=False, adc_bits=6, noise_sigma=0.014,
                               rng=jkey))
    near = _near_boundary(_noisy_matches(qb, kb, tkey, 0.014), 6)[..., 0]
    print(f"6-bit ADC with noise: {int(near.sum())} of {near.size} scores "
          f"within {BOUNDARY} of a rounding boundary")
    np.testing.assert_array_equal(got[~near], want[~near])
    with pytest.raises(ValueError, match="requires rng"):
        t_bacam.bacam_scores(tq, tk, exact=False, noise_sigma=0.014)


def test_vertical_tiling_matches_flat():
    """d = 256: four CAM tiles accumulated digitally; at 7 bits equal to
    the flat dot product, and the 6-bit ADC with noise per tile as the
    reference (the noise over the (..., Sq, Sk, 4) shape)."""
    rng = np.random.default_rng(4)
    qb, kb = _pm1(rng, (2, 6, 256)), _pm1(rng, (2, 40, 256))
    tq, tk = torch.from_numpy(qb), torch.from_numpy(kb)
    tiled = t_bacam.bacam_scores(tq, tk, exact=False, adc_bits=7)
    assert torch.equal(tiled, t_bacam.bacam_scores(tq, tk).to(torch.float32))
    jkey, tkey = _key(5)
    got = t_bacam.bacam_scores(tq, tk, exact=False, adc_bits=6,
                               noise_sigma=0.014, rng=tkey).numpy()
    want = np.asarray(j_scores(jnp.asarray(qb), jnp.asarray(kb),
                               exact=False, adc_bits=6, noise_sigma=0.014,
                               rng=jkey))
    near = _near_boundary(_noisy_matches(qb, kb, tkey, 0.014), 6).any(-1)
    print(f"d 256, 6-bit ADC with noise: {int(near.sum())} of {near.size} "
          f"scores with a tile near a rounding boundary")
    np.testing.assert_array_equal(got[~near], want[~near])
    with pytest.raises(ValueError, match="must tile by cam_w=64"):
        t_bacam.bacam_scores(tq[..., :96], tk[..., :96], exact=False,
                             adc_bits=7)


# ---------------- attention with the device model ----------------

SPECS = {"adc6": dict(adc_bits=6), "noise": dict(noise_sigma=0.014),
         "adc6+noise": dict(adc_bits=6, noise_sigma=0.014)}


def _qkv(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 4, 8, 64)).astype(np.float32)  # G = 2
    k, v = (rng.standard_normal((2, 2, 24, 64)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _rows_near_boundary(q, k, tkey, kw):
    """(B, H, Sq) query rows with a score near an ADC boundary."""
    if "adc_bits" not in kw or "noise_sigma" not in kw:
        return np.zeros((q.shape[0], q.shape[1], q.shape[2]), bool)
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    qb, kb, _, _ = binarize_qk(
        torch.from_numpy(q).reshape(b, hkv, h // hkv, sq, d),
        torch.from_numpy(k), with_scales=True)
    m = _noisy_matches(qb.numpy(), kb[:, :, None].numpy(), tkey,
                       kw["noise_sigma"])
    near = _near_boundary(m, kw["adc_bits"]).any(axis=(-1, -2))
    return near.reshape(b, h, sq)


@pytest.mark.parametrize("mode", ["binary", "camformer"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_attention_with_rng_matches_reference_gqa(mode, name):
    """GQA (4 heads on 2 kv heads), causal, the noise keyed by ``rng``
    over the broadcast (B, H_kv, G, Sq, Skv, tiles) shape."""
    kw = dict(SPECS[name], k_top=8, group_size=4)
    q, k, v = _qkv(6)
    jkey, tkey = _key(3)
    got = tcore.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          tcore.AttentionSpec(mode=mode, **kw), rng=tkey)
    want = np.asarray(j_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  JSpec(mode=mode, **kw), rng=jkey))
    near = _rows_near_boundary(q, k, tkey, SPECS[name])
    print(f"{mode} {name}: {int(near.sum())} of {near.size} rows with a "
          f"score near an ADC boundary")
    np.testing.assert_allclose(got.numpy()[~near], want[~near], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["noise", "adc6+noise"])
def test_sign_ste_gradients_on_the_device_path(name):
    """``trainable_binarize``: on the device path the ±1 operands are
    multiplied as floats, so the straight-through sign's gradient reaches
    Q and K through the scores (with noise alone; the ADC's rounding
    passes none) as well as through the HAD scales; q, k and v gradients
    1e-4."""
    kw = dict(SPECS[name], k_top=8, group_size=4, trainable_binarize=True)
    q, k, v = _qkv(7)
    w = np.random.default_rng(8).standard_normal((2, 4, 8, 64)).astype(
        np.float32)
    jkey, tkey = _key(4)

    def j_loss(q, k, v):
        out = j_attention(q, k, v, JSpec(mode="binary", **kw), rng=jkey)
        return jnp.sum(out * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tcore.attention(*leaves, tcore.AttentionSpec(mode="binary", **kw),
                          rng=tkey)
    (out * torch.from_numpy(w)).sum().backward()
    assert _rows_near_boundary(q, k, tkey, SPECS[name]).sum() == 0
    for t, j in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   rtol=1e-4, atol=1e-4)
    if name == "noise":  # the scores' own path adds to the scales'
        no_ste = dict(kw, trainable_binarize=False)
        leaves2 = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = tcore.attention(*leaves2,
                              tcore.AttentionSpec(mode="binary", **no_ste),
                              rng=tkey)
        (out * torch.from_numpy(w)).sum().backward()
        assert not torch.allclose(leaves[0].grad, leaves2[0].grad)


# ---------------- top-k, recall, Hoeffding ----------------

def test_single_stage_topk_ties_and_mask_match_reference():
    rng = np.random.default_rng(9)
    scores = rng.integers(-8, 8, (4, 3, 128)).astype(np.float32)  # ties
    where = rng.random((4, 3, 128)) > 0.3
    for mask in (None, where):
        tv, ti = tcore.single_stage_topk(
            torch.from_numpy(scores), 32,
            None if mask is None else torch.from_numpy(mask))
        jv, ji = j_single(jnp.asarray(scores), 32,
                          None if mask is None else jnp.asarray(mask))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert ti.dtype == torch.int32


def test_two_stage_equals_single_stage_when_spread():
    """When every group holds at most stage1_k of the true top-k, recall
    is 1; the recall of a generic input equals the reference's."""
    rng = np.random.default_rng(0)
    n, k, g = 512, 16, 16
    scores = rng.normal(size=(4, n)).astype(np.float32)
    for b in range(4):
        for j, grp in enumerate(rng.choice(n // g, size=k, replace=False)):
            scores[b, grp * g + rng.integers(g)] = 100.0 + j
    t = torch.from_numpy(scores)
    tv, ti = tcore.two_stage_topk(t, k=k, group_size=g, stage1_k=2)
    sv, si = tcore.single_stage_topk(t, k)
    assert float(tcore.topk_recall(ti, si).mean()) == 1.0
    assert torch.equal(torch.sort(tv).values, torch.sort(sv).values)
    s = rng.normal(size=(64, 1024)).astype(np.float32)
    ts = torch.from_numpy(s)
    got = tcore.topk_recall(tcore.two_stage_topk(ts, 32, 16, 2)[1],
                            tcore.single_stage_topk(ts, 32)[1])
    js = jnp.asarray(s)
    want = j_recall(j_two_stage(js, 32, 16, 2)[1], j_single(js, 32)[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert got.dtype == torch.float32 and float(got.mean()) < 1.0


def test_hoeffding_bound_matches_reference():
    for args in [(256, 0.25, 32, 1024), (256, 0.15, 32, 1024),
                 (512, 0.15, 32, 1024), (64, 0.0, 32, 1024),
                 (64, 0.3, 8, 64)]:
        got = tcore.hoeffding_drop_bound(*args)
        assert type(got) is float and got == j_hoeffding(*args)
    h = tcore.hoeffding_drop_bound
    assert h(256, 0.25, 32, 1024) < h(256, 0.15, 32, 1024)
    assert h(512, 0.15, 32, 1024) < h(256, 0.15, 32, 1024)
    assert h(64, 0.0, 32, 1024) == 1.0 and h(256, 0.25, 32, 1024) < 1e-3


# ---------------- energy / system simulator ----------------

def test_energy_model_matches_reference():
    """Table II's rows, Fig. 8's breakdown and stage cycles (Fig. 9),
    Fig. 5's amortization and the area: equal to the reference's, and
    the reference's own claims."""
    assert t_energy.table2_rows() == j_energy.table2_rows()
    assert t_energy.attention_query_cost() == j_energy.attention_query_cost()
    assert t_energy.area_mm2(16) == j_energy.area_mm2(16)
    assert t_energy.energy_vs_m() == j_energy.energy_vs_m()
    rows = t_energy.table2_rows()
    ours, pub = rows["CAMformer (ours, simulated)"], \
        t_energy.PUBLISHED_CAMFORMER
    for key in ("thr_qry_ms", "eff_qry_mj"):
        assert abs(ours[key] - pub[key]) / pub[key] < 0.02
    assert abs(ours["area_mm2"] - pub["area_mm2"]) < 0.01
    mha = rows["CAMformer_MHA (ours, simulated)"]
    assert abs(mha["thr_qry_ms"]
               - t_energy.PUBLISHED_CAMFORMER_MHA["thr_qry_ms"]) \
        / t_energy.PUBLISHED_CAMFORMER_MHA["thr_qry_ms"] < 0.02
    c = t_energy.attention_query_cost()
    s = c["energy_shares"]
    assert abs(s["v_sram"] - 0.31) < 0.03 and abs(s["mac"] - 0.26) < 0.03
    sc = c["stage_cycles"]
    assert sc["contextualization"] >= max(sc["association"],
                                          sc["normalization"])
    e = t_energy.energy_vs_m((1, 16, 256))
    assert e[1] > e[16] > e[256]
