"""The port's paged LM forward against the JAX reference, through the
weight bridge: ``lm_prefill_paged`` (without offsets, then a suffix with
offsets, as the engine's continuous prefill does) and 4
``lm_decode_paged`` steps, logits to 1e-4, for ``camformer-bert``
(G = 1) and ``mistral-nemo-12b`` (G = 4) smoke configs on ``dense``,
``camformer`` and the mixed ``dense,camformer`` stack, with the
``prefill_chunk`` loop, and with qkv biases (``codeqwen1.5-7b``); the
MoE family at ``granite-moe-3b-a800m``'s G = 3 (6 heads on 2 kv heads)
and ``moonshot-v1-16b-a3b`` smoke, and the text-only VLM backbone
(``llava-next-mistral-7b`` smoke).

Both sides are fed the same token ids (the reference's greedy picks), so
one argmax near-tie cannot fork the two streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import get_model_def
from repro.models.module import init_params as j_init

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import (from_jax_params, init_params, init_pools,
                                lm_decode_paged, lm_page_specs,
                                lm_prefill_paged)


# granite's GQA group at smoke width: G = 24 / 8 = 3
OVERRIDES = {"granite-moe-3b-a800m": dict(n_heads=6, n_kv_heads=2)}


def _configs(arch, backend, prefill_chunk=0):
    kw = ({"layer_backends": tuple(backend.split(","))} if "," in backend
          else {"attn_backend": backend})
    kw["prefill_chunk"] = prefill_chunk
    kw.update(OVERRIDES.get(arch, {}))
    return j_smoke(arch, **kw), t_smoke(arch, **kw)


def _jax_params(cfg):
    """The reference's parameters; zero-initialised qkv biases get random
    values so the bias add is exercised."""
    md = get_model_def(cfg)
    params = j_init(md.specs(cfg), jax.random.PRNGKey(0))
    attn = params["blocks"]["attn"]
    rng = np.random.default_rng(2)
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = jnp.asarray(
                rng.standard_normal(attn[name].shape).astype(np.float32))
    return md, params, jax.tree.map(np.asarray, params)


def test_weight_bridge_maps_every_leaf():
    jcfg, tcfg = _configs("mistral-nemo-12b", "dense")
    _, _, params_np = _jax_params(jcfg)
    tp = from_jax_params(params_np, tcfg, device="cpu")
    assert len(tp["blocks"]) == tcfg.n_layers
    np.testing.assert_array_equal(tp["embed"]["tok"].numpy(),
                                  params_np["embed"]["tok"])
    np.testing.assert_array_equal(tp["embed"]["head"].numpy(),
                                  params_np["embed"]["head"])
    np.testing.assert_array_equal(tp["ln_f"]["scale"].numpy(),
                                  params_np["ln_f"]["scale"])
    for i, blk in enumerate(tp["blocks"]):
        for mod, leaves in params_np["blocks"].items():
            assert set(blk[mod]) == set(leaves)
            for name, arr in leaves.items():
                np.testing.assert_array_equal(blk[mod][name].numpy(), arr[i])
    # the port's own init draws the same shapes
    own = init_params(tcfg, device="cpu", seed=1)
    assert jax.tree.map(np.shape, params_np["embed"]) == {
        k: tuple(v.shape) for k, v in own["embed"].items()}
    for mod, leaves in own["blocks"][0].items():
        for name, t in leaves.items():
            assert tuple(t.shape) == params_np["blocks"][mod][name].shape[1:]


CASES = [(arch, backend, 0)
         for arch in ("camformer-bert", "mistral-nemo-12b")
         for backend in ("dense", "camformer", "dense,camformer")]
# the prefill_chunk loop: 8-token prompt heads in chunks of 4
CASES += [("camformer-bert", "camformer", 4), ("mistral-nemo-12b", "dense", 4)]
# qkv biases
CASES += [("codeqwen1.5-7b", "camformer", 0)]
# the MoE family (G = 3, padded experts; no padding) and the VLM backbone
CASES += [("granite-moe-3b-a800m", "dense", 0),
          ("granite-moe-3b-a800m", "camformer", 0),
          ("granite-moe-3b-a800m", "dense", 4),
          ("moonshot-v1-16b-a3b", "camformer", 0),
          ("llava-next-mistral-7b", "dense,camformer", 0)]


@pytest.mark.parametrize("arch,backend,prefill_chunk", CASES)
def test_paged_forward_logits_match_reference(arch, backend, prefill_chunk):
    jcfg, tcfg = _configs(arch, backend, prefill_chunk)
    md, jparams, params_np = _jax_params(jcfg)
    tparams = from_jax_params(params_np, tcfg, device="cpu")
    b, page, np_ = 3, 4, 8
    n_pages = 1 + b * np_
    specs = md.page_specs(jcfg, n_pages, page, b)
    is_leaf = lambda x: (isinstance(x, tuple) and len(x) == 2
                         and isinstance(x[0], jax.ShapeDtypeStruct))
    jpools = jax.tree.map(lambda t: jnp.zeros(t[0].shape, t[0].dtype), specs,
                          is_leaf=is_leaf)
    tpools = init_pools(lm_page_specs(tcfg, n_pages, page, b), "cpu")
    table = (1 + np.arange(b * np_, dtype=np.int32)).reshape(b, np_)
    table[2] = 0  # slot 2 is idle throughout (inert rows)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab, (b, 16)).astype(np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)

    j_prefill = jax.jit(md.prefill_paged, static_argnums=4)
    j_decode = jax.jit(md.decode_paged, static_argnums=6)

    def both(jbatch):
        jl, jp = j_prefill(
            jparams, {k: jnp.asarray(v) for k, v in jbatch.items()}, jpools,
            jt, jcfg)
        tl, tp = lm_prefill_paged(
            tparams, {k: torch.from_numpy(v) for k, v in jbatch.items()},
            tpools, tt, tcfg)
        return jl, jp, tl, tp

    # prompt heads (no offsets), then the suffixes at per-slot offsets
    lens1 = np.array([8, 5, 0], np.int32)
    jl, jpools, tl, tpools = both({"tokens": tokens[:, :8], "lens": lens1})
    live = lens1 > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=1e-4, atol=1e-4)
    lens2 = np.array([14, 9, 0], np.int32)
    suffix = np.stack([tokens[0, 8:14], np.r_[tokens[1, 5:9], 0, 0],
                       np.zeros(6, np.int32)]).astype(np.int32)
    jl, jpools, tl, tpools = both({"tokens": suffix, "lens": lens2,
                                   "offsets": lens1})
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=1e-4, atol=1e-4)

    pos = lens2.copy()
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        kv_len = np.where(live, pos + 1, 0).astype(np.int32)
        jl, jpools = j_decode(
            jparams, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(kv_len),
            jpools, jt, jcfg)
        tl, tpools = lm_decode_paged(
            tparams, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(kv_len), tpools, tt, tcfg)
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=1e-4, atol=1e-4)
        assert np.all(tl.numpy()[:, jcfg.vocab:] == -1e9)
        pos = pos + live
