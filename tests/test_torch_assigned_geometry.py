"""The port against the JAX reference at the assigned LMs' geometry, and
the reference APIs the port closes.

* The paged forward (``lm_prefill_paged``, then 4 ``lm_decode_paged``
  steps, logits to 1e-4, weights bridged by ``from_jax_params``) at
  ``head_dim=128`` (W = 4 packed key words): yi-34b's G = 7 (7 heads on
  1 kv head) on ``camformer`` and ``dense``, and codeqwen1.5-7b's MHA
  with qkv biases on ``camformer``.  The reference runs its plain
  (``gather``) paged route, as ``tests/test_torch_model.py`` runs it.
* ``init_params(..., dtype=)`` equals the float32 draw cast afterwards,
  bit for bit.
* ``cache_bytes_per_token`` and ``paged_io_stats`` of the four backends
  equal the reference's methods, at float32 and bfloat16.
* ``make_batch_arrays`` equals ``SyntheticLMData(...).batch(step)`` and
  has the reference's keys, shapes and dtypes (a one-device CPU mesh on
  the reference's side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.configs import smoke_config as j_smoke
from repro.core.backend import get_backend as j_backend
from repro.launch.mesh import make_mesh_for
from repro.train.data import make_batch_arrays as j_batch

from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import get_config as t_config
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.backend import get_backend as t_backend
from repro_torch.models import (cast_params, from_jax_params, init_params,
                                init_pools, lm_decode_paged, lm_page_specs,
                                lm_prefill_paged)
from repro_torch.models.module import tree_leaves
from repro_torch.train.data import SyntheticLMData, make_batch_arrays

from test_torch_model import _jax_params

# a small train shape in both packages' tables (as test_torch_trainer.py)
TINY = dict(seq_len=64, global_batch=4, kind="train")
J_SHAPES.setdefault("tiny", TINY)
T_SHAPES.setdefault("tiny", TINY)

# head_dim 128 as every assigned dense LM has it; the heads of one kv
# group as the full config has them (yi-34b 56 / 8 = 7, codeqwen MHA)
GEOMETRY = {"yi-34b": dict(n_heads=7, n_kv_heads=1, head_dim=128),
            "codeqwen1.5-7b": dict(n_heads=2, n_kv_heads=2, head_dim=128)}


@pytest.mark.parametrize("arch,backend", [("yi-34b", "camformer"),
                                          ("yi-34b", "dense"),
                                          ("codeqwen1.5-7b", "camformer")])
def test_paged_forward_at_assigned_geometry(arch, backend):
    kw = dict(GEOMETRY[arch], attn_backend=backend, n_layers=1)
    jcfg, tcfg = j_smoke(arch, **kw), t_smoke(arch, **kw)
    assert tcfg.n_heads // tcfg.n_kv_heads == (
        t_config(arch).n_heads // t_config(arch).n_kv_heads)
    md, jparams, params_np = _jax_params(jcfg)  # random qkv biases
    tparams = from_jax_params(params_np, tcfg, device="cpu")
    b, page, np_ = 3, 4, 6
    n_pages = 1 + b * np_
    is_leaf = lambda x: (isinstance(x, tuple) and len(x) == 2
                         and isinstance(x[0], jax.ShapeDtypeStruct))
    jpools = jax.tree.map(lambda t: jnp.zeros(t[0].shape, t[0].dtype),
                          md.page_specs(jcfg, n_pages, page, b),
                          is_leaf=is_leaf)
    tpools = init_pools(lm_page_specs(tcfg, n_pages, page, b), "cpu")
    table = (1 + np.arange(b * np_, dtype=np.int32)).reshape(b, np_)
    table[2] = 0  # slot 2 is idle throughout (inert rows)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab, (b, 12)).astype(np.int32)
    lens = np.array([12, 7, 0], np.int32)
    live = lens > 0

    jl, jpools = jax.jit(md.prefill_paged, static_argnums=4)(
        jparams, {"tokens": jnp.asarray(tokens), "lens": jnp.asarray(lens)},
        jpools, jt, jcfg)
    tl, tpools = lm_prefill_paged(
        tparams, {"tokens": torch.from_numpy(tokens),
                  "lens": torch.from_numpy(lens)}, tpools, tt, tcfg)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=1e-4, atol=1e-4)
    j_decode = jax.jit(md.decode_paged, static_argnums=6)
    pos = lens.copy()
    for _ in range(4):  # both sides take the reference's greedy picks
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
        pos = pos + live


@pytest.mark.parametrize("arch", ["yi-34b", "moonshot-v1-16b-a3b",
                                  "camformer-bert"])
def test_init_params_dtype_is_the_cast_draw(arch):
    cfg = t_smoke(arch)
    got = init_params(cfg, device="cpu", seed=3, dtype=torch.bfloat16)
    want = cast_params(init_params(cfg, device="cpu", seed=3),
                       torch.bfloat16)
    got_l, want_l = tree_leaves(got), tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.dtype == w.dtype == torch.bfloat16
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))


@pytest.mark.parametrize("backend", ["dense", "binary", "camformer",
                                     "hybrid"])
def test_cache_and_io_accounting_match_reference(backend):
    for arch in ("yi-34b", "codeqwen1.5-7b", "camformer-bert"):
        tcfg, jcfg = t_config(arch), j_config(arch)
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            assert (t_backend(backend).cache_bytes_per_token(tcfg, tdt)
                    == j_backend(backend).cache_bytes_per_token(jcfg, jdt))
            for kv_len, page, n_table in ((0, 64, 16), (1, 64, 16),
                                          (21, 8, 4), (1000, 64, 16),
                                          (40, 16, 3)):
                kw = dict(kv_len=kv_len, page_size=page,
                          n_table_pages=n_table)
                assert (t_backend(backend).paged_io_stats(tcfg, tdt, **kw)
                        == j_backend(backend).paged_io_stats(jcfg, jdt,
                                                             **kw))


@pytest.mark.parametrize("arch,shape", [("camformer-bert", "tiny"),
                                        ("llava-next-mistral-7b", "tiny")])
def test_make_batch_arrays(arch, shape):
    cfg = t_smoke(arch)
    got = make_batch_arrays(cfg, shape, step=2, seed=5, device="cpu")
    want = SyntheticLMData(cfg, shape, 5, "cpu").batch(2)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k
    ref = j_batch(j_smoke(arch), shape, make_mesh_for(1, 1), step=2, seed=5)
    assert set(got) == set(ref)
    for k, arr in ref.items():
        assert tuple(got[k].shape) == arr.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(arr.dtype), k
    # the token stream is the reference's bit for bit
    for k in ("tokens", "labels", "loss_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
