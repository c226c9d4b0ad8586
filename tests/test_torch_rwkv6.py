"""The port's RWKV-6 family (``rwkv6-3b``, family ``ssm``) against the JAX
reference at f32 smoke width, the same numpy inputs through both and the
reference's weights carried over by ``models.from_jax_params``: the time
mix and the channel mix from a nonzero carried state (1e-5); prefill
and 8 decode steps (logits 1e-4, greedy picks equal, both sides fed the
reference's picks; the carried shifts and WKV state 1e-5); the loss
(1e-5) and every gradient leaf (1e-4) under ``remat="full"``;
checkpoints written by either package restored by the other; the train
CLI on the CPU; and every config of the registry building."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.launch.steps import cast_params as j_cast
from repro.models import get_model_def as j_model_def
from repro.models import rwkv6 as j_rwkv6
from repro.models.module import init_params as j_init
from repro.train import checkpoint as j_ckpt

from repro_torch.configs import get_config, list_archs
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_value_and_grad)
from repro_torch.models import (from_jax_params, get_model_def, init_params,
                                init_pools)
from repro_torch.models import rwkv6 as t_rwkv6
from repro_torch.models.convert import stack_blocks
from repro_torch.models.module import param_shapes
from repro_torch.train import checkpoint as t_ckpt

ARCH = "rwkv6-3b"
TOL = 1e-5
# the smoke width (one head of 64) and a two-head width
WIDTHS = {"smoke": {}, "two heads": dict(d_model=128)}


def _setup(**kw):
    jc, tc = j_smoke(ARCH, **kw), t_smoke(ARCH, **kw)
    md = j_model_def(jc)
    jp = j_init(md.specs(jc), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, md, jp, tp


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_every_config_builds():
    """The registry has every family: each config's model definition and
    parameter shapes build (rwkv6-3b at about 3.07 G parameters)."""
    names = list_archs()
    assert len(names) == 11
    for name in names:
        cfg = get_config(name)
        md = get_model_def(cfg)
        assert md.shapes is not None and md.cache_specs is not None
    cfg = get_config(ARCH)
    n = 0
    stack = [param_shapes(cfg)]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, list):
            stack.extend(node)
        else:
            n += int(np.prod(node[0]))
    assert 3.0e9 < n < 3.15e9, n
    assert get_model_def(cfg).page_specs is None  # no paged interface


@pytest.mark.parametrize("s", [1, 7])
def test_time_and_channel_mix_match_reference(s):
    """Both mixes of layer 1 from a nonzero carry-in and WKV state: the
    outputs, the new shifts and the new state."""
    jc, tc, _, jp, tp = _setup(d_model=128)
    h, c, d = 2, 64, 128
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    prev = rng.standard_normal((2, d)).astype(np.float32)
    state = (0.1 * rng.standard_normal((2, h, c, c))).astype(np.float32)
    pj = jax.tree.map(lambda a: a[1], jp["blocks"])
    pt = tp["blocks"][1]
    want = j_rwkv6._time_mix(pj["tm"], jnp.asarray(x), jc, jnp.asarray(prev),
                             jnp.asarray(state))
    got = t_rwkv6._time_mix(pt["tm"], torch.from_numpy(x), tc,
                            torch.from_numpy(prev), torch.from_numpy(state))
    for g, w in zip(got, want):
        _close(g, w)
    want = j_rwkv6._channel_mix(pj["cm"], jnp.asarray(x), jc,
                                jnp.asarray(prev))
    got = t_rwkv6._channel_mix(pt["cm"], torch.from_numpy(x), tc,
                               torch.from_numpy(prev))
    for g, w in zip(got, want):
        _close(g, w)


def _zero_caches(md, jc, b):
    return jax.tree.map(lambda t: jnp.zeros(t[0].shape, t[0].dtype),
                        md.cache_specs(jc, b, 0),
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_prefill_decode_match_reference(width):
    """Prefill of 12 tokens then 8 greedy steps: logits 1e-4 at every
    step, picks equal; the carried state (the shifts, the last rows of
    the normed inputs, and the WKV matrices) 1e-5 after prefill and at
    the end; ``pos`` and ``kv_len`` are ignored."""
    jc, tc, md, jp, tp = _setup(**WIDTHS[width])
    b, prompt, steps = 2, 12, 8
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jc.vocab, (b, prompt)).astype(np.int32)
    jcaches = _zero_caches(md, jc, b)
    tmd = get_model_def(tc)
    tcaches = init_pools(tmd.cache_specs(tc, b, prompt + steps), "cpu")
    assert tcaches["wkv"].shape == (tc.n_layers, b, tc.d_model // 64, 64,
                                    64)
    jl, jcaches = jax.jit(md.prefill, static_argnums=3)(
        jp, {"tokens": jnp.asarray(tokens)}, jcaches, jc)
    tl, tcaches = make_prefill_step(tmd, tc)(
        tp, {"tokens": torch.from_numpy(tokens)}, tcaches)
    for n, t in tcaches.items():
        _close(t, jcaches[n])
    j_decode = jax.jit(md.decode, static_argnums=5)
    t_serve = make_serve_step(tmd, tc)
    pos = np.full((b,), prompt, np.int32)
    for step in range(steps + 1):
        _close(tl, jl, 1e-4)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        if step == steps:
            break
        jl, jcaches = j_decode(jp, jnp.asarray(tok), jnp.asarray(pos),
                               jnp.asarray(pos + 1), jcaches, jc)
        # positions are implicit in the state: any pos / kv_len will do
        tl, tcaches = t_serve(tp, torch.from_numpy(tok),
                              torch.from_numpy(pos * 0 + 99),
                              torch.from_numpy(pos * 0), tcaches)
        pos = pos + 1
    for n, t in tcaches.items():
        _close(t, jcaches[n])


def test_loss_and_every_gradient_leaf():
    """The loss and ce (1e-5) and every gradient leaf (1e-4), each block
    recomputed in the backward (``remat="full"``), a loss mask applied."""
    jc, tc, md, jp, tp = _setup(d_model=128, remat="full")
    rng = np.random.default_rng(3)
    b, s = 2, 16
    batch = {"tokens": rng.integers(0, jc.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, jc.vocab, (b, s)).astype(np.int32),
             "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, bt: md.loss(j_cast(p, jnp.float32), bt, jc),
        has_aux=True))(jp, jax.tree.map(jnp.asarray, batch))
    tl, taux, tg = make_value_and_grad(get_model_def(tc), tc)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(taux["ce"]), float(jaux["ce"]),
                               rtol=1e-5, atol=1e-5)
    ported = stack_blocks(tg)
    leaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(leaves) == len(jax.tree.leaves(ported))
    for path, want in leaves:
        got = ported
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_checkpoints_both_directions(tmp_path):
    """The port's ``blocks`` list stacks back to the reference's arrays
    bit for bit; a checkpoint written by either package restores in the
    other."""
    _, tc, _, jp, tp = _setup()
    stacked = stack_blocks(tp)
    for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
        got = stacked
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, np.asarray(want))
    t_ckpt.save_checkpoint(str(tmp_path / "t"), {"params": tp}, 3)
    restored, step = j_ckpt.restore_checkpoint(
        str(tmp_path / "t"), {"params": jax.tree.map(jnp.zeros_like, jp)})
    assert step == 3
    for a, b in zip(jax.tree.leaves(restored["params"]),
                    jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    j_ckpt.save_checkpoint(str(tmp_path / "j"), {"params": jp}, 5)
    into = {"params": init_params(tc, device="cpu", seed=1)}
    t_ckpt.restore_checkpoint(str(tmp_path / "j"), into)
    for a, b in zip(jax.tree.leaves(stack_blocks(into)["params"]),
                    jax.tree.leaves(stack_blocks({"params": tp})["params"])):
        np.testing.assert_array_equal(a, b)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch rwkv6-3b --smoke
    --device cpu``: one step, a finite loss, a checkpoint at step 1."""
    from repro_torch.launch import train

    train.main(["--arch", ARCH, "--smoke", "--steps", "1", "--device", "cpu",
                "--ckpt-every", "1", "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    row = next(line for line in out.splitlines()
               if line.startswith("{'step': 1,"))
    assert "'loss': nan" not in row
    assert t_ckpt.latest_step(str(tmp_path / "ck")) == 1
