"""The port's sharded contiguous prefill and serve steps against the JAX
package's unsharded ``make_prefill_step`` / ``make_serve_step`` on the
same weights (``from_jax_params``), at f32 smoke width.

One module-scoped run starts 4 processes of ``tests/torch_serve_worker.py``
(a file rendezvous under tmp_path, no TCP port; killed after 300 s)
while this process runs the reference.  Each case of its ``CASES``
prefills a 16-token prompt into 32-slot caches and takes 8 greedy steps
on make_mesh_for(4, model) through ``make_prefill_step(mesh=)`` /
``make_serve_step(mesh=)``: the gathered logits within 1e-4 of the
reference's at every step, the greedy tokens identical, the gathered
caches' float leaves within 1e-5 and their packed keys and integer
leaves bit-exact, every rank's logits the same.  The cases cover
``heads`` (camformer-bert at model 2 and 4), ``qheads`` with the
experts split (granite), ``q_seq`` with a ring whose sequence splits
over ``model`` (recurrentgemma with 6 q heads on one kv head at 4),
``qheads`` over such a ring (at 2), the B = 1 ``distributed_topk``
search over a cache split along (``data``, ``model``), and the ``dp``
profile, whose rows take every axis.  Share mode, in one process, is
``tests/test_torch_serve_shares.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import smoke_config as j_smoke
from repro.launch.steps import make_prefill_step as j_prefill_step
from repro.launch.steps import make_serve_step as j_serve_step
from repro.models import get_model_def as j_model_def
from repro.models.module import init_params as j_init

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch import steps as S
from repro_torch.models import from_jax_params, get_model_def
from repro_torch.models.convert import stack_blocks

from torch_serve_worker import CACHE_LEN, CASES, PROMPT_LEN, STEPS
from torch_tp_worker import run_ranks

_IS_SPEC = (lambda x: isinstance(x, tuple) and len(x) == 2
            and isinstance(x[0], jax.ShapeDtypeStruct))


def _setup(arch, over):
    jc, tc = j_smoke(arch, **over), t_smoke(arch, **over)
    md = j_model_def(jc)
    jp = j_init(md.specs(jc), jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, md, jp, tp


def _prompt(cfg, batch, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, PROMPT_LEN)).astype(np.int32)


def reference(arch, over, batch, extra=None):
    """The JAX package's unsharded steps: the prompt and ``STEPS`` greedy
    steps, each step's logits, the tokens and the caches."""
    jc, _, md, jp, _ = _setup(arch, over)
    caches = jax.tree.map(lambda t: jnp.zeros(t[0].shape, t[0].dtype),
                          md.cache_specs(jc, batch, CACHE_LEN),
                          is_leaf=_IS_SPEC)
    prefill = jax.jit(j_prefill_step(md, jc))
    serve = jax.jit(j_serve_step(md, jc))
    feed = {"tokens": jnp.asarray(_prompt(jc, batch)),
            **{k: jnp.asarray(v) for k, v in (extra or {}).items()}}
    logits, caches = prefill(jp, feed, caches)
    outs, toks = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        pos = jnp.full((batch,), PROMPT_LEN + i, jnp.int32)
        logits, caches = serve(jp, tok, pos, pos + 1, caches)
        outs.append(np.asarray(logits))
    return dict(logits=outs, tokens=toks,
                caches=jax.tree.map(np.asarray, caches))


def _close_caches(port, ref):
    """Port caches (gathered, the port's per-layer layout) against the
    reference's: packed keys and integer leaves bit-exact, float leaves
    within 1e-5."""
    got = jax.tree_util.tree_leaves_with_path(stack_blocks(port))
    want = dict(jax.tree_util.tree_leaves_with_path(ref))
    assert len(got) == len(want)
    for path, t in got:
        w = np.asarray(want[path])
        if w.dtype == np.uint32:
            np.testing.assert_array_equal(t, w.view(np.int32), str(path))
        elif np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(t, w, str(path))
        else:
            np.testing.assert_allclose(t, w, rtol=1e-5, atol=1e-5,
                                       err_msg=str(path))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_split")
    for name, arch, over, _, batch, _ in CASES:
        jc, tc, _, _, tp = _setup(arch, over)
        torch.save(tp, out / f"params_{name}.pt")
        torch.save(torch.from_numpy(_prompt(jc, batch)),
                   out / f"prompt_{name}.pt")

    def refs():  # cases on the same config and batch share one run
        runs = {}
        for name, arch, over, _, batch, _ in CASES:
            key = (arch, tuple(sorted(over.items())), batch)
            if key not in runs:
                runs[key] = reference(arch, over, batch)
            runs[name] = runs[key]
        return runs

    return run_ranks(out, "serve", refs, worker=__import__(
        "torch_serve_worker").__file__)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_sharded_steps_match_the_reference(ranks, name):
    refs, res = ranks
    got, want = res[0][name], refs[name]
    for step, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"{name} step {step}")
    for g, w in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(g.numpy(), w)
    _close_caches(got["caches"], want["caches"])
    for r in res[1:]:  # every rank gathers the same logits
        for g, o in zip(got["logits"], r[name]["logits"]):
            assert torch.equal(g, o)


# what each case's split ran on (partitioning.SPLIT_SEEN)
SEEN = {
    "camformer": dict(attn_q_heads=2, attn_kv_heads=2, mlp_cols=48,
                      vocab_rows=128),
    "dense_m4": dict(attn_q_heads=1, attn_kv_heads=1, mlp_cols=24,
                     vocab_rows=64),
    "granite": dict(attn_q_heads=2, attn_kv_cols=16, experts=4,
                    vocab_rows=128),
    "rg_q_seq": dict(attn_q_rows=4, attn_whole_heads=6, attn_q_cols=48,
                     attn_kv_cols=8, rnn=16, vocab_rows=64),
    "rg_qheads": dict(attn_q_heads=3, attn_kv_cols=16, rnn=32,
                      vocab_rows=128),
    "dist_topk": dict(attn_q_heads=2, attn_kv_cols=16, mlp_cols=48,
                      vocab_rows=128),
    "dp": {},
}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_each_case_ran_its_split(ranks, name):
    """The regions ran on the local extents of the case's strategy:
    heads, qheads (with fewer token rows than d_model, each process's
    16 of wk / wv's 32 columns, the features all-gathered), q_seq (a
    16-row prompt's 4 rows at model 4; its decode steps run the
    attention whole on the projections' gathered columns, 48 of wq's
    192 and 8 of wk's 32) or, under dp, no split at all."""
    seen = ranks[1][0][name]["seen"]
    assert {k: seen.get(k) for k in SEEN[name]} == SEEN[name]
    if name == "dp":
        assert seen == {}


def test_cache_blocks_follow_the_cache_rules():
    """``init_caches`` on a shape-only (2, 2) mesh's specs: the ring of
    recurrentgemma with one kv head splits its sequence over ``model``,
    granite's caches over ``model`` as well (one kv head), camformer-
    bert's over its heads."""
    from repro_torch.launch.mesh import MeshShape

    mesh = MeshShape(("data", "model"), (2, 2))
    for arch, over, leaf, want in (
            ("recurrentgemma-2b", dict(n_heads=6), ("attn", 0, "v"),
             ("data", None, "model", None)),
            ("granite-moe-3b-a800m", {}, (0, "v"),
             ("data", None, "model", None)),
            ("camformer-bert", {}, (0, "v"),
             ("data", "model", None, None))):
        cfg = t_smoke(arch, **over)
        _, specs = S.cache_specs_trees(get_model_def(cfg), cfg, 4, CACHE_LEN,
                                       mesh)
        for key in leaf:
            specs = specs[key]
        assert specs == want, arch
