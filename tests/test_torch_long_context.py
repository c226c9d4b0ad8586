"""Half a million positions on the CPU: the port against the JAX package
at mistral-nemo-12b's smoke width (f32, 2 layers, G = 4 query heads on
one kv head, head_dim 32, 4-key groups, top-8).

  * RoPE at positions 524,280-524,287: at identical float32 arguments
    XLA's and PyTorch's ``cos`` / ``sin`` agree within an ulp, but
    PyTorch's float32 ``theta ** e`` is an ulp off the reference's in a
    few channels at head_dim 128, which moves an angle by up to 4e-3 rad
    there.  The port rounds the frequencies from float64 and matches.
  * The paged decode at positions 524,280-524,287 (8 steps) over a table
    of 8,192 64-key pages (524,288 positions) that alias 8 physical
    pages, as COW sharing does, the last page the slot's own: camformer
    (``fused`` and ``gather``) and dense (``gather``) against the
    reference's ``paged_impl="gather"`` route.  Dense's ``fused`` route
    on the CPU is the paged flash kernel's plain version, a Python loop
    over the 8,192 pages; it sums the keys in another order (a page at a
    time, with an online softmax) than the gather's one softmax, and
    the two part by more than 1e-4 at this length in either package.
  * camformer's contiguous ``make_serve_step`` over a 524,288-position
    cache, with and without ``use_kernel``, against the reference's
    decode step.

Logits within 1e-4; camformer's stage-1 candidates identical between the
port's routes at every step, and equal to the reference's stage-1 oracle
on the same packed rows at the first and the last step.  Both sides are
fed the reference's greedy picks."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.models import get_model_def as j_model_def
from repro.models.layers import rope as j_rope
from repro.models.module import init_params as j_init

import repro_torch.core.topk as ttopk
import repro_torch.kernels.ops as kops
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.topk import NEG_INF
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import (from_jax_params, get_model_def, init_pools,
                                lm_decode_paged, lm_page_specs)
from repro_torch.models.layers import rope as t_rope

ARCH = "mistral-nemo-12b"
FILLED = 524_280  # positions written before the first step
STEPS = 8  # the last step's kv_len is 524,288
PAGE, N_COLS, SHARED = 64, 8_192, 8  # table columns alias SHARED pages
MASKED = -(2**30)  # the stage-1 oracles' masked score


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("theta,d", [(1e6, 128), (5e6, 128), (1e4, 256)])
def test_rope_matches_the_reference_at_half_a_million(theta, d):
    """The frequencies equal the reference's bit for bit and RoPE agrees
    to 1e-6 at positions 524,280-524,287; torch's float32 pow (the
    port's earlier formula) is an ulp off in some channels, which moves
    cos / sin there by 3.8e-3 (theta 1e6), 8.6e-4 (5e6) and 1.6e-2 (1e4
    at head_dim 256, recurrentgemma's): past the logits' 1e-4."""
    half = d // 2
    ex = -torch.arange(0, half, dtype=torch.float32) / half
    want = np.asarray(theta ** (-jnp.arange(0, half, dtype=jnp.float32)
                                / half))
    ours = (theta ** ex.double()).float().numpy()
    np.testing.assert_array_equal(ours, want)
    pos = np.arange(FILLED, FILLED + STEPS, dtype=np.int32)
    naive = (pos[:, None].astype(np.float32)
             * (theta ** ex).numpy()[None])
    right = pos[:, None].astype(np.float32) * want[None]
    assert np.abs(np.sin(naive) - np.sin(right)).max() > 5e-4
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, 2, STEPS, d)).astype(np.float32)
    got = t_rope(torch.from_numpy(x), torch.from_numpy(pos[None]), theta)
    ref = j_rope(jnp.asarray(x), jnp.asarray(pos[None]), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_cos_sin_agree_near_half_a_million_rad():
    """At the same float32 arguments (positions 524,280-524,287 times
    mistral-nemo-12b's frequencies, up to 5.2e5 rad) XLA's and PyTorch's
    float32 cos and sin differ by at most one ulp of 1 (5.96e-8)."""
    f = (1e6 ** (-torch.arange(0, 64, dtype=torch.float64) / 64)).float()
    ang = (torch.arange(FILLED, FILLED + STEPS, dtype=torch.float32)[:, None]
           * f[None]).numpy()
    assert ang.max() > 5e5
    for tf, jf in ((torch.cos, jnp.cos), (torch.sin, jnp.sin)):
        gap = np.abs(tf(torch.from_numpy(ang)).numpy()
                     - np.asarray(jf(jnp.asarray(ang))))
        assert gap.max() <= 2.0**-24, gap.max()


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg = j_smoke(ARCH)
    md = j_model_def(jcfg)
    jparams = j_init(md.specs(jcfg), jax.random.PRNGKey(0))
    return jparams, jax.tree.map(np.asarray, jparams)


def _pool_leaves(shape_of, rng):
    """Seeded contents of one backend's pool or cache leaves, stacked over
    the layers as the reference holds them: random packed words, N(0, 1)
    keys and values, a positive k_scale a kv head."""
    out = {}
    for name, shape in shape_of.items():
        if name.startswith("kp") or name == "k_packed":
            out[name] = rng.integers(0, 2**32, shape, dtype=np.uint64
                                     ).astype(np.uint32)
        elif name == "k_scale":
            out[name] = np.abs(rng.standard_normal(
                shape + (256,))).mean(-1).astype(np.float32)
        else:
            out[name] = rng.standard_normal(shape).astype(np.float32)
    return out


def _to_port(leaves, n_layers):
    """Stacked leaves -> copies in the port's one dict a layer (packed
    words as int32)."""
    return [{k: torch.tensor(v[i].view(np.int32) if v.dtype == np.uint32
                             else v[i])
             for k, v in leaves.items()} for i in range(n_layers)]


def _table():
    """(1, 8192): every column but the last on one of pages 1..8 (seeded),
    the last on page 9, the one the decode writes."""
    rng = np.random.default_rng(3)
    table = 1 + rng.integers(0, SHARED, (1, N_COLS)).astype(np.int32)
    table[0, -1] = SHARED + 1
    return table


class _Stage1:
    """Records the stage-1 candidates of every call, in call order, as
    (matrices, rows, candidates) values (float32, NEG_INF masked) and
    int32 indices, with the kernel wrappers' inputs."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, name in ((kops, "bacam_paged_scores_topk"),
                          (kops, "bacam_attention_scores_topk_packed"),
                          (ttopk, "stage1_topk")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name),
                                                      name))

    def _wrap(self, fn, name):
        def rec(*a, **kw):
            v, i = fn(*a, **kw)
            self.calls.append((name, a, kw, v, i))
            return v, i
        return rec

    def take(self):
        """The step's candidates, (matrices, rows over the layers,
        candidates), and its kernel-wrapper calls."""
        calls, self.calls = self.calls, []
        n = calls[0][3].shape[-1]
        m = calls[0][3].shape[0] * (calls[0][3].shape[1]
                                    if calls[0][3].dim() == 4 else 1)
        vals = torch.cat([c[3].reshape(m, -1, n) for c in calls], 1)
        idx = torch.cat([c[4].reshape(m, -1, n).to(torch.int32)
                         for c in calls], 1)
        return (vals, idx), [c for c in calls if c[0] != "stage1_topk"]


def _same_candidates(a, b):
    (av, ai), (bv, bi) = a, b
    assert torch.equal(av, bv)
    assert torch.equal(ai, bi)


_PAGED_ORACLE = jax.jit(jref.bacam_paged_topk_ref, static_argnums=4,
                        static_argnames=("group_size", "stage1_k", "window"))
_CONTIG_ORACLE = jax.jit(jref.bacam_topk_stage1_ref, static_argnums=2,
                         static_argnames=("group_size", "stage1_k", "causal",
                                          "window"))


def _oracle_equal(name, args, kw, v, i):
    """The reference's stage-1 oracle on the packed rows the port passed
    to its kernel wrapper gives the port's candidates."""
    if name == "bacam_paged_scores_topk":
        qp, kp, table, kv_len, q_pos = args
        wv, wi = _PAGED_ORACLE(
            jnp.asarray(_bits(qp)), jnp.asarray(_bits(kp)),
            jnp.asarray(table.numpy()), jnp.asarray(kv_len.numpy()),
            kw["d"], q_pos=jnp.asarray(q_pos.numpy()),
            group_size=kw["group"], stage1_k=kw["stage1_k"],
            window=kw["window"])
    else:
        qp, kp, q_pos, kv_len = args
        wv, wi = _CONTIG_ORACLE(
            jnp.asarray(_bits(qp)), jnp.asarray(_bits(kp)), kw["d"],
            jnp.asarray(q_pos.numpy()), group_size=kw["group"],
            stage1_k=kw["stage1_k"], causal=kw["causal"],
            window=kw["window"], kv_len=jnp.asarray(kv_len.numpy()))
    got_v = np.where(v.numpy() > NEG_INF / 2, v.numpy(), MASKED)
    np.testing.assert_array_equal(got_v.astype(np.int32), np.asarray(wv))
    live = np.asarray(wv) > MASKED // 2
    np.testing.assert_array_equal(i.numpy()[live], np.asarray(wi)[live])


@functools.lru_cache(maxsize=None)
def _paged_reference(backend):
    """The reference's gather route: its pools' contents, the logits of
    every step and its greedy picks (the first token seeded)."""
    jcfg = j_smoke(ARCH, attn_backend=backend, paged_impl="gather")
    md = j_model_def(jcfg)
    jparams, _ = _weights()
    specs = md.page_specs(jcfg, SHARED + 2, PAGE, 1)
    shapes = {k: tuple(t[0].shape) for k, t in specs.items()}
    leaves = _pool_leaves(shapes, np.random.default_rng(5))
    pools = {k: jnp.asarray(v) for k, v in leaves.items()}
    table = jnp.asarray(_table())
    decode = jax.jit(md.decode_paged, static_argnums=6)
    tok = np.array([11], np.int32)
    logits, toks = [], []
    for t in range(STEPS):
        pos = np.array([FILLED + t], np.int32)
        out, pools = decode(jparams, jnp.asarray(tok), jnp.asarray(pos),
                            jnp.asarray(pos + 1), pools, table, jcfg)
        toks.append(tok)
        logits.append(np.asarray(out))
        tok = np.asarray(jnp.argmax(out, -1)).astype(np.int32)
    return leaves, logits, toks


def _port_run(step, rec, n_layers, want, toks, kernel):
    """Run the port's ``step(t)`` for every step against the reference's
    logits; with ``rec`` (camformer) return each step's stage-1
    candidates, checking that ``kernel`` routes call the kernel wrapper
    once a layer (its candidates at the first and the last step equal to
    the reference's oracle) and the others never."""
    cands = []
    for t in range(STEPS):
        got = step(t, torch.from_numpy(toks[t]),
                   torch.tensor([FILLED + t], dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), want[t], rtol=1e-4,
                                   atol=1e-4)
        if rec is None:
            continue
        step_cands, kernel_calls = rec.take()
        assert len(kernel_calls) == (n_layers if kernel else 0)
        if t in (0, STEPS - 1):  # the last group part masked, then whole
            for call in kernel_calls:
                _oracle_equal(*call)
        cands.append(step_cands)
    return cands


@pytest.mark.parametrize("backend", ["camformer", "dense"])
def test_paged_decode_at_half_a_million(monkeypatch, backend):
    """The paged realizations (``fused``: the kernel wrappers; ``gather``:
    the pages gathered in logical order) against the reference's gather
    route; on camformer their stage-1 candidates are identical."""
    rec = _Stage1(monkeypatch) if backend == "camformer" else None
    leaves, want, toks = _paged_reference(backend)
    table = torch.from_numpy(_table())
    runs = {}
    for impl in (("fused", "gather") if rec else ("gather",)):
        tcfg = t_smoke(ARCH, attn_backend=backend, paged_impl=impl)
        tparams = from_jax_params(_weights()[1], tcfg, device="cpu")
        pools = init_pools(lm_page_specs(tcfg, SHARED + 2, PAGE, 1), "cpu")
        for layer, filled in zip(pools, _to_port(leaves, tcfg.n_layers)):
            for k, v in filled.items():
                layer[k].copy_(v)

        def step(t, tok, pos):
            return lm_decode_paged(tparams, tok, pos, pos + 1, pools, table,
                                   tcfg)[0]

        runs[impl] = _port_run(step, rec, tcfg.n_layers, want, toks,
                               impl == "fused")
    if rec:
        assert len(runs["fused"]) == STEPS
        for fused, gather in zip(runs["fused"], runs["gather"]):
            _same_candidates(fused, gather)


# each contiguous route's candidates a step, compared once both ran
_CONTIG = {}


@functools.lru_cache(maxsize=None)
def _contiguous_reference():
    """As ``_paged_reference``, camformer's contiguous decode step over a
    524,288-position cache."""
    jcfg = j_smoke(ARCH, attn_backend="camformer")
    md = j_model_def(jcfg)
    jparams, _ = _weights()
    specs = md.cache_specs(jcfg, 1, FILLED + STEPS)
    shapes = {k: tuple(t[0].shape) for k, t in specs.items()}
    leaves = _pool_leaves(shapes, np.random.default_rng(9))
    caches = {k: jnp.asarray(v) for k, v in leaves.items()}
    decode = jax.jit(md.decode, static_argnums=5)
    tok = np.array([23], np.int32)
    logits, toks = [], []
    for t in range(STEPS):
        pos = np.array([FILLED + t], np.int32)
        out, caches = decode(jparams, jnp.asarray(tok), jnp.asarray(pos),
                             jnp.asarray(pos + 1), caches, jcfg)
        toks.append(tok)
        logits.append(np.asarray(out))
        tok = np.asarray(jnp.argmax(out, -1)).astype(np.int32)
    return leaves, logits, toks


@pytest.mark.parametrize("use_kernel", [True, False])
def test_contiguous_serve_step_at_half_a_million(monkeypatch, use_kernel):
    """camformer's ``make_serve_step`` with and without ``use_kernel``
    against the reference's decode step (the kernel wrapper's candidates
    equal to the reference's oracle, the plain route's to the kernel
    route's); the caches are written in place (the tensors given are the
    tensors returned, holding the new rows)."""
    leaves, want, toks = _contiguous_reference()
    rec = _Stage1(monkeypatch)
    tcfg = t_smoke(ARCH, attn_backend="camformer", use_kernel=use_kernel)
    tparams = from_jax_params(_weights()[1], tcfg, device="cpu")
    caches = _to_port(leaves, tcfg.n_layers)
    held = [c["v"] for c in caches]
    serve = make_serve_step(get_model_def(tcfg), tcfg)

    def step(t, tok, pos):
        logits, out = serve(tparams, tok, pos, pos + 1, caches)
        assert all(c["v"] is h for c, h in zip(out, held))
        return logits

    _CONTIG[use_kernel] = _port_run(step, rec, tcfg.n_layers, want, toks,
                                    use_kernel)
    assert not torch.equal(held[0][0, 0, FILLED],
                           torch.from_numpy(leaves["v"][0, 0, 0, FILLED]))
    if len(_CONTIG) == 2:
        for kernel, plain in zip(_CONTIG[True], _CONTIG[False]):
            _same_candidates(kernel, plain)
