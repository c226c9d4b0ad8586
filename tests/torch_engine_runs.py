"""Shared engine runs of the port's stream tests: the same requests,
on the same weights, through the reference ``ServeEngine`` and the
port's, at the f32 smoke widths (3 slots, 48-token slots, 8-token
pages; 4 slots for an MoE config).  Not a test module: the
``test_torch_*`` files import it."""

import jax
import numpy as np

from repro.configs import smoke_config as j_smoke
from repro.models import get_model_def
from repro.models.module import init_params as j_init
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSampling
from repro.serving import ServeEngine as JEngine

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import from_jax_params
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SamplingParams as TSampling
from repro_torch.serving import ServeEngine as TEngine

ENGINE_KW = dict(max_batch=3, max_len=48, page_size=8)


def engine_kw(cfg):
    """ENGINE_KW, with 4 slots for an MoE config: the reference's MoE
    dispatch asserts that a prefill batch's B*S tokens fill whole
    64-token groups, which 3 slots of a 32-token bucket do not (96)."""
    return dict(ENGINE_KW, max_batch=4) if cfg.n_experts else ENGINE_KW


def backend_kw(backend):
    if "," in backend:
        return {"layer_backends": tuple(backend.split(","))}
    return {"attn_backend": backend}


def requests(req_cls, sp_cls, vocab, temperature, late):
    """Four requests sharing a 12-token prefix.  At temperature > 0 the
    rows mix policies: request 1 is greedy, the others sample with their
    own top-k / top-p.  With ``late`` the last one has priority 1 (it
    preempts under a small pool)."""
    rng = np.random.default_rng(1)
    shared = [int(t) for t in rng.integers(0, vocab, 12)]
    policies = ((0, 1.0), (0, 1.0), (40, 0.95), (5, 0.9))
    out = []
    for i, (n, m) in enumerate(((3, 6), (9, 4), (1, 7), (5, 5))):
        prompt = shared + [int(t) for t in rng.integers(0, vocab, n)]
        temp = 0.0 if i == 1 else temperature
        sp = sp_cls(max_new=m, temperature=temp, top_k=policies[i][0],
                    top_p=policies[i][1])
        out.append(req_cls(prompt=prompt, sampling=sp, rid=i,
                           priority=int(bool(late) and i == 3)))
    return out


def drive(eng, reqs, late):
    """Submit the first three requests, run ``late`` engine polls, submit
    the fourth, drain."""
    for r in reqs[:3]:
        eng.submit(r)
    for _ in range(late):
        eng.poll()
    eng.submit(reqs[3])
    return eng.run()


_JAX_RUNS = {}


def jax_run(arch, backend, temperature=0.0, spec_k=0, n_pages=None,
            mode="sync", **overrides):
    """The reference engine's run (sync mode unless asked), once per
    configuration: (params as numpy, requests, counters).  ``overrides``
    are config fields on top of the smoke config."""
    late = 3 if n_pages else 0
    key = (arch, backend, temperature, spec_k, n_pages, mode,
           tuple(sorted(overrides.items())))
    if key not in _JAX_RUNS:
        cfg = j_smoke(arch, **backend_kw(backend), **overrides)
        md = get_model_def(cfg)
        params = j_init(md.specs(cfg), jax.random.PRNGKey(0))
        eng = JEngine(md, cfg, params, mode=mode, n_pages=n_pages,
                      spec_k=spec_k or None, **engine_kw(cfg))
        reqs = requests(JRequest, JSampling, cfg.vocab, temperature, late)
        drive(eng, reqs, late)
        counters = dict(ticks=eng.ticks, readbacks=eng.readbacks,
                        preemptions=eng.preemptions,
                        spec_proposed=eng.spec_proposed,
                        spec_accepted=eng.spec_accepted)
        _JAX_RUNS[key] = (jax.tree.map(np.asarray, params), reqs, counters)
    return _JAX_RUNS[key]


def torch_run(arch, backend, params_np, mode, temperature=0.0, spec_k=0,
              n_pages=None, **overrides):
    """The port's engine on the CPU over the reference's weights:
    (engine, requests) after draining."""
    late = 3 if n_pages else 0
    cfg = t_smoke(arch, **backend_kw(backend), **overrides)
    eng = TEngine(cfg, from_jax_params(params_np, cfg, device="cpu"),
                  mode=mode, n_pages=n_pages, spec_k=spec_k or None,
                  device="cpu", **engine_kw(cfg))
    reqs = requests(TRequest, TSampling, cfg.vocab, temperature, late)
    done = drive(eng, reqs, late)
    assert len(done) == len(reqs)
    assert eng.tick_errors == 0, eng.last_error
    assert [r.finish_reason for r in reqs] == ["length"] * len(reqs)
    return eng, reqs


def tokens(reqs):
    return [list(r.tokens) for r in reqs]
