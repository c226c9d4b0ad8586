"""Self-speculative decoding in the port's ``ServeEngine``, against the
JAX engine on the same weights (f32 smoke configs, CPU).

``spec_k=2`` with the default ``binary`` drafter, on ``dense`` and
``camformer`` targets, greedy and at temperature 0.9: token streams
identical to the reference's, with the same ticks, readbacks and spec
counters; and identical to the port's own plain-decode streams (the
exactness contract of serving/speculate.py), in sync and overlap mode,
with one readback per tick."""

import pytest

from torch_engine_runs import jax_run, tokens, torch_run

ARCH = "camformer-bert"


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("backend", ["dense", "camformer"])
def test_spec_streams_equal_reference(backend, temperature):
    params_np, jreqs, jc = jax_run(ARCH, backend, temperature, spec_k=2)
    eng, treqs = torch_run(ARCH, backend, params_np, "sync", temperature,
                           spec_k=2)
    assert tokens(treqs) == tokens(jreqs)
    for name in ("ticks", "readbacks", "spec_proposed", "spec_accepted"):
        assert getattr(eng, name) == jc[name], name
    assert 0 < eng.spec_accepted <= eng.spec_proposed
    assert eng.spec_acceptance == eng.spec_accepted / eng.spec_proposed


@pytest.mark.parametrize("mode", ["sync", "overlap"])
@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("backend", ["dense", "camformer", "hybrid"])
def test_spec_streams_equal_plain_decode(backend, temperature, mode):
    params_np, _, _ = jax_run(ARCH, backend, temperature, spec_k=2)
    _, plain = torch_run(ARCH, backend, params_np, mode, temperature)
    eng, spec = torch_run(ARCH, backend, params_np, mode, temperature,
                          spec_k=2)
    assert tokens(spec) == tokens(plain)
    # one readback per tick: each decode tick reads one (B, m + 1) pack,
    # each prefill-completing tick its first tokens
    assert eng.readbacks == eng.ticks + eng.prefill_ticks
    assert eng.spec_proposed > 0


def test_spec_under_preemption_equals_plain_decode():
    """A small pool: speculative ticks roll back through preemption and
    resume, and still give the plain-decode streams."""
    params_np, _, _ = jax_run(ARCH, "camformer", 0.9, spec_k=2)
    _, plain = torch_run(ARCH, "camformer", params_np, "overlap", 0.9,
                         n_pages=8)
    eng, spec = torch_run(ARCH, "camformer", params_np, "overlap", 0.9,
                          spec_k=2, n_pages=8)
    assert eng.preemptions > 0
    assert tokens(spec) == tokens(plain)
