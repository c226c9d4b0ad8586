"""The port's ``ServeEngine`` on the ``binary`` and ``hybrid`` backends
and at temperature, against the JAX engine on the same weights (f32
smoke configs, CPU): token streams identical, the same ticks, readbacks
and preemptions.

  * greedy on ``binary``, ``hybrid`` and a ``dense,binary`` stack;
  * temperature 0.9 (rows mixing greedy, top-k and top-p policies) in
    sync mode, in overlap mode (sampling is keyed by (seed, rid, index),
    so the modes agree), and under preemption and resume."""

import pytest

from torch_engine_runs import jax_run, tokens, torch_run

CASES = [
    # (arch, backend, temperature, mode, n_pages)
    ("camformer-bert", "binary", 0.0, "sync", None),
    ("camformer-bert", "hybrid", 0.0, "overlap", None),
    ("mistral-nemo-12b", "dense,binary", 0.0, "overlap", None),
    ("mistral-nemo-12b", "hybrid", 0.0, "sync", None),
    ("camformer-bert", "dense", 0.9, "sync", None),
    ("camformer-bert", "dense", 0.9, "overlap", None),
    ("camformer-bert", "camformer", 0.9, "overlap", None),
    ("camformer-bert", "binary", 0.9, "overlap", None),
    # a pool of 7 usable pages: preemption, and resume regenerating the
    # same keyed draws
    ("camformer-bert", "camformer", 0.9, "overlap", 8),
    ("mistral-nemo-12b", "dense", 0.9, "sync", 8),
]


@pytest.mark.parametrize("arch,backend,temperature,mode,n_pages", CASES)
def test_engine_streams_equal_reference(arch, backend, temperature, mode,
                                        n_pages):
    params_np, jreqs, jc = jax_run(arch, backend, temperature,
                                   n_pages=n_pages)
    eng, treqs = torch_run(arch, backend, params_np, mode, temperature,
                           n_pages=n_pages)
    assert tokens(treqs) == tokens(jreqs)
    assert [r.prefix_matched for r in treqs] == \
        [r.prefix_matched for r in jreqs]
    assert eng.ticks == jc["ticks"]
    assert eng.readbacks == jc["readbacks"]
    assert eng.preemptions == jc["preemptions"]
    if n_pages is not None:
        assert jc["preemptions"] > 0
    if temperature > 0:  # the hot rows really sampled: not the argmax run
        _, greedy_reqs, _ = jax_run(arch, backend, 0.0, n_pages=n_pages)
        assert tokens(treqs) != tokens(greedy_reqs)
