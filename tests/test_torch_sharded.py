"""The port's tensor-parallel serving pieces, in one process (no spawn):

  * ``pool_partition_specs`` gives the reference's spec entries, leaf for
    leaf (the reference's uniform stacks carry a leading ``layers``
    entry the port's per-layer pools do not), for every backend with and
    without the speculative ``k_means`` leaf and for a mixed stack, and
    the reference's error for a head axis that does not divide;
  * the engine validates ``tp`` as the reference's does;
  * each rank's share of a head-sharded paged attention
    (``tp_local_decode`` on ``slice_pools``' slice), run in turn in this
    process and concatenated in rank order, is the tp = 1 output bit for
    bit, and each rank's written pool slice is the tp = 1 pool's head
    slice bit for bit, for the four backends on a prefill chunk and on
    decode rows, and for a GQA config.  The multi-process engine is held
    in tests/test_torch_tp.py.
"""

import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models.transformer import lm_page_specs as j_page_specs
from repro.serving import sharded as j_sharded

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.core.backend import get_backend
from repro_torch.models.attention import attention_block
from repro_torch.models.transformer import init_pools, lm_page_specs
from repro_torch.serving import ServeEngine
from repro_torch.serving import sharded


def _specs(pkg_specs, cfg):
    return pkg_specs(cfg, n_pages=9, page_size=8, max_batch=2)


@pytest.mark.parametrize("backend", ["dense", "binary", "camformer",
                                     "hybrid"])
@pytest.mark.parametrize("spec_k", [0, 4])
def test_pool_partition_specs_match_reference(backend, spec_k):
    over = dict(attn_backend=backend, spec_k=spec_k)
    want = j_sharded.pool_partition_specs(
        _specs(j_page_specs, j_smoke("codeqwen1.5-7b").replace(**over)), 2)
    got = sharded.pool_partition_specs(
        _specs(lm_page_specs, t_smoke("codeqwen1.5-7b").replace(**over)), 2)
    assert len(got) == 2  # one spec dict a layer
    for layer in got:
        assert set(layer) == set(want)
        for name, spec in layer.items():
            assert spec == tuple(want[name])[1:], (name, spec, want[name])
            assert sharded.TP_AXIS in spec


def test_pool_partition_specs_mixed_stack_match_reference():
    over = dict(layer_backends=("dense", "camformer"))
    want = j_sharded.pool_partition_specs(
        _specs(j_page_specs, j_smoke("codeqwen1.5-7b").replace(**over)), 2)
    got = sharded.pool_partition_specs(
        _specs(lm_page_specs, t_smoke("codeqwen1.5-7b").replace(**over)), 2)
    assert isinstance(want, tuple) and len(got) == len(want)
    for w, g in zip(want, got):
        assert {k: tuple(v) for k, v in w.items()} == g


@pytest.mark.parametrize("stack", [dict(attn_backend="camformer"),
                                   dict(layer_backends=("dense",
                                                        "camformer"))])
def test_indivisible_head_axis_raises_the_reference_error(stack):
    """Smoke configs have 4 kv heads: tp = 3 does not divide them."""
    cfg_j = j_smoke("codeqwen1.5-7b").replace(**stack)
    cfg_t = t_smoke("codeqwen1.5-7b").replace(**stack)
    pattern = r"kv-head axis.*divide.*tp=3"
    with pytest.raises(ValueError, match=pattern) as want:
        j_sharded.pool_partition_specs(_specs(j_page_specs, cfg_j), 3)
    with pytest.raises(ValueError, match=pattern) as got:
        sharded.pool_partition_specs(_specs(lm_page_specs, cfg_t), 3)
    # the same leaf named the same way
    assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
    with pytest.raises(ValueError, match="tp"):
        sharded.pool_partition_specs(_specs(lm_page_specs, cfg_t), 0)


def test_engine_tp_validation_and_tp1_code_path():
    """As the reference's test of the same name: tp = 1 has no mesh and
    no pool spec tree; tp = 0 raises naming tp; tp = 2 without a group of
    two processes raises naming the devices."""
    from repro_torch.models import init_params

    cfg = t_smoke("codeqwen1.5-7b")
    params = init_params(cfg, device="cpu")
    kw = dict(max_batch=2, max_len=32, page_size=8, device="cpu")
    eng = ServeEngine(cfg, params, tp=1, **kw)
    assert eng.tp == 1 and eng.mesh is None
    assert eng._pool_pspecs is None and eng._sync is None
    with pytest.raises(ValueError, match="devices"):
        ServeEngine(cfg, params, tp=2, **kw)
    with pytest.raises(ValueError, match="tp"):
        ServeEngine(cfg, params, tp=0, **kw)


def test_local_pools_hold_one_tp_th_of_the_bytes():
    cfg = t_smoke("codeqwen1.5-7b").replace(attn_backend="hybrid", spec_k=4)
    specs = _specs(lm_page_specs, cfg)
    whole = sharded.pool_bytes(init_pools(specs, "cpu"))
    for tp in (1, 2, 4):
        local = sharded.init_local_pools(specs, tp, "cpu")
        assert sharded.pool_bytes(local) * tp == whole
        assert local[0]["kp_pages"].shape[1] == 4 // tp
    assert sharded.head_range(1, 2, t_smoke(
        "codeqwen1.5-7b", n_kv_heads=2)) == (slice(1, 2), slice(2, 4))


# ---------------------------------------------------------------------------
# each rank's share of a head-sharded paged attention, in one process

CASES = {  # name: (arch, overrides)
    "dense": ("camformer-bert", dict(attn_backend="dense")),
    "binary": ("camformer-bert", dict(attn_backend="binary")),
    "camformer": ("camformer-bert", dict(attn_backend="camformer")),
    "hybrid": ("camformer-bert", dict(attn_backend="hybrid")),
    "gqa_camformer": ("codeqwen1.5-7b", dict(n_kv_heads=2,
                                             attn_backend="camformer")),
    "gqa_dense": ("codeqwen1.5-7b", dict(n_kv_heads=2,
                                         attn_backend="dense")),
}


def _draw(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _shares(bk, cfg, pools, q, k, v, positions, table, kv_len, base, tp):
    """The tp = 1 output and pools, and each rank's (output, pool slice),
    every run from a copy of ``pools``."""
    copy = lambda tree: [{n: t.clone() for n, t in layer.items()}
                         for layer in tree]
    whole = copy(pools)
    out, whole[0] = bk.paged_decode(q, whole[0], k, v, positions, table,
                                    kv_len, cfg, base=base)
    shares = []
    from repro_torch.models.attention import tp_local_decode

    for r in range(tp):
        mine = sharded.slice_pools(pools, r, tp)
        o, mine[0] = tp_local_decode(bk, q, mine[0], k, v, positions, table,
                                     kv_len, cfg, base, r, tp)
        shares.append((o, mine))
    return (out, whole), shares


@pytest.mark.parametrize("name", list(CASES))
def test_rank_shares_equal_tp1_bit_for_bit(name):
    """A 12-token prefill chunk (one slot idle, the other at offset 4 past
    a shared prefix) and then two decode rows, at every tp that divides
    the kv heads: the rank-order concatenation of the shares' outputs,
    and each share's pool slice, equal the whole pool's bit for bit."""
    arch, over = CASES[name]
    cfg = t_smoke(arch, **over)
    bk = get_backend(cfg.backend)
    b, s, page = 2, 12, 8
    hkv, h, d = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
    pools = init_pools(lm_page_specs(cfg, 9, page, b), "cpu")[:1]
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    rng = np.random.default_rng(7)
    # the chunk: row 0 writes positions 4..15, row 1 is idle (kv_len 0)
    offsets = torch.tensor([4, 0], dtype=torch.int32)
    positions = offsets[:, None] + torch.arange(s, dtype=torch.int32)
    kv_len = torch.tensor([16, 0], dtype=torch.int32)
    base = torch.tensor([4, 0], dtype=torch.int32)
    chunk = (_draw(rng, b, h, s, d), _draw(rng, b, hkv, s, d),
             _draw(rng, b, hkv, s, d))
    tps = [t for t in (1, 2, 4) if hkv % t == 0]
    for tp in tps:
        (out, whole), shares = _shares(bk, cfg, pools, *chunk, positions,
                                       table, kv_len, base, tp)
        _check(out, whole, shares, tp)
    pools = whole  # the chunk written; now one decode row a slot
    positions = torch.tensor([[16], [0]], dtype=torch.int32)
    kv_len = torch.tensor([17, 1], dtype=torch.int32)
    row = (_draw(rng, b, h, 1, d), _draw(rng, b, hkv, 1, d),
           _draw(rng, b, hkv, 1, d))
    for tp in tps:
        (out, whole), shares = _shares(bk, cfg, pools, *row, positions,
                                       table, kv_len, base, tp)
        _check(out, whole, shares, tp)


def _check(out, whole, shares, tp):
    got = torch.cat([o for o, _ in shares], dim=1)
    assert torch.equal(got, out)
    for r, (_, mine) in enumerate(shares):
        want = sharded.slice_pools(whole, r, tp)
        for n in want[0]:  # but the trash page 0: padding rows land there
            a, b = mine[0][n], want[0][n]
            if n.endswith("_pages"):
                a, b = a[1:], b[1:]
            assert torch.equal(a, b), (r, n)
        assert sharded.pool_bytes(mine) * tp == sharded.pool_bytes(whole)


def test_a_pool_slice_outside_a_tp_step_raises():
    cfg = t_smoke("camformer-bert", attn_backend="dense")
    from repro_torch.models import init_params

    p = init_params(cfg, device="cpu")["blocks"][0]["attn"]
    pools = sharded.slice_pools(init_pools(
        lm_page_specs(cfg, 5, 8, 1), "cpu"), 0, 2)
    x = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="tensor-parallel"):
        attention_block(p, x, cfg, positions=torch.zeros((1, 1),
                                                         dtype=torch.int32),
                        cache=pools[0], kv_len=torch.ones(1,
                                                          dtype=torch.int32),
                        page_table=torch.ones((1, 1), dtype=torch.int32))


@pytest.mark.parametrize("launcher", ["serve", "gateway"])
def test_launchers_at_tp2_need_a_group_of_two(launcher):
    """``--tp 2`` outside ``torchrun`` (no process group) raises the
    engine's named error; ``--tp 1`` runs as before
    (tests/test_torch_isolation.py)."""
    import importlib

    main = importlib.import_module(f"repro_torch.launch.{launcher}").main
    with pytest.raises(ValueError, match="devices"):
        main(["--arch", "camformer-bert", "--smoke", "--device", "cpu",
              "--tp", "2"] + (["--port", "0"] if launcher == "gateway"
                              else []))
