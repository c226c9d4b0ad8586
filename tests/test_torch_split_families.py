"""Share mode of the ``model`` split (``partitioning.run_shares``: every
rank's share of the split code in turn in one process, the collectives
exchanged in process) at smoke width, f32, for the regions this slice
splits, against the same function run whole:

  * whisper-medium's self-attention, cross-attention (the memory
    projected with each rank's ``wk``/``wv`` columns) and a whole
    decoder layer;
  * recurrentgemma-2b's RG-LRU block (rnn channels, the gate products
    reduce-scattered over them);
  * rwkv6-3b's time mix (4 heads of 16; and the default single head of
    64, where the plan keeps the time mix whole) and channel mix;
  * camformer-bert's decoder-only block under ``res_seq`` (each rank
    holding S / m rows of the residual stream).

For m in {2, 4}, the same numpy-seeded inputs: the shares' output within
1e-5 of max |out| of the whole function's, and, after one backward pass
with a seeded cotangent, every parameter's and input's gradient within
1e-4 (a ``"split"`` leaf's blocks land in the whole leaf, a
``"partial"`` leaf's parts are summed there by autograd).  The unsplit
functions are held against the JAX package in ``test_torch_encdec.py``,
``test_torch_rglru.py``, ``test_torch_rwkv6.py`` and
``test_torch_model.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch.steps import model_shares, model_split_plan, \
    share_params
from repro_torch.models import encdec, get_model_def, init_params, rglru, \
    rwkv6
from repro_torch.models import transformer as T
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.sharding import partitioning as P

B, S = 2, 16


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _whisper(kind):
    cfg = smoke_config("whisper-medium")
    pos = T.arange_positions(B, S, "cpu")

    def self_attn(p, x):
        return encdec.attention_block(p, x, cfg, positions=pos)[0]

    def cross_attn(p, x, mem):
        return encdec.attention_block(
            p, x, cfg, positions=pos,
            cross_kv=encdec._cross_kv(p, mem, cfg))[0]

    def dec_layer(p, x, mem):
        return encdec._dec_block(p, x, cfg, mem, None, pos, None, None)[0]

    fn, sub = {"self_attn": (self_attn, ("dec_blocks", 0, "self_attn")),
               "cross_attn": (cross_attn, ("dec_blocks", 0, "cross_attn")),
               "dec_layer": (dec_layer, ("dec_blocks", 0))}[kind]
    return cfg, fn, sub, lambda rng: [_randn(rng, B, S, cfg.d_model)] + (
        [] if kind == "self_attn" else [_randn(rng, B, cfg.enc_len,
                                               cfg.d_model)])


def _rglru():
    cfg = smoke_config("recurrentgemma-2b")

    def rec(p, x):
        zero = {n: torch.zeros(shape, dtype=dt) for n, (shape, dt) in
                rglru._rec_state_spec(cfg, B).items()}
        return rglru._apply_rec(p, x, cfg, zero)[0]

    return cfg, rec, ("rec1", 0), lambda rng: [_randn(rng, B, S,
                                                      cfg.d_model)]


def _rwkv(kind, head_dim):
    cfg = smoke_config("rwkv6-3b", rwkv_head_dim=head_dim)
    h = cfg.d_model // head_dim

    def time_mix(p, x):
        return rwkv6._time_mix(p, x, cfg, torch.zeros(B, cfg.d_model),
                               torch.zeros(B, h, head_dim, head_dim))[0]

    def channel_mix(p, x):
        return rwkv6._channel_mix(p, x, cfg, torch.zeros(B, cfg.d_model))[0]

    fn = time_mix if kind == "tm" else channel_mix
    return cfg, fn, ("blocks", 0, kind), lambda rng: [_randn(
        rng, B, S, cfg.d_model)]


def _decoder_block():
    cfg = smoke_config("camformer-bert", attn_backend="camformer")
    pos = T.arange_positions(B, S, "cpu")

    def block(p, x):
        seq = P.split_rank() is not None  # a share: its rows of the stream
        if seq:
            x = P.local_seq(x)
        y = T._apply_block(p, x, cfg, positions=pos, cache=None,
                           cache_index=None, kv_len=None, page_table=None,
                           scale_base=None, backend=None, seq=seq)[0]
        return P.whole_seq(y) if seq else y

    return cfg, block, ("blocks", 0), lambda rng: [_randn(rng, B, S,
                                                          cfg.d_model)]


CASES = {
    "whisper_self_attention": lambda: _whisper("self_attn"),
    "whisper_cross_attention": lambda: _whisper("cross_attn"),
    "whisper_decoder_layer": lambda: _whisper("dec_layer"),
    "rglru_block": _rglru,
    "rwkv_time_mix_4_heads": lambda: _rwkv("tm", 16),
    "rwkv_time_mix_1_head_whole": lambda: _rwkv("tm", 64),
    "rwkv_channel_mix": lambda: _rwkv("cm", 64),
    "decoder_block_res_seq": _decoder_block,
}

# what each share ran on at m = 2 and m = 4 (``SPLIT_SEEN``)
SEEN = {
    "whisper_self_attention": lambda m: dict(attn_q_heads=4 // m,
                                             attn_kv_heads=4 // m),
    "whisper_cross_attention": lambda m: dict(attn_q_heads=4 // m,
                                              attn_kv_heads=4 // m),
    "whisper_decoder_layer": lambda m: dict(attn_q_heads=4 // m,
                                            attn_kv_heads=4 // m,
                                            mlp_cols=96 // m),
    "rglru_block": lambda m: dict(rnn=64 // m, mlp_cols=96 // m),
    "rwkv_time_mix_4_heads": lambda m: dict(tm_heads=4 // m),
    "rwkv_time_mix_1_head_whole": lambda m: dict(tm_whole_heads=1),
    "rwkv_channel_mix": lambda m: dict(cm_cols=96 // m),
    "decoder_block_res_seq": lambda m: dict(attn_q_heads=4 // m,
                                            attn_kv_heads=4 // m,
                                            mlp_cols=96 // m),
}


def _pick(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _run(fn, params, inputs, cot_seed, shares=None):
    """(output, parameter gradients, input gradients) of ``fn`` whole or,
    with ``shares`` = (dims, m), as m shares in turn."""
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    xs = [x.clone().requires_grad_() for x in inputs]
    if shares is None:
        out = fn(params, *xs)
    else:
        dims, m = shares
        outs = P.run_shares(
            lambda r: fn(share_params(params, dims, r, m), *xs), m)
        out = outs[0]
        for o in outs[1:]:  # every rank ends with the same output
            assert torch.equal(o, out)
    cot = _randn(np.random.default_rng(cot_seed), *out.shape)
    (out * cot).sum().backward()
    return (out.detach(), [t.grad for t in tree_leaves(params)],
            [x.grad for x in xs])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_shares_sum_to_the_unsplit_function(case, m):
    cfg, fn, path, make_inputs = CASES[case]()
    params = _pick(init_params(cfg, device="cpu", seed=0), path)
    inputs = make_inputs(np.random.default_rng(1))
    _, dims = model_shares(get_model_def(cfg), cfg, m)
    whole = _run(fn, params, inputs, 2)
    P.SPLIT_SEEN.clear()
    got = _run(fn, params, inputs, 2, shares=(_pick(dims, path), m))
    assert dict(P.SPLIT_SEEN) == SEEN[case](m)
    err = float((got[0] - whole[0]).abs().max())
    assert err <= 1e-5 * float(whole[0].abs().max()), err
    for g, w in zip(got[1] + got[2], whole[1] + whole[2]):
        assert g is not None and w is not None
        assert float((g - w).abs().max()) <= 1e-4 * max(
            1.0, float(w.abs().max())), case


def _leaf_hows(plan, path):
    return dict(_pick(plan, path))


def test_plan_of_each_family():
    """The plan at m = 2: which leaves stay split (their blocks), which
    are summed over ``model`` (whole, used only in a split region), and
    the fallbacks (rwkv6's single smoke head, recurrentgemma-2b's 10 q
    heads on a ``model`` of 4)."""
    split, part = "split", "partial"
    cases = [
        ("whisper-medium", {}, ("dec_blocks", 0, "cross_attn"),
         dict(wq=split, wk=split, wv=split, wo=split)),
        ("whisper-medium", {}, ("enc_blocks", 0, "mlp"),
         dict(w_in=split, b_in=part, w_out=split, b_out="whole")),
        ("recurrentgemma-2b", {}, ("rec2", 0),
         dict(ln={"scale": "whole"}, w_gate=split, w_x=split, conv_w=split,
              conv_b=part, w_rg=split, b_rg=part, w_ig=split, b_ig=part,
              lam=part, w_out=split, ln_mlp={"scale": "whole"},
              mlp=dict(w_gate=split, w_up=split, w_down=split))),
        ("recurrentgemma-2b", {}, ("attn", 0, "attn"),
         dict(wq=split, wk=part, wv=part, wo=split)),
        ("rwkv6-3b", dict(rwkv_head_dim=16), ("blocks", 0, "tm"),
         dict(mu=part, w0=part, w_lora_a=part, w_lora_b=part, u=split,
              wr=split, wk=split, wv=split, wg=split, wo=split, ln_x=part)),
        ("rwkv6-3b", {}, ("blocks", 0, "tm"),
         {k: "whole" for k in ("mu", "w0", "w_lora_a", "w_lora_b", "u",
                               "wr", "wk", "wv", "wg", "wo", "ln_x")}),
        ("rwkv6-3b", {}, ("blocks", 0, "cm"),
         dict(mu="whole", wk=split, wv=split, wr="whole")),
    ]
    for arch, over, path, want in cases:
        cfg = smoke_config(arch, **over)
        plan, _ = model_shares(get_model_def(cfg), cfg, 2)
        assert _leaf_hows(plan, path) == want, (arch, path)
    # recurrentgemma-2b at full width on a model axis of 4: 10 q heads on
    # 1 kv head take kv_seq, attention whole; the rnn channels split
    cfg = smoke_config("recurrentgemma-2b", n_heads=10, n_kv_heads=1)
    plan, _ = model_shares(get_model_def(cfg), cfg, 4)
    assert set(_leaf_hows(plan, ("attn", 0, "attn")).values()) == {"whole"}
    assert plan["rec1"][0]["w_x"] == split


def test_res_seq_plan_sums_the_norms():
    """Under ``res_seq`` the decoder-only block's norms, ``ln_f`` and the
    plain MLP's ``b_out`` run on each process's rows: their gradients
    are summed over ``model``; without it they stay whole."""
    cfg = smoke_config("camformer-bert", act="gelu", norm="layer")
    on = tree_map(lambda _: False, init_params(cfg, device="cpu"))
    for seq, how in ((True, "partial"), (False, "whole")):
        plan = model_split_plan(cfg, on, 2, seq)
        assert plan["blocks"][0]["ln1"] == {"scale": how, "bias": how}
        assert plan["ln_f"]["scale"] == how
        assert plan["blocks"][0]["ffn"]["b_out"] == how


def test_share_mode_raises_a_rank_error_and_mismatched_collectives():
    """A share that raises stops the others and the error reaches the
    caller; shares that run different collectives are refused."""
    def failing(rank):
        if rank == 1:
            raise ValueError("rank 1")
        return P.exit_split(torch.ones(2))

    with pytest.raises(ValueError, match="rank 1"):
        P.run_shares(failing, 2)

    def uneven(rank):
        x = P.exit_split(torch.ones(2))
        return P.exit_split(x) if rank == 0 else x

    with pytest.raises(RuntimeError, match="different"):
        P.run_shares(uneven, 2)
    outs = P.run_shares(lambda r: P.exit_split(torch.full((2,), r + 1.0)), 3)
    assert all(torch.equal(o, torch.full((2,), 6.0)) for o in outs)
