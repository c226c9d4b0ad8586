"""CAMformer attention (Eq. 1 of the paper), contiguous and paged.

    CAMformer-Attn(Q, K, V) = SoftMax(Top-32(QK^T)) . V

with QK^T computed on binarized operands (BA-CAM scores) and Top-32 the
two-stage hierarchical top-k.  Selection is on the RAW binary score; the
HAD scales enter only as a softmax temperature over the survivors.

``attention`` is the operator over freshly computed (or contiguous
cached) K/V in three modes: ``dense`` (softmax attention, the oracle),
``binary`` (HAD-binarized scores, full softmax) and ``camformer``
(binary scores, two-stage top-k, softmax over the survivors, sparse V
gather).  With ``AttentionSpec.use_kernel`` the binary scores come from
the BA-CAM CUDA kernel (kernels/bacam_mvm.py) on a CUDA tensor.
``binary_paged_attention`` and ``camformer_paged_attention`` are the
serving paths over paged pools.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import bacam
from repro_torch.core.binarize import binarize_qk, had_scales, sign_pm1
from repro_torch.core.topk import NEG_INF, stable_topk, two_stage_topk
from repro_torch.utils import spans

__all__ = ["AttentionSpec", "attention", "binary_paged_attention",
           "camformer_paged_attention", "seq_split_attention",
           "dense_attention", "dense_reference", "make_mask",
           "topk_softmax_weights"]

# Bound on the XOR temporary of the gather branch, in int32 words: long
# prompt chunks are scored a slice of rows at a time.
_GATHER_WORDS = 1 << 25


@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    """Configuration of the attention operator."""

    mode: str = "dense"  # dense | binary | camformer
    k_top: int = 32
    group_size: int = 16  # CAM_H
    stage1_k: int = 2
    # device-fidelity knobs (the fidelity benchmarks; None/0.0 is the
    # exact integer path): core/bacam's device model, ADC and matchline
    # noise per cam_w-bit tile, noise keyed by attention's ``rng``
    adc_bits: int | None = None
    noise_sigma: float = 0.0
    cam_w: int = bacam.CAM_W
    # straight-through training binarization (core/binarize.sign_ste)
    trainable_binarize: bool = False
    # route binary scoring through the BA-CAM CUDA kernel
    use_kernel: bool = False

    def replace(self, **kw) -> "AttentionSpec":
        return dataclasses.replace(self, **kw)


def topk_softmax_weights(top_v, temp, scale):
    """Softmax over top-k survivors (the hardware's LUT stage).

    top_v: (..., k) raw binary scores with NEG_INF at masked entries;
    temp broadcastable to top_v; scale: 1/sqrt(d).  Returns (weights,
    valid), weights exactly 0 at invalid entries.
    """
    valid = top_v > NEG_INF / 2
    neg = torch.full_like(top_v, NEG_INF)
    logits = torch.where(valid, top_v * temp * scale, neg)
    w = torch.softmax(logits, dim=-1)
    return torch.where(valid, w, torch.zeros_like(w)), valid


def dense_attention(q, k, v, mask, scale=None):
    """Masked softmax attention with GQA folding, scale 1/sqrt(D) unless
    given.

    q: (B, H, Sq, D); k/v: (B, H_kv, Skv, D); mask broadcastable to
    (B, 1, 1, Sq, Skv).  Returns (B, H, Sq, Dv) in q's dtype.
    """
    b, h, sq, d = q.shape
    hkv = v.shape[1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    qg = _split_gqa(q, hkv)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    return _softmax_av(logits, mask, v, q)


def _softmax_av(logits, mask, v, q):
    """Masked softmax over (B, H_kv, G, Sq, Skv) logits, then . V;
    returns (B, H, Sq, Dv) in q's dtype."""
    b, h, sq, _ = q.shape
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w.to(v.dtype), v)
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


def make_mask(sq: int, skv: int, *, causal: bool = True, q_positions=None,
              kv_positions=None, kv_valid=None, window: int | None = None,
              device=None):
    """Boolean validity mask broadcastable to (B, 1, Sq, Skv).

    ``q_positions`` (B?, Sq) / ``kv_positions`` (B?, Skv) default to
    arange; ``kv_valid`` (B, Skv) masks invalid cache slots.
    """
    if q_positions is None:
        q_positions = torch.arange(sq, dtype=torch.int32,
                                   device=device)[None, :]
    if kv_positions is None:
        kv_positions = torch.arange(skv, dtype=torch.int32,
                                    device=q_positions.device)[None, :]
    qp = q_positions[:, :, None]  # (B?, Sq, 1)
    kp = kv_positions[:, None, :]  # (B?, 1, Skv)
    mask = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                      dtype=torch.bool, device=qp.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    return mask[:, None]  # (B?, 1, Sq, Skv): the head axis broadcasts


def _split_gqa(q: torch.Tensor, h_kv: int) -> torch.Tensor:
    """(B, H, Sq, D) -> (B, H_kv, G, Sq, D), a view (K/V never repeat)."""
    b, h, sq, d = q.shape
    if h % h_kv != 0:
        raise ValueError(f"H={h} not divisible by H_kv={h_kv}")
    return q.reshape(b, h_kv, h // h_kv, sq, d)


def _binary_scores(qg, k, spec: AttentionSpec, rng=None):
    """Binary scores (B, H_kv, G, Sq, Skv) float32 and the softmax
    temperature (B, H_kv, G, Sq, 1) in q's dtype.  With ``adc_bits`` or
    ``noise_sigma`` the scores come from the device model (noise over
    the broadcast (B, H_kv, G, Sq, Skv, tiles) shape, keyed by ``rng``),
    never from the kernel, as in the reference."""
    scores, q_scale, k_scale = _binary_parts(qg, k, spec, rng)
    # HAD temperature: the per-row q scale and the per-head k scale, so
    # selection on the raw scores orders keys as the hardware does
    k_scale_head = k_scale.mean(dim=-2, keepdim=True)  # (B, H_kv, 1, 1)
    temp = q_scale * k_scale_head[:, :, None]  # (B, H_kv, G, Sq, 1)
    return scores, temp


def _binary_parts(qg, k, spec: AttentionSpec, rng=None):
    """``_binary_scores``' scores and the q and k HAD scales it builds the
    temperature from: (B, H_kv, G, Sq, 1) and (B, H_kv, Skv, 1)."""
    qb, kb, q_scale, k_scale = binarize_qk(
        qg, k, trainable=spec.trainable_binarize, with_scales=True)
    if spec.adc_bits is not None or spec.noise_sigma != 0.0:
        scores = bacam.bacam_scores(
            qb, kb[:, :, None], cam_w=spec.cam_w, adc_bits=spec.adc_bits,
            noise_sigma=spec.noise_sigma, rng=rng, exact=False)
    elif spec.use_kernel:
        from repro_torch.kernels import ops as kops  # local: no cycle

        b, hkv, g, sq, d = qb.shape
        skv = kb.shape[-2]
        s3 = kops.bacam_scores(qb.reshape(b * hkv, g * sq, d),
                               kb.reshape(b * hkv, skv, d))
        scores = s3.reshape(b, hkv, g, sq, skv)
    else:
        scores = bacam.bacam_scores(qb, kb[:, :, None])
    return scores.to(torch.float32), q_scale, k_scale


def attention(q, k, v, spec: AttentionSpec = AttentionSpec(), *,
              causal: bool = True, q_positions=None, kv_positions=None,
              kv_valid=None, window: int | None = None,
              scale: float | None = None, rng=None):
    """Multi-head (GQA) attention in the spec's mode.

    q: (B, H, Sq, D); k: (B, H_kv, Skv, D); v: (B, H_kv, Skv, Dv).
    Masking as ``make_mask``; scale defaults to 1/sqrt(D); ``rng`` (a
    raw key, two uint32 words as int64) keys the device model's
    matchline noise (``spec.noise_sigma``).  Returns (B, H, Sq, Dv) in
    q's dtype.
    """
    b, h, sq, d = q.shape
    h_kv, skv = v.shape[1], v.shape[2]
    if scale is None:
        scale = 1.0 / (d**0.5)
    mask = make_mask(sq, skv, causal=causal, q_positions=q_positions,
                     kv_positions=kv_positions, kv_valid=kv_valid,
                     window=window, device=q.device)
    mask5 = mask[:, :, None]  # (B?, 1, 1, Sq, Skv): over (H_kv, G)

    if spec.mode == "dense":
        return dense_attention(q, k, v, mask5, scale)
    if spec.mode not in ("binary", "camformer"):
        raise ValueError(f"unknown attention mode {spec.mode!r}")

    qg = _split_gqa(q, h_kv)
    scores, temp = _binary_scores(qg, k, spec, rng)
    if spec.mode == "binary":
        # XNOR-Net/HAD dequant: q.k ~ alpha_q alpha_k (qb.kb)
        return _softmax_av(scores * temp * scale, mask5, v, q)

    # camformer: select on the RAW binary scores (hardware ordering)
    raw = torch.where(mask5, scores, torch.full_like(scores, NEG_INF))
    top_v, top_i = two_stage_topk(raw, k=spec.k_top,
                                  group_size=spec.group_size,
                                  stage1_k=spec.stage1_k)  # (B,Hkv,G,Sq,K)
    # the temperature applies to the k survivors (softmax LUT stage)
    valid = top_v > NEG_INF / 2
    w = torch.softmax(torch.where(valid, top_v * temp * scale,
                                  torch.full_like(top_v, NEG_INF)), dim=-1)
    # sparse contextualization: gather only the k selected V rows
    v_sel = _gather_rows(v, top_i)
    out = torch.einsum("bhgqk,bhgqkd->bhgqd", w.to(v.dtype), v_sel)
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


def seq_split_attention(q, k, v, spec: AttentionSpec, comm, length: int, *,
                        q_positions, kv_positions, kv_valid=None,
                        window: int | None = None,
                        scale: float | None = None):
    """Causal ``attention`` (``dense`` or ``binary`` mode) over a cache
    whose sequence is split into shards: k / v (B, H_kv, S_l, D) are this
    process's block, ``kv_positions`` (B?, S_l) its slots' positions and
    ``length`` the whole cache's slots.

    Each shard computes its softmax partials, the row maximum over its
    valid keys, then the sum of exponentials and the unnormalized
    output against the maximum over every shard (``comm.max``); one
    ``comm.sum`` of the (B, H_kv, G, Sq, 1 + Dv) float32 partials merges
    them (log-sum-exp).  Binary scoring's key temperature, the mean of
    the key scales over every slot, sums the shards' scales
    (``comm.sum``) and divides by ``length``.  A row with no valid key
    on any shard gives 0.  Returns (B, H, Sq, Dv) in q's dtype."""
    b, h, sq, d = q.shape
    h_kv, skv = v.shape[1], v.shape[2]
    if scale is None:
        scale = 1.0 / (d**0.5)
    mask = make_mask(sq, skv, causal=True, q_positions=q_positions,
                     kv_positions=kv_positions, kv_valid=kv_valid,
                     window=window, device=q.device)[:, :, None]
    qg = _split_gqa(q, h_kv)
    if spec.mode == "dense":
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qg.to(torch.float32),
                              k.to(torch.float32)) * scale
    elif spec.mode == "binary":
        scores, q_scale, k_scale = _binary_parts(qg, k, spec)
        k_head = comm.sum(k_scale.to(torch.float32).sum(
            dim=-2, keepdim=True)) / length  # (B, H_kv, 1, 1)
        logits = scores * (q_scale * k_head[:, :, None].to(q_scale.dtype)) \
            * scale
    else:
        raise ValueError(f"seq_split_attention: mode {spec.mode!r}")
    logits = torch.where(mask, logits.to(torch.float32),
                         torch.full_like(logits, NEG_INF, dtype=torch.float32))
    m = comm.max(logits.amax(-1, keepdim=True))
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    part = torch.cat([p.sum(-1, keepdim=True),
                      torch.einsum("bhgqk,bhkd->bhgqd", p,
                                   v.to(torch.float32))], dim=-1)
    part = comm.sum(part)
    den = part[..., :1]
    out = part[..., 1:] / torch.where(den > 0, den, torch.ones_like(den))
    return out.reshape(b, h, sq, v.shape[-1]).to(q.dtype)


def _gather_rows(v, idx):
    """v: (B, H_kv, S, Dv); idx: (B, H_kv, G, Sq, K) key indices ->
    (B, H_kv, G, Sq, K, Dv), the selected rows of each (b, kv head)."""
    b, hkv = v.shape[:2]
    bi = torch.arange(b, device=v.device)[:, None, None, None, None]
    hi = torch.arange(hkv, device=v.device)[None, :, None, None, None]
    return v[bi, hi, idx.long()]


def dense_reference(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None):
    """Naive full-precision softmax attention (the tests' oracle)."""
    return attention(q, k, v, AttentionSpec(mode="dense"), causal=causal,
                     scale=scale, window=window)


def _gather_topk(qp, kp, kv_len, q_positions, spec, d, g, window,
                 kv_positions=None):
    """Plain association stage: score packed rows (B, H_kv, G * Sq, W)
    against packed keys (B, H_kv, S, W) (gathered pages or the contiguous
    cache), mask, and run the two-stage top-k, a slice of rows at a time
    so the (rows, S, W) XOR temporary stays bounded.  Key slot i holds
    position i, or ``kv_positions[b, i]`` (B, S) for a ring cache."""
    b, hkv, rows, w = qp.shape
    s_log = kp.shape[2]
    sq = rows // g
    kpos = (torch.arange(s_log, dtype=torch.int32, device=qp.device)
            if kv_positions is None
            else kv_positions.to(torch.int32)[:, None, None, :])
    qpos = q_positions.to(torch.int32)[:, None, None, :].expand(
        b, hkv, g, sq).reshape(b, hkv, rows, 1)
    step = max(1, _GATHER_WORDS // max(1, b * hkv * s_log * w))
    top_v, top_i = [], []
    for r0 in range(0, rows, step):
        with spans.span("attn.cam.score"):
            scores = bacam.hamming_scores_packed(qp[:, :, r0:r0 + step], kp,
                                                 d)
            qr = qpos[:, :, r0:r0 + step]
            ok = (kpos < kv_len.reshape(b, 1, 1, 1)) & (kpos <= qr)
            if window is not None:
                ok = ok & (kpos > qr - window)
        v, i = two_stage_topk(scores, k=spec.k_top,
                              group_size=spec.group_size,
                              stage1_k=spec.stage1_k, where=ok)
        top_v.append(v)
        top_i.append(i)
    return torch.cat(top_v, dim=2), torch.cat(top_i, dim=2)


def _row_temps(q_scale, k_scale, hkv, g, sq):
    """Per-row softmax temperature (B, H_kv, G * Sq): q_scale (B, H, Sq)
    times the running key scale, per slot (B, H_kv) or per query column
    (B, H_kv, Sq) (speculative verify chunks, where column j's scale
    covers keys up to its own position)."""
    b = q_scale.shape[0]
    ks = k_scale.to(torch.float32)
    if ks.ndim == 2:
        ks = ks[:, :, None]
    ks = ks[:, :, None, :].expand(b, hkv, g, sq)
    return q_scale.reshape(b, hkv, g * sq) * ks.reshape(b, hkv, g * sq)


def binary_paged_attention(q, k_pages, v_pages, k_scale, page_table, kv_len,
                           q_positions, spec: AttentionSpec = AttentionSpec(
                               mode="binary"), *, window=None, scale=None,
                           impl="fused"):
    """Binary (HAD sign-match, FULL softmax) attention against paged
    dense-storage K/V pools.

    Q and the paged keys binarize at attend time; the softmax temperature
    is ``q_scale * k_scale`` with ``k_scale`` the slot's running per-head
    key scale (B, H_kv), or per-query scales (B, H_kv, Sq) for a
    speculative verify chunk.  ``impl="fused"`` runs the paged flash
    kernel in its binary mode (kernels/paged_flash_decode.py): decode rows
    through ``paged_flash_decode``, chunk rows through
    ``paged_flash_prefill``, the temperature folded into the query rows.
    ``impl="gather"`` gathers the pages into logical order and runs the
    same masked softmax in plain PyTorch.

    Shapes as ``camformer_paged_attention`` but with dense ``k_pages``
    (P, H_kv, page, D).  Returns (B, H, Sq, Dv) in q's dtype.
    """
    b, h, sq, d = q.shape
    _, hkv, page, dv = v_pages.shape
    g = h // hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    kv_len = kv_len.reshape(b).to(torch.int32)
    qf = q.to(torch.float32)
    temp = _row_temps(had_scales(qf, keepdim=False), k_scale, hkv, g, sq)

    if impl == "fused":
        from repro_torch.kernels import ops as kops  # local: no cycle

        if sq == 1:
            return kops.paged_flash_decode(
                q, k_pages, v_pages, page_table, kv_len,
                q_positions.reshape(b), temp=temp, binary=True,
                window=window, scale=scale)
        return kops.paged_flash_prefill(
            q, k_pages, v_pages, page_table, kv_len, q_positions[:, 0],
            temp=temp, binary=True, window=window, scale=scale)

    from repro_torch.kernels.ref import paged_gather_ref

    ck = paged_gather_ref(k_pages, page_table)  # (B, H_kv, S_log, D)
    cv = paged_gather_ref(v_pages, page_table)
    s_log = ck.shape[2]
    qb = sign_pm1(qf).reshape(b, hkv, g * sq, d)
    kb = sign_pm1(ck.to(torch.float32))
    scores = torch.einsum("bhrd,bhkd->bhrk", qb, kb)
    kpos = torch.arange(s_log, dtype=torch.int32, device=q.device)
    qpos = q_positions.to(torch.int32)[:, None, None, :].expand(
        b, hkv, g, sq).reshape(b, hkv, g * sq, 1)
    ok = (kpos < kv_len.reshape(b, 1, 1, 1)) & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    logits = torch.where(ok, scores * temp[..., None] * scale,
                         torch.full_like(scores, NEG_INF))
    w = torch.where(ok, torch.softmax(logits, dim=-1),
                    torch.zeros_like(logits))  # inert rows: zero out
    out = torch.einsum("bhrk,bhkd->bhrd", w, cv.to(torch.float32))
    return out.reshape(b, h, sq, dv).to(q.dtype)


def camformer_paged_attention(q, kp_pages, v_pages, k_scale, page_table,
                              kv_len, q_positions,
                              spec: AttentionSpec = AttentionSpec(), *,
                              window=None, scale=None, impl="fused"):
    """CAMformer attention against a paged, bit-packed KV cache.

    Decode rows (Sq == 1) with ``impl="fused"`` go through the paged CAM
    kernel (kernels/bacam_decode.py) for scoring + stage-1 top-k, then a
    stable stage-2 top-k.  Prefill chunks (Sq > 1) and ``impl="gather"``
    gather the packed keys into logical order and run the same two-stage
    selection in plain PyTorch.  Softmax runs over the k survivors and
    only the selected V rows are gathered from the paged pool.  Spans
    (``utils/spans``): ``attn.cam.kernel1`` and ``attn.cam.stage2`` on
    the fused route; ``attn.cam.gather``, then ``_gather_topk``'s
    ``attn.cam.score`` and ``two_stage_topk``'s ``attn.cam.stage1`` /
    ``attn.cam.stage2`` on the gather route; ``attn.cam.context`` on
    both.

    q: (B, H, Sq, D); kp_pages: (P, H_kv, page, D/32) int32; v_pages:
    (P, H_kv, page, Dv); k_scale: (B, H_kv) running key scale, or
    (B, H_kv, Sq) per-query scales (speculative verify chunks);
    page_table: (B, NP); kv_len: (B,); q_positions: (B, Sq).
    Returns (B, H, Sq, Dv) in q's dtype.
    """
    b, h, sq, d = q.shape
    _, hkv, page, dv = v_pages.shape
    g = h // hkv
    np_ = page_table.shape[1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    qf = q.to(torch.float32)
    q_scale = had_scales(qf, keepdim=False)  # (B, H, Sq)
    qp = bacam.pack_bits(sign_pm1(qf)).reshape(b, hkv, g * sq, d // 32)
    kv_len = kv_len.reshape(b).to(torch.int32)

    if sq == 1 and impl == "fused":
        from repro_torch.kernels import ops as kops  # local: no cycle

        with spans.span("attn.cam.kernel1"):
            cand_v, cand_i = kops.bacam_paged_scores_topk(
                qp, kp_pages, page_table, kv_len, q_positions.reshape(b),
                d=d, group=spec.group_size, stage1_k=spec.stage1_k,
                window=window)
        with spans.span("attn.cam.stage2"):
            top_v, sel = stable_topk(cand_v,
                                     min(spec.k_top, cand_v.shape[-1]))
            top_i = torch.gather(cand_i, -1, sel)
    else:
        from repro_torch.kernels.ref import paged_gather_ref

        with spans.span("attn.cam.gather"):
            kp = paged_gather_ref(kp_pages, page_table)  # (B, H_kv, S_log, W)
        top_v, top_i = _gather_topk(qp, kp, kv_len, q_positions, spec, d, g,
                                    window)

    with spans.span("attn.cam.context"):
        # sparse V contextualization straight from the paged pool
        top_i = top_i.long()
        pg = top_i // page  # logical page of each selected key (in range)
        row = top_i % page
        pt = page_table.long().clamp(0, v_pages.shape[0] - 1)
        phys = torch.gather(pt[:, None, None, :].expand(b, hkv, g * sq, np_),
                            -1, pg)  # (B, H_kv, R, K)
        heads = torch.arange(hkv, device=q.device)[None, :, None, None]
        v_sel = v_pages[phys, heads, row]  # (B, H_kv, R, K, Dv)

        temp = _row_temps(q_scale, k_scale, hkv, g, sq)[..., None]
        w, _ = topk_softmax_weights(top_v, temp, scale)
        out = torch.einsum("bhrk,bhrkd->bhrd", w.to(v_pages.dtype), v_sel)
        return out.reshape(b, h, sq, dv).to(q.dtype)
