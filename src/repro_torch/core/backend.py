"""Pluggable attention backends: contiguous caches and paged pools.

An ``AttentionBackend`` defines how one attention layer realizes

  * its contiguous KV cache layout (``cache_spec``), the splice into it
    (``write_cache``) and the decode step against it (``decode``),
  * attention over freshly computed K/V (``prefill``: whole-prompt
    prefill),
  * its paged pool layout (``page_spec``) and the paged prefill/decode
    step against it (``paged_decode``, the serving engine's path).

The four backends of the reference:

  * ``dense``     — softmax attention over bf16/f32 K/V pages, the oracle;
  * ``binary``    — HAD-binarized scoring with a full softmax over dense
                    K/V pages plus a running per-slot ``k_scale`` (the
                    single-stage ablation lane, and the default drafter
                    of speculative decoding);
  * ``camformer`` — the paper: bit-packed binary key pages, two-stage
                    top-k CAM search, sparse top-k V gather;
  * ``hybrid``    — camformer's pools plus a dense key pool: prefill
                    chunks flash-score over the dense pools, decode rows
                    and speculative verify chunks take the CAM path.

Each ``paged_decode`` has two realizations (``ModelConfig.paged_impl``):
``"fused"`` runs the decode rows through the paged CUDA kernels
(kernels/paged_flash_decode.py for dense and binary, its binary mode for
the latter, kernels/bacam_decode.py for camformer and hybrid) and
``"gather"`` gathers the pages into logical order and attends in plain
PyTorch.  Dense and binary Sq > 1 chunks follow ``prefill_paged_impl``;
camformer chunks always gather: there is no fused Sq>1 CAM kernel, in
the reference either, so ``paged_io_stats`` gives camformer's two
prefill columns the gather numbers (``hybrid`` closes that gap: its
chunks flash-score over a dense key pool).  ``cache_bytes_per_token``
and ``paged_io_stats`` are the reference's analytic capacity and
decode-step I/O accounting, the same numbers under the same keys.

Under ``cfg.spec_verify`` (a speculative verify chunk, with the
``k_means`` pool leaf sized ``spec_k + 1``) the stateful backends score
each chunk column with the running key scale AT ITS OWN POSITION
(``_chunk_scale_seq``) and stash the chunk's per-position key means in
``k_means``, so serving/speculate.py can roll the scale back exactly.

Contiguous camformer decode rows (and prefill chunks) run the BA-CAM
association kernel (kernels/bacam_topk.py) when ``cfg.use_kernel`` is
set, and whole-prompt prefill the BA-CAM matrix kernel through
``core/attention.attention``; without it they score in plain PyTorch.
A ring cache (``decode``'s ``kv_positions``: the position each slot
holds, rotated once the window wraps) masks by those positions, and
camformer decode against it takes the plain association stage, as the
reference routes it.

Inside a sharded serving step a contiguous cache may be this process's
block of the sequence (``partitioning.cache_seq``, the reference's
``CACHE_RULES["kv_seq"]``): a write lands only in the shard that owns
its position (``_seq_write``; every shard keeps the running
``k_scale``), and decode merges the shards.  Dense and binary decode
merge each shard's softmax partials by log-sum-exp
(``core/attention.seq_split_attention``: per layer and step one max and
one sum of (B, H, Sq, 1 + Dv) float32 across the shards, and for binary
one (B, H_kv) key-scale sum); camformer exchanges its k candidates a
shard, the distributed CAM search (``_shard_attend``).  A cache whose
heads are this process's (``heads``) needs no merge: every head count
here is read off the tensors.

Caches and pools are updated IN PLACE (the reference's functional
``dynamic_update_slice`` / ``.at[].set`` would copy a whole cache per
layer per step): ``write_cache`` / ``decode`` / ``paged_decode`` write
the new rows into the tensors of the ``cache`` dict they are given and
return that dict.

Row contract (one call per layer per engine tick, for every batch row):
rows with ``kv_len == 0`` are INERT — their writes resolve to the trash
page 0 and their running ``k_scale`` is left untouched.  Several padding
rows may write trash page 0 at once, so its contents are arbitrary.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.core import bacam
from repro_torch.core.attention import (AttentionSpec, _gather_rows,
                                        _gather_topk, attention,
                                        binary_paged_attention,
                                        camformer_paged_attention,
                                        dense_attention,
                                        seq_split_attention,
                                        topk_softmax_weights)
from repro_torch.core.binarize import had_scales, sign_pm1
from repro_torch.core.topk import stable_topk
from repro_torch.sharding import partitioning as P

__all__ = ["AttentionBackend", "DenseBackend", "BinaryBackend",
           "CamformerBackend", "HybridBackend", "register_backend", "get_backend", "list_backends",
           "backends_for"]

_BACKENDS: Dict[str, "AttentionBackend"] = {}

_TRASH_PAGE = 0  # serving/kv_cache.py contract: physical page 0 is trash


def register_backend(backend: "AttentionBackend") -> "AttentionBackend":
    """Register a backend instance under ``backend.name`` (last wins)."""
    _BACKENDS[backend.name] = backend
    return backend


def get_backend(name: str) -> "AttentionBackend":
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown attention backend {name!r}; have "
                       f"{sorted(_BACKENDS)}") from None


def list_backends() -> list:
    return sorted(_BACKENDS)


def backends_for(cfg) -> tuple:
    """Resolve the per-layer backend objects for a model config."""
    return tuple(get_backend(cfg.backend_for(i)) for i in range(cfg.n_layers))


def _seq_insert(buf, upd, index):
    """Write ``upd`` (B, H, S, ...) into ``buf`` (B, H, L, ...) along the
    sequence axis, in place, and return ``buf``.

    index: an int or 0-d tensor (the same start for every row: prefill)
    or a (B,) tensor (one start per row: decode).  As the reference's
    ``dynamic_update_slice`` does, a start that would run past the end is
    clamped to L - S (and a negative one to 0); the clamp is explicit
    here, since PyTorch indexing would raise instead.
    """
    length, s = buf.shape[2], upd.shape[2]
    upd = upd.to(buf.dtype)
    if not torch.is_tensor(index) or index.ndim == 0:
        i = min(max(int(index), 0), length - s)
        buf[:, :, i:i + s] = upd
        return buf
    start = torch.clamp(index.to(torch.int64), 0, length - s)
    pos = start[:, None] + torch.arange(s, device=buf.device)  # (B, S)
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, :, pos] = upd.transpose(1, 2)
    return buf


def _seq_write(buf, upd, index):
    """``_seq_insert`` into a contiguous cache, or, inside
    ``partitioning.cache_seq_split``, into this process's block of its
    sequence: the start is clamped against the whole length (n shards x
    the block), and only the rows at positions the block holds are
    written."""
    split = P.cache_seq()
    if split is None:
        return _seq_insert(buf, upd, index)
    _, shard, n = split
    local, s = buf.shape[2], upd.shape[2]
    offset, length = shard * local, n * local
    upd = upd.to(buf.dtype)
    if not torch.is_tensor(index) or index.ndim == 0:
        i = min(max(int(index), 0), length - s)
        lo, hi = max(i, offset), min(i + s, offset + local)
        if lo < hi:
            buf[:, :, lo - offset:hi - offset] = upd[:, :, lo - i:hi - i]
        return buf
    start = torch.clamp(index.to(torch.int64), 0, length - s)
    rows = torch.arange(buf.shape[0], device=buf.device)
    for t in range(s):  # one row a position: no two writes collide
        slot = start + t - offset
        mine = (slot >= 0) & (slot < local)
        slot = torch.clamp(slot, 0, local - 1)
        old = buf[rows, :, slot]
        keep = mine.reshape((-1,) + (1,) * (old.dim() - 1))
        buf[rows, :, slot] = torch.where(keep, upd[:, :, t], old)
    return buf


def _cache_len(cache) -> int:
    """The whole sequence length of a contiguous cache (its block times
    the shards inside ``partitioning.cache_seq_split``)."""
    split = P.cache_seq()
    return cache["v"].shape[2] * (1 if split is None else split[2])


def _local_positions(kv_positions, local: int):
    """The positions of this process's slots of a ring cache: the block
    of ``kv_positions`` (B, L) that the sequence split gives it."""
    split = P.cache_seq()
    if split is None or kv_positions is None:
        return kv_positions
    return P.local_part(kv_positions, 1, split[1] * local, local)


def _running_k_scale(k_scale, k, pos, kv_len, base):
    """A slot's running per-head key scale over VALID tokens only.

    k_scale: (B, H_kv) stored running mean of mean_d(|k|); k:
    (B, H_kv, S, D) the fresh keys; pos: (B, S) their positions; kv_len:
    (B,) valid tokens INCLUDING this write; base: (B,) or None — the
    prefix-sharing offset below which positions never counted for this
    slot.  Rows with no valid tokens keep their stored scale.
    """
    b = k.shape[0]
    valid = (pos < kv_len[:, None]).to(torch.float32)  # (B, S)
    mean_d = had_scales(k.to(torch.float32), dim=3, keepdim=False)
    new_sum = torch.einsum("bhs,bs->bh", mean_d, valid)
    cnt = valid.sum(dim=-1)  # (B,)
    if base is None:
        base = torch.zeros((b,), dtype=torch.int32, device=k.device)
    prior = torch.clamp(torch.minimum(pos[:, 0], kv_len)
                        - base.reshape(b).to(torch.int32),
                        min=0).to(torch.float32)
    total = prior + cnt
    ks = ((k_scale * prior[:, None] + new_sum)
          / torch.clamp(total, min=1.0)[:, None])
    return torch.where((total > 0)[:, None], ks, k_scale)


def _chunk_scale_seq(k_scale, k, pos, kv_len, base):
    """Per-query running key scales of a speculative verify chunk.

    The query at chunk column j must see the running mean over keys up to
    ITS OWN position (the value sequential decode would use), not a mean
    that includes the chunk's later keys.  Arguments as
    ``_running_k_scale``.  Returns ``(per_query (B, H_kv, S), means
    (B, H_kv, S))``: the sequential-semantics scale of each column, and
    the chunk's valid-masked per-position ``mean_d(|k|)`` (the
    ``k_means`` leaf, from which the rollback rebuilds the running mean
    at any accepted length).
    """
    b = k.shape[0]
    valid = (pos < kv_len[:, None]).to(torch.float32)  # (B, S)
    means = had_scales(k.to(torch.float32), dim=3,
                       keepdim=False) * valid[:, None, :]
    if base is None:
        base = torch.zeros((b,), dtype=torch.int32, device=k.device)
    prior = torch.clamp(torch.minimum(pos[:, 0], kv_len)
                        - base.reshape(b).to(torch.int32),
                        min=0).to(torch.float32)  # (B,)
    cum = torch.cumsum(means, dim=2)
    cnt = prior[:, None] + torch.cumsum(valid, dim=1)  # (B, S)
    per_q = ((k_scale[:, :, None] * prior[:, None, None] + cum)
             / torch.clamp(cnt, min=1.0)[:, None, :])
    per_q = torch.where((cnt > 0)[:, None, :], per_q, k_scale[:, :, None])
    return per_q, means


def _verify_scales(cache, k_scale_before, k, positions, kv_len, base, cfg,
                   sq):
    """Under ``cfg.spec_verify``, for a chunk of ``spec_k + 1`` columns:
    the per-query scales (B, H_kv, Sq) and, in place, the ``k_means``
    stash.  Otherwise the slot's running ``k_scale`` (B, H_kv)."""
    means = cache.get("k_means")
    if not (sq > 1 and cfg.spec_verify and means is not None
            and means.shape[-1] == sq):
        return cache["k_scale"]
    per_q, cache["k_means"] = _chunk_scale_seq(
        k_scale_before, k, positions.to(torch.int32),
        kv_len.reshape(k.shape[0]).to(torch.int32), base)
    return per_q


def _k_means_spec(cfg, max_batch):
    """The speculative verify scratch leaf, present only with spec_k > 0:
    the tick's per-position key means (B, H_kv, spec_k + 1)."""
    if cfg.spec_k <= 0:
        return {}
    return {"k_means": ((max_batch, cfg.n_kv_heads, cfg.spec_k + 1),
                        torch.float32)}


def _page_phys_rows(page_table, positions, page: int, kv_len=None):
    """(physical page, in-page row) of each logical position, both (B, S)
    int64.  With kv_len (B,), positions >= kv_len (right-padding rows)
    resolve to the TRASH page.  The page column is clamped into the
    table, as the reference's gather clamps it implicitly."""
    pos = positions.long()
    col = torch.clamp(pos // page, 0, page_table.shape[1] - 1)
    phys = torch.gather(page_table.long(), 1, col)
    if kv_len is not None:
        phys = torch.where(pos < kv_len.reshape(-1, 1).long(), phys,
                           torch.full_like(phys, _TRASH_PAGE))
    return phys, pos % page


def _write_rows(pool, phys, row, x):
    """pool[phys[b, s], :, row[b, s]] = x[b, :, s] for every (b, s), in
    place.  x: (B, H_kv, S, ...)."""
    pool[phys, :, row] = x.to(pool.dtype).transpose(1, 2)


def _pool_rows(kv_len, page_size, n_table_pages):
    """(rows of the slot's live pages, rows of its whole table extent)."""
    return (-(-max(kv_len, 1) // page_size) * page_size,
            n_table_pages * page_size)


class AttentionBackend:
    """One physical realization of the attention operation."""

    name: str = "?"
    mode: str = "?"  # core/attention AttentionSpec operator mode

    def spec(self, cfg) -> AttentionSpec:
        return AttentionSpec(mode=self.mode, k_top=cfg.k_top,
                             group_size=cfg.group_size,
                             stage1_k=cfg.stage1_k,
                             use_kernel=cfg.use_kernel)

    def cache_spec(self, cfg, batch: int, cache_len: int, dtype) -> dict:
        """{leaf: (shape, dtype)} of one layer's contiguous cache."""
        raise NotImplementedError

    def prefill(self, q, k, v, cfg, *, causal=True, positions=None,
                window=None):
        """Attention over freshly computed K/V (whole-prompt prefill).
        Returns (B, H, Sq, Dv)."""
        return attention(q, k, v, self.spec(cfg), causal=causal,
                         q_positions=positions, window=window)

    def decode(self, q, cache, k, v, cache_index, kv_len, positions, cfg, *,
               kv_positions=None, window=None):
        """Write k/v at ``cache_index`` then attend against the contiguous
        cache.  Returns (out, cache)."""
        raise NotImplementedError

    def write_cache(self, cache, k, v, index, cfg):
        """Insert new K/V at ``index`` along the cache sequence axis.  An
        update longer than the cache keeps only its trailing cache-length
        slice, stored at 0."""
        if cache is None:
            return None
        cache_len = _cache_len(cache)
        if k.shape[2] > cache_len:
            k, v = k[:, :, -cache_len:], v[:, :, -cache_len:]
            index = 0
        return self._write(cache, k, v, index, cfg)

    def _write(self, cache, k, v, index, cfg):
        raise NotImplementedError

    def page_spec(self, cfg, n_pages: int, page_size: int, max_batch: int,
                  dtype) -> dict:
        """{leaf: (shape, dtype)} of one layer's paged pool."""
        raise NotImplementedError

    def cache_bytes_per_token(self, cfg, dtype) -> float:
        """KV bytes appended per token per layer (capacity accounting);
        ``dtype`` is the pools' ``torch.dtype``."""
        raise NotImplementedError

    def paged_decode(self, q, cache, k, v, positions, page_table, kv_len,
                     cfg, *, base=None):
        """Write k/v into the pools at their logical positions and attend
        through the page table.  Returns (out (B, H, Sq, Dv), cache)."""
        raise NotImplementedError

    # -- analytic decode-step I/O accounting ----------------------------
    def paged_io_stats(self, cfg, dtype, *, kv_len: int, page_size: int,
                       n_table_pages: int) -> dict:
        """Analytic per-layer, per-slot decode-step I/O in bytes, the
        reference's numbers under its keys.

        ``fused_read_bytes`` / ``gather_read_bytes``: pool bytes READ per
        decode token by each ``paged_impl`` realization (fused walks only
        the slot's LIVE pages; gather dereferences the full
        ``n_table_pages`` table extent).  ``gather_scratch_bytes``: the
        peak logical-order scratch the gather impl materializes per slot
        (the fused kernels stream page tiles: zero scratch).
        ``prefill_fused_read_bytes`` / ``prefill_gather_read_bytes``: the
        same for one Sq > 1 chunk attend under each ``prefill_impl``; the
        chunk reads the pools once whatever its length, so bytes per
        prefill token divide by the chunk size.  Benchmarks multiply by
        ``n_layers`` and the batch for the system's numbers.
        """
        row = 2 * cfg.n_kv_heads * cfg.head_dim * dtype.itemsize  # K + V
        live_rows, table_rows = _pool_rows(kv_len, page_size, n_table_pages)
        return {
            "fused_read_bytes": live_rows * row,
            "gather_read_bytes": table_rows * row,
            "gather_scratch_bytes": table_rows * row,
            "prefill_fused_read_bytes": live_rows * row,
            "prefill_gather_read_bytes": table_rows * row,
        }


class DenseBackend(AttentionBackend):
    """Standard softmax attention over full-precision K/V pages."""

    name = "dense"
    mode = "dense"

    def cache_spec(self, cfg, batch, cache_len, dtype):
        shape = (batch, cfg.n_kv_heads, cache_len, cfg.head_dim)
        return {"k": (shape, dtype), "v": (shape, dtype)}

    def page_spec(self, cfg, n_pages, page_size, max_batch, dtype):
        shape = (n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
        return {"k_pages": (shape, dtype), "v_pages": (shape, dtype)}

    def cache_bytes_per_token(self, cfg, dtype):
        return 2 * cfg.n_kv_heads * cfg.head_dim * dtype.itemsize

    def _write(self, cache, k, v, index, cfg):
        _seq_write(cache["k"], k, index)
        _seq_write(cache["v"], v, index)
        return cache

    def decode(self, q, cache, k, v, cache_index, kv_len, positions, cfg, *,
               kv_positions=None, window=None):
        cache = self.write_cache(cache, k, v, cache_index, cfg)
        return self.attend(q, cache, kv_len, positions, cfg,
                           kv_positions=kv_positions, window=window), cache

    def attend(self, q, cache, kv_len, positions, cfg, *, kv_positions=None,
               window=None):
        """Attention of q (B, H, Sq, D) over the written contiguous
        cache (``decode`` after its write); the shards' partials merged
        inside ``partitioning.cache_seq_split``."""
        ck, cv = cache["k"], cache["v"]
        split = P.cache_seq()
        local = ck.shape[2]
        kv_pos = _local_positions(kv_positions, local)
        if kv_pos is None:
            first = 0 if split is None else split[1] * local
            kv_pos = torch.arange(first, first + local, dtype=torch.int32,
                                  device=q.device)[None]
        kv_valid = kv_pos < kv_len.reshape(-1, 1)
        kw = dict(q_positions=positions, kv_positions=kv_pos,
                  kv_valid=kv_valid, window=window or cfg.window)
        if split is None:
            return attention(q, ck, cv, self.spec(cfg), causal=True, **kw)
        return seq_split_attention(q, ck, cv, self.spec(cfg), split[0],
                                   local * split[2], **kw)

    def _paged_write(self, cache, k, v, positions, page_table, kv_len=None):
        page = cache["k_pages"].shape[2]
        phys, row = _page_phys_rows(page_table, positions, page, kv_len)
        _write_rows(cache["k_pages"], phys, row, k)
        _write_rows(cache["v_pages"], phys, row, v)
        return cache

    def paged_decode(self, q, cache, k, v, positions, page_table, kv_len,
                     cfg, *, base=None):
        # dense pages carry no per-slot running statistics
        cache = self._paged_write(cache, k, v, positions, page_table, kv_len)
        out = self._paged_attend(q, cache, positions, page_table, kv_len, cfg)
        return out, cache

    def _paged_attend(self, q, cache, positions, page_table, kv_len, cfg):
        sq = q.shape[2]
        impl = cfg.paged_impl if sq == 1 else cfg.prefill_paged_impl
        if impl == "fused":
            from repro_torch.kernels import ops as kops

            fn = kops.paged_flash_decode if sq == 1 else \
                kops.paged_flash_prefill
            return fn(q, cache["k_pages"], cache["v_pages"], page_table,
                      kv_len.reshape(-1), positions[:, 0], window=cfg.window)
        from repro_torch.kernels.ref import paged_gather_ref

        ck = paged_gather_ref(cache["k_pages"], page_table)
        cv = paged_gather_ref(cache["v_pages"], page_table)
        kpos = torch.arange(ck.shape[2], device=q.device)[None, None, :]
        qpos = positions.long()[:, :, None]
        mask = (kpos <= qpos) & (kpos < kv_len.reshape(-1, 1, 1).long())
        if cfg.window is not None:
            mask = mask & (kpos > qpos - cfg.window)
        return dense_attention(q, ck, cv, mask[:, None, None])


class BinaryBackend(DenseBackend):
    """HAD-binarized scoring with a FULL softmax (no top-k sparsity).

    Contiguous storage is dense's (keys binarize at attend time).  The
    paged pools add camformer's running per-slot ``k_scale``, kept at
    page-write time over valid tokens only, as the softmax temperature.
    """

    name = "binary"
    mode = "binary"

    def page_spec(self, cfg, n_pages, page_size, max_batch, dtype):
        spec = super().page_spec(cfg, n_pages, page_size, max_batch, dtype)
        spec["k_scale"] = ((max_batch, cfg.n_kv_heads), torch.float32)
        spec.update(_k_means_spec(cfg, max_batch))
        return spec

    def _paged_write(self, cache, k, v, positions, page_table, kv_len=None,
                     base=None):
        super()._paged_write(cache, k, v, positions, page_table, kv_len)
        b = k.shape[0]
        pos = positions.to(torch.int32)
        kvl = (torch.full((b,), pos.shape[1], dtype=torch.int32,
                          device=k.device) if kv_len is None
               else kv_len.reshape(b).to(torch.int32))
        cache["k_scale"] = _running_k_scale(cache["k_scale"], k, pos, kvl,
                                            base)
        return cache

    def paged_decode(self, q, cache, k, v, positions, page_table, kv_len,
                     cfg, *, base=None):
        before = cache["k_scale"]
        cache = self._paged_write(cache, k, v, positions, page_table, kv_len,
                                  base=base)
        sq = q.shape[2]
        k_scale = _verify_scales(cache, before, k, positions, kv_len, base,
                                 cfg, sq)
        impl = cfg.paged_impl if sq == 1 else cfg.prefill_paged_impl
        out = binary_paged_attention(
            q, cache["k_pages"], cache["v_pages"], k_scale, page_table,
            kv_len, positions, self.spec(cfg), window=cfg.window, impl=impl)
        return out, cache


class CamformerBackend(AttentionBackend):
    """The paper's BA-CAM realization: bit-packed binary key pages,
    two-stage top-k CAM search, softmax over the k survivors, sparse
    top-k V gather."""

    name = "camformer"
    mode = "camformer"

    def cache_spec(self, cfg, batch, cache_len, dtype):
        hkv, d = cfg.n_kv_heads, cfg.head_dim
        return {
            "k_packed": ((batch, hkv, cache_len, d // 32), torch.int32),
            "v": ((batch, hkv, cache_len, d), dtype),
            "k_scale": ((batch, hkv), torch.float32),
        }

    def _write(self, cache, k, v, index, cfg):
        _seq_write(cache["k_packed"], bacam.pack_bits(sign_pm1(k)), index)
        _seq_write(cache["v"], v, index)
        # running per-head key scale (softmax temperature bookkeeping),
        # over every written position, as the reference keeps it
        step = float(k.shape[2])
        new_mean = k.to(torch.float32).abs().mean(dim=(2, 3))  # (B, H_kv)
        idx_f = torch.as_tensor(index, dtype=torch.float32,
                                device=k.device).reshape(-1, 1)
        cache["k_scale"] = ((cache["k_scale"] * idx_f + new_mean * step)
                            / (idx_f + step))
        return cache

    def decode(self, q, cache, k, v, cache_index, kv_len, positions, cfg, *,
               kv_positions=None, window=None):
        cache = self.write_cache(cache, k, v, cache_index, cfg)
        return self.attend(q, cache, kv_len, positions, cfg,
                           kv_positions=kv_positions, window=window), cache

    def attend(self, q, cache, kv_len, positions, cfg, *, kv_positions=None,
               window=None):
        """The CAM search of q over the written cache (``decode`` after
        its write): across the shards inside
        ``partitioning.cache_seq_split`` (``_shard_attend``), across the
        ambient mesh for a B = 1 ``distributed_topk`` decode, else
        local."""
        del window  # the config's window, as the reference's
        split = P.cache_seq()
        if split is not None:
            comm, shard, _ = split
            local = cache["v"].shape[2]
            kpos = _local_positions(kv_positions, local)
            return self._shard_attend(q, cache["k_packed"], cache["v"],
                                      cache["k_scale"], kv_len, positions,
                                      cfg, comm, shard * local, kpos)
        if (cfg.distributed_topk and kv_positions is None
                and q.shape[0] == 1):
            return self._distributed_attend(q, cache, kv_len, positions,
                                            cfg)
        return self._cache_attend(q, cache, kv_len, positions, cfg,
                                  kv_positions=kv_positions)

    def _cache_attend(self, q, cache, kv_len, positions, cfg,
                      kv_positions=None):
        """Decode / chunk attention against the packed binary cache.

        q: (B, H, Sq, D); kv_len: (B,); positions: (B, Sq).  With
        ``cfg.use_kernel`` the association stage (scores + stage-1 top-k)
        runs in kernels/bacam_topk.py, with the query rows of (b, kv head)
        folded as r = g * Sq + s; otherwise in plain PyTorch.  Stage 2,
        the softmax over the survivors and the sparse V gather follow.

        A ring cache (``kv_positions`` (B, L), the position each slot
        holds) always takes the plain association stage, as the
        reference routes it: the kernel masks by slot order, and a
        ring's slots are rotated.
        """
        spec = self.spec(cfg)
        b, h, sq, d = q.shape
        hkv = cache["v"].shape[1]
        g = h // hkv
        skv = cache["v"].shape[2]
        w = d // 32
        qf = q.to(torch.float32)
        q_scale = had_scales(qf, keepdim=False)  # (B, H, Sq)
        qp = bacam.pack_bits(sign_pm1(qf)).reshape(b, hkv, g * sq, w)
        kv_len = kv_len.reshape(b).to(torch.int32)
        if spec.use_kernel and kv_positions is None:
            from repro_torch.kernels import ops as kops  # local: no cycle

            pos = positions.to(torch.int32)[:, None, None, :].expand(
                b, hkv, g, sq).reshape(b * hkv, g * sq)
            kvl = kv_len[:, None].expand(b, hkv).reshape(b * hkv)
            cand_v, cand_i = kops.bacam_attention_scores_topk_packed(
                qp.reshape(b * hkv, g * sq, w),
                cache["k_packed"].reshape(b * hkv, skv, w), pos, kvl, d=d,
                group=spec.group_size, stage1_k=spec.stage1_k, causal=True,
                window=cfg.window, sq=sq)
            top_v, sel = stable_topk(cand_v,
                                     min(spec.k_top, cand_v.shape[-1]))
            top_i = torch.gather(cand_i, -1, sel)
        else:
            top_v, top_i = _gather_topk(qp, cache["k_packed"], kv_len,
                                        positions, spec, d, g, cfg.window,
                                        kv_positions=kv_positions)
        top_v = top_v.reshape(b, hkv, g, sq, -1)
        top_i = top_i.reshape(b, hkv, g, sq, -1)

        temp = (q_scale.reshape(b, hkv, g, sq)[..., None]
                * cache["k_scale"][:, :, None, None, None])
        wts, _ = topk_softmax_weights(top_v, temp, 1.0 / (d**0.5))
        v_sel = _gather_rows(cache["v"], top_i)  # (B, H_kv, G, Sq, K, Dv)
        out = torch.einsum("bhgqk,bhgqkd->bhgqd", wts.to(cache["v"].dtype),
                           v_sel)
        return out.reshape(b, h, sq, d).to(q.dtype)

    def _distributed_attend(self, q, cache, kv_len, positions, cfg):
        """Distributed CAM search (paper Sec. IV-C at cluster scale).

        The packed-binary cache is sequence-sharded over the ambient
        mesh's axes of size > 1 among (``pod``, ``data``, ``model``), in
        that order (``launch/mesh.set_mesh``): ``cache`` is the whole
        sequence, as ``decode`` writes it (so ``write_cache`` and the
        running ``k_scale`` see the global index), and each process
        searches its slice of S / n_shards rows, at ``shard * S /
        n_shards`` (``CACHE_RULES["kv_seq"]``).  Each process scores its
        keys and runs the two-stage top-k locally, the processes exchange
        only their k candidates (values and globalized indices,
        all-gathered in shard order), the global top-k and its softmax
        are computed
        redundantly everywhere (ties to the first occurrence, as
        ``lax.top_k``), and the contextualization is a partial sum over
        the local V rows finished by one all-reduce.  Without a mesh, or
        with no axis larger than 1 (a world of one), the search is the
        local one, as the reference's.
        """
        from repro_torch.launch.mesh import get_mesh

        mesh = get_mesh()
        sizes = (dict(zip(mesh.mesh_dim_names, mesh.shape))
                 if mesh is not None else {})
        axes = tuple(a for a in ("pod", "data", "model")
                     if sizes.get(a, 1) > 1)
        if not axes:
            return self._cache_attend(q, cache, kv_len, positions, cfg)
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        skv = cache["v"].shape[2]
        n_shards = math.prod(sizes[a] for a in axes)
        if skv % n_shards:
            raise ValueError(f"distributed_topk: a cache of {skv} rows does "
                             f"not split over {n_shards} shards")
        s_local = skv // n_shards
        shard = 0
        for a in axes:  # the shard's index, major-to-minor
            shard = shard * sizes[a] + coord[a]
        offset = shard * s_local
        rows = slice(offset, offset + s_local)
        comm = P.SeqComm([mesh.get_group(a) for a in axes])
        return self._shard_attend(q, cache["k_packed"][:, :, rows],
                                  cache["v"][:, :, rows], cache["k_scale"],
                                  kv_len, positions, cfg, comm, offset,
                                  None, use_kernel=False)

    def _shard_attend(self, q, kp_l, v_l, k_scale, kv_len, positions, cfg,
                      comm, offset, kv_positions=None, use_kernel=None):
        """One shard's part of the CAM search over a sequence-split
        cache: kp_l / v_l (B, H_kv, S_l, .) the shard's rows, which hold
        positions ``offset + j`` (or ``kv_positions`` (B, S_l) for a
        ring), k_scale (B, H_kv) the running key scale, the same on every
        shard.  The shard scores its keys and runs the two-stage top-k
        (the association kernel with ``use_kernel``, at positions and
        lengths shifted by ``offset``; a ring takes the plain stage), the
        shards exchange their k candidates (values and slot indices made
        global, gathered in shard order through ``comm``), the global
        top-k and its softmax are computed on every shard (ties to the
        first occurrence, the lowest slot), and the contextualization is
        a partial sum over the shard's V rows summed across the shards.
        The candidates are the unsplit search's: each shard's groups are
        whole groups of the cache."""
        spec = self.spec(cfg)
        if use_kernel is None:
            use_kernel = spec.use_kernel and kv_positions is None
        b, h, sq, d = q.shape
        hkv, s_local = v_l.shape[1], v_l.shape[2]
        g = h // hkv
        w = d // 32
        qf = q.to(torch.float32)
        q_scale = had_scales(qf, keepdim=False)  # (B, H, Sq)
        qp = bacam.pack_bits(sign_pm1(qf)).reshape(b, hkv, g * sq, w)
        kv_len = kv_len.reshape(b).to(torch.int32)
        if use_kernel:
            from repro_torch.kernels import ops as kops  # local: no cycle

            pos = torch.clamp(positions.to(torch.int32) - offset, min=-1)
            pos = pos[:, None, None, :].expand(b, hkv, g, sq).reshape(
                b * hkv, g * sq)
            kvl = torch.clamp(kv_len - offset, 0, s_local)[:, None].expand(
                b, hkv).reshape(b * hkv)
            cand_v, cand_i = kops.bacam_attention_scores_topk_packed(
                qp.reshape(b * hkv, g * sq, w),
                kp_l.reshape(b * hkv, s_local, w), pos, kvl, d=d,
                group=spec.group_size, stage1_k=spec.stage1_k, causal=True,
                window=cfg.window, sq=sq)
            lv, sel = stable_topk(cand_v, min(spec.k_top, cand_v.shape[-1]))
            li = torch.gather(cand_i, -1, sel).reshape(b, hkv, g * sq, -1)
            lv = lv.reshape(b, hkv, g * sq, -1)
        else:
            kpos = (offset + torch.arange(s_local, dtype=torch.int32,
                                          device=q.device)).expand(
                b, s_local) if kv_positions is None else kv_positions
            lv, li = _gather_topk(qp, kp_l, kv_len, positions, spec, d, g,
                                  cfg.window, kv_positions=kpos)
        li = li.to(torch.int32) + offset  # global slots
        lv, li = comm.gather(lv, -1), comm.gather(li, -1)
        top_v, sel = stable_topk(lv, min(spec.k_top, lv.shape[-1]))
        top_i = torch.gather(li, -1, sel)
        temp = (q_scale.reshape(b, hkv, g * sq)[..., None]
                * k_scale[:, :, None, None])
        wts, valid = topk_softmax_weights(top_v, temp, 1.0 / (d**0.5))
        mine = (top_i >= offset) & (top_i < offset + s_local) & valid
        loc = torch.clamp(top_i - offset, 0, s_local - 1).long()
        v_sel = v_l[torch.arange(b, device=q.device)[:, None, None, None],
                    torch.arange(hkv, device=q.device)[None, :, None, None],
                    loc]
        out = comm.sum(torch.einsum(
            "bhrk,bhrkd->bhrd", torch.where(mine, wts, torch.zeros_like(wts)),
            v_sel.to(torch.float32)))
        return out.reshape(b, hkv, g, sq, d).reshape(b, h, sq, d).to(q.dtype)

    def page_spec(self, cfg, n_pages, page_size, max_batch, dtype):
        hkv, d = cfg.n_kv_heads, cfg.head_dim
        if page_size % cfg.group_size != 0:
            raise ValueError(f"page_size={page_size} must tile by "
                             f"group_size={cfg.group_size}")
        # the k_means stash is doubly needed here: the packed pool keeps
        # signs only, so chunk key magnitudes are gone after the write
        return {
            "kp_pages": ((n_pages, hkv, page_size, d // 32), torch.int32),
            "v_pages": ((n_pages, hkv, page_size, d), dtype),
            "k_scale": ((max_batch, hkv), torch.float32),
            **_k_means_spec(cfg, max_batch),
        }

    def cache_bytes_per_token(self, cfg, dtype):
        d = cfg.head_dim
        return cfg.n_kv_heads * (d // 8 + d * dtype.itemsize)

    def paged_io_stats(self, cfg, dtype, *, kv_len, page_size,
                       n_table_pages):
        hkv, d = cfg.n_kv_heads, cfg.head_dim
        kp_row = hkv * (d // 8)  # bit-packed keys: 1 bit an element
        live_rows, table_rows = _pool_rows(kv_len, page_size, n_table_pages)
        # V is never gathered: only the k_top survivors are read, per
        # GQA query row (worst case all-unique selections)
        g = cfg.n_heads // hkv
        v_sel = hkv * g * min(cfg.k_top, kv_len or 1) * d * dtype.itemsize
        return {
            "fused_read_bytes": live_rows * kp_row + v_sel,
            "gather_read_bytes": table_rows * kp_row + v_sel,
            "gather_scratch_bytes": table_rows * kp_row,
            # no fused Sq>1 CAM kernel: chunk attends gather the packed
            # pool under either prefill_impl
            "prefill_fused_read_bytes": table_rows * kp_row + v_sel,
            "prefill_gather_read_bytes": table_rows * kp_row + v_sel,
        }

    def _paged_write(self, cache, k, v, positions, page_table, kv_len,
                     base=None):
        """Splice new K/V into the pools at their logical positions.

        k, v: (B, H_kv, S, D); positions: (B, S); kv_len: (B,) valid
        tokens per slot INCLUDING this write.  Rows at positions >= kv_len
        go to the trash page and are left out of the k_scale running mean;
        ``base`` (B,) is the prefix-sharing offset of that mean.
        """
        page = cache["kp_pages"].shape[2]
        b = k.shape[0]
        pos = positions.to(torch.int32)
        kv_len = kv_len.reshape(b).to(torch.int32)
        phys, row = _page_phys_rows(page_table, pos, page, kv_len)
        _write_rows(cache["kp_pages"], phys, row, bacam.pack_bits(sign_pm1(k)))
        _write_rows(cache["v_pages"], phys, row, v)
        cache["k_scale"] = _running_k_scale(cache["k_scale"], k, pos, kv_len,
                                            base)
        return cache

    def paged_decode(self, q, cache, k, v, positions, page_table, kv_len,
                     cfg, *, base=None):
        before = cache["k_scale"]
        cache = self._paged_write(cache, k, v, positions, page_table, kv_len,
                                  base=base)
        k_scale = _verify_scales(cache, before, k, positions, kv_len, base,
                                 cfg, q.shape[2])
        out = camformer_paged_attention(
            q, cache["kp_pages"], cache["v_pages"], k_scale, page_table,
            kv_len, positions, self.spec(cfg), window=cfg.window,
            impl=cfg.paged_impl)
        return out, cache


class HybridBackend(CamformerBackend):
    """Flash-scored prefill chunks + CAM decode.

    The pools carry both key representations: a dense ``k_pages`` pool
    for Sq > 1 prefill chunks (the paged flash kernel, exact softmax) and
    camformer's packed ``kp_pages`` + running ``k_scale`` for decode rows.
    One write keeps both current.  Speculative verify chunks take the CAM
    path with per-query scales: verify must reproduce this backend's
    sequential decode, which is CAM.
    """

    name = "hybrid"
    mode = "camformer"

    def page_spec(self, cfg, n_pages, page_size, max_batch, dtype):
        spec = super().page_spec(cfg, n_pages, page_size, max_batch, dtype)
        spec["k_pages"] = ((n_pages, cfg.n_kv_heads, page_size,
                            cfg.head_dim), dtype)
        return spec

    def cache_bytes_per_token(self, cfg, dtype):
        d = cfg.head_dim
        # packed keys + dense keys (flash prefill) + dense values
        return cfg.n_kv_heads * (d // 8 + 2 * d * dtype.itemsize)

    def paged_io_stats(self, cfg, dtype, *, kv_len, page_size,
                       n_table_pages):
        kw = dict(kv_len=kv_len, page_size=page_size,
                  n_table_pages=n_table_pages)
        stats = super().paged_io_stats(cfg, dtype, **kw)
        # decode columns stay CAM; prefill chunks read the DENSE pools
        dense = AttentionBackend.paged_io_stats(self, cfg, dtype, **kw)
        for key in ("prefill_fused_read_bytes", "prefill_gather_read_bytes"):
            stats[key] = dense[key]
        return stats

    def _paged_write(self, cache, k, v, positions, page_table, kv_len,
                     base=None):
        super()._paged_write(cache, k, v, positions, page_table, kv_len,
                             base=base)
        page = cache["k_pages"].shape[2]
        phys, row = _page_phys_rows(
            page_table, positions.to(torch.int32), page,
            kv_len.reshape(k.shape[0]).to(torch.int32))
        _write_rows(cache["k_pages"], phys, row, k)
        return cache

    def prefill(self, q, k, v, cfg, *, causal=True, positions=None,
                window=None):
        # whole-prompt prefill is flash-scored, as the paged chunks are
        return get_backend("dense").prefill(
            q, k, v, cfg, causal=causal, positions=positions, window=window)

    def paged_decode(self, q, cache, k, v, positions, page_table, kv_len,
                     cfg, *, base=None):
        if q.shape[2] > 1 and not cfg.spec_verify:
            cache = self._paged_write(cache, k, v, positions, page_table,
                                      kv_len, base=base)
            out = get_backend("dense")._paged_attend(
                q, cache, positions, page_table, kv_len, cfg)
            return out, cache
        return super().paged_decode(q, cache, k, v, positions, page_table,
                                    kv_len, cfg, base=base)


register_backend(DenseBackend())
register_backend(BinaryBackend())
register_backend(CamformerBackend())
register_backend(HybridBackend())
