"""Pluggable attention backends over the paged KV pools.

An ``AttentionBackend`` defines how one attention layer realizes its
paged pool layout (``page_spec``) and the paged prefill/decode step
against it (``paged_decode``, the single serving path).  This port
carries the two backends of the serving main path:

  * ``dense``     — softmax attention over bf16/f32 K/V pages, the oracle;
  * ``camformer`` — the paper: bit-packed binary key pages, two-stage
                    top-k CAM search, sparse top-k V gather.

Each ``paged_decode`` has two realizations (``ModelConfig.paged_impl``):
``"fused"`` runs the decode rows through the paged CUDA kernels
(kernels/paged_flash_decode.py for dense, kernels/bacam_decode.py for
camformer) and ``"gather"`` gathers the pages into logical order and
attends in plain PyTorch.  Dense Sq > 1 chunks follow
``prefill_paged_impl``; camformer chunks always gather.

Pools are updated IN PLACE (the reference's functional ``.at[].set``
would copy a whole pool per layer per tick): ``paged_decode`` writes the
new rows into the tensors of the ``cache`` dict it is given and returns
that dict.

Row contract (one call per layer per engine tick, for every batch row):
rows with ``kv_len == 0`` are INERT — their writes resolve to the trash
page 0 and their running ``k_scale`` is left untouched.  Several padding
rows may write trash page 0 at once, so its contents are arbitrary.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import bacam
from repro_torch.core.attention import (AttentionSpec,
                                        camformer_paged_attention,
                                        dense_attention)
from repro_torch.core.binarize import had_scales, sign_pm1

__all__ = ["AttentionBackend", "DenseBackend", "CamformerBackend",
           "register_backend", "get_backend", "list_backends",
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
                       f"{sorted(_BACKENDS)} (binary and hybrid are not "
                       "ported yet)") from None


def list_backends() -> list:
    return sorted(_BACKENDS)


def backends_for(cfg) -> tuple:
    """Resolve the per-layer backend objects for a model config."""
    return tuple(get_backend(cfg.backend_for(i)) for i in range(cfg.n_layers))


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


class AttentionBackend:
    """One physical realization of paged attention."""

    name: str = "?"

    def spec(self, cfg) -> AttentionSpec:
        return AttentionSpec(k_top=cfg.k_top, group_size=cfg.group_size,
                             stage1_k=cfg.stage1_k)

    def page_spec(self, cfg, n_pages: int, page_size: int, max_batch: int,
                  dtype) -> dict:
        """{leaf: (shape, dtype)} of one layer's paged pool."""
        raise NotImplementedError

    def paged_decode(self, q, cache, k, v, positions, page_table, kv_len,
                     cfg, *, base=None):
        """Write k/v into the pools at their logical positions and attend
        through the page table.  Returns (out (B, H, Sq, Dv), cache)."""
        raise NotImplementedError


class DenseBackend(AttentionBackend):
    """Standard softmax attention over full-precision K/V pages."""

    name = "dense"

    def page_spec(self, cfg, n_pages, page_size, max_batch, dtype):
        shape = (n_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
        return {"k_pages": (shape, dtype), "v_pages": (shape, dtype)}

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


class CamformerBackend(AttentionBackend):
    """The paper's BA-CAM realization: bit-packed binary key pages,
    two-stage top-k CAM search, softmax over the k survivors, sparse
    top-k V gather."""

    name = "camformer"

    def page_spec(self, cfg, n_pages, page_size, max_batch, dtype):
        hkv, d = cfg.n_kv_heads, cfg.head_dim
        if page_size % cfg.group_size != 0:
            raise ValueError(f"page_size={page_size} must tile by "
                             f"group_size={cfg.group_size}")
        if cfg.spec_k > 0:
            raise NotImplementedError("speculative decoding is not ported")
        return {
            "kp_pages": ((n_pages, hkv, page_size, d // 32), torch.int32),
            "v_pages": ((n_pages, hkv, page_size, d), dtype),
            "k_scale": ((max_batch, hkv), torch.float32),
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
        cache = self._paged_write(cache, k, v, positions, page_table, kv_len,
                                  base=base)
        out = camformer_paged_attention(
            q, cache["kp_pages"], cache["v_pages"], cache["k_scale"],
            page_table, kv_len, positions, self.spec(cfg), window=cfg.window,
            impl=cfg.paged_impl)
        return out, cache


register_backend(DenseBackend())
register_backend(CamformerBackend())
