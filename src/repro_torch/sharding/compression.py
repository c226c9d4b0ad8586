"""Gradient compression for cross-pod reduction (int8 + error feedback),
the reference's ``sharding/compression.py`` over ``torch.distributed``.

At multi-pod scale the inter-pod links are the scarcest bandwidth, so
the cross-pod gradient reduction is compressed: int8 quantization with
a per-tensor scale and an error-feedback accumulator that re-injects
quantization residuals the next step, keeping the time-averaged update
unbiased while cutting pod-boundary bytes 4x against float32.

    grads, err = compressed_pod_mean(grads, err, group)

``group`` is the process group of the reduced axis (``mesh.get_group(
"pod")``).  ``compressed_mean_ref`` is the plain version over stacked
replicas, without communication.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.module import tree_leaves, tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_leaf",
           "compressed_pod_mean", "compressed_mean_ref"]


def quantize_int8(x: torch.Tensor):
    """(int8 q, float32 scale) with scale = max|x| / 127 + 1e-12 and q
    round-half-even of x / scale clipped to [-127, 127]."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor):
    return q.to(torch.float32) * scale


def compressed_psum_leaf(g: torch.Tensor, err: torch.Tensor, group=None):
    """Error-feedback int8 reduction of one gradient leaf over ``group``.

    The int8 payloads are all-gathered with their per-process scales and
    dequantized exactly per process before summation, so the local
    feedback residual x - q*scale telescopes: the time-averaged delivered
    gradient equals the true mean to within max_scale / (2T).

    Returns (mean gradient float32, new error accumulator)."""
    n = dist.get_world_size(group)
    x = g.to(torch.float32) + err
    q, scale = quantize_int8(x)
    new_err = x - dequantize_int8(q, scale)  # exact local residual
    qs = [torch.empty_like(q) for _ in range(n)]
    scales = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(scales, scale.reshape(()), group=group)
    total = sum(dequantize_int8(a, s) for a, s in zip(qs, scales))
    return total / n, new_err


def compressed_pod_mean(grads, err_tree, group=None):
    """Tree version of ``compressed_psum_leaf``."""
    out = [compressed_psum_leaf(g, e, group)
           for g, e in zip(tree_leaves(grads), tree_leaves(err_tree))]
    means, errs = iter([m for m, _ in out]), iter([e for _, e in out])
    return (tree_map(lambda _: next(means), grads),
            tree_map(lambda _: next(errs), grads))


def compressed_mean_ref(xs: torch.Tensor, errs: torch.Tensor):
    """The plain version: each replica (leading axis of ``xs``, ``errs``)
    quantized with its own scale and feedback, then the mean.  Returns
    (mean estimate, new errs)."""
    n = xs.shape[0]
    x = xs.to(torch.float32) + errs
    dims = tuple(range(1, x.ndim))
    scales = x.abs().amax(dim=dims) / 127.0 + 1e-12
    sc = scales.reshape((-1,) + (1,) * (x.ndim - 1))
    q = torch.clamp(torch.round(x / sc), -127, 127)
    new_errs = x - q * sc  # exact local residual (per-replica scales)
    return (q * sc).sum(0) / n, new_errs
