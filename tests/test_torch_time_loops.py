"""The loops over time of the RG-LRU (``models/rglru._rg_lru``) and the
WKV recurrence (``models/rwkv6._wkv``, time-major on ``bmm``), each with
its adjoint written out, against the per-step autograd loops they replace,
kept here as oracles: outputs bit for bit, and gradients bit for bit
(the RG-LRU's, and every WKV input's but ``u``, whose gradient sums the
steps in another order: 1e-6 of its largest)."""

import numpy as np
import pytest
import torch

from repro_torch.models import rglru, rwkv6


def indexed_rg_lru(a, drive, h):
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + drive[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h


def indexed_wkv(r, k, v, w, u, state):
    u4 = u[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], state + u4 * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, dim=1), state


def _outputs_and_grads(fn, inputs, seed, use_last):
    """fn's two outputs and the gradients of a seeded random projection
    of them (of the first alone unless ``use_last``)."""
    inputs = [x.clone().requires_grad_() for x in inputs]
    first, last = fn(*inputs)
    rng = np.random.default_rng(seed)
    proj = lambda t: (t * torch.from_numpy(
        rng.standard_normal(t.shape).astype(np.float32))).sum()
    loss = proj(first) + (proj(last) if use_last else 0)
    return [first.detach(), last.detach()] + list(
        torch.autograd.grad(loss, inputs))


@pytest.mark.parametrize("shape", [(2, 37, 16), (1, 1, 8)])
@pytest.mark.parametrize("use_last", [True, False])
def test_rg_lru_equals_the_indexed_loop(shape, use_last):
    rng = np.random.default_rng(0)
    b, _, r = shape
    inputs = [torch.from_numpy(x.astype(np.float32)) for x in (
        rng.uniform(0.5, 1.0, shape), rng.standard_normal(shape),
        rng.standard_normal((b, r)))]
    got = _outputs_and_grads(rglru._rg_lru, inputs, 1, use_last)
    want = _outputs_and_grads(indexed_rg_lru, inputs, 1, use_last)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", [(2, 23, 3, 8), (1, 1, 2, 64)])
def test_wkv_equals_the_indexed_loop(shape):
    rng = np.random.default_rng(2)
    b, _, h, c = shape
    f32 = lambda x: torch.from_numpy(x.astype(np.float32))
    inputs = [f32(rng.standard_normal(shape)) for _ in range(3)] + [
        f32(rng.uniform(0.5, 1.0, shape)), f32(rng.standard_normal((h, c))),
        f32(rng.standard_normal((b, h, c, c)))]
    got = _outputs_and_grads(rwkv6._wkv, inputs, 3, True)
    want = _outputs_and_grads(indexed_wkv, inputs, 3, True)
    du = 2 + 4  # the outputs, then the gradients of r, k, v, w, u, state
    for i, (g, w) in enumerate(zip(got, want)):
        if i == du:
            assert (g - w).abs().max() <= 1e-6 * w.abs().max()
        else:
            assert torch.equal(g, w), i
