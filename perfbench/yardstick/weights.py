"""The weights of a run, drawn from ``--seed`` on the device.

The leaf shapes come from the program (``repro_torch.models.module.
param_shapes``: the tree ``ServeEngine`` serves); the draw is the
benchmark's own.  Every random leaf lies in one flat buffer in the
serving dtype, filled by a few ``normal_`` calls of at most
``CHUNK`` elements from one ``torch.Generator`` on the device, then
scaled one run of leaves of equal std at a time.  Matrices get N(0, 1 /
fan_in) (fan-in the last-but-one axis), a leaf that states its std (the
token embedding: d_model ** -0.5) that std; norm scales are ones and
biases zeros.  The same tensors go to the engine and to the reference.
"""

from __future__ import annotations

import torch

from yardstick.loadgen import SEED_MASK

CHUNK = 1 << 30


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _std(shape, init, extra):
    if extra:
        return float(extra[0])
    fan_in = shape[0] if len(shape) == 1 else shape[-2]
    return (1.0 / max(1, fan_in)) ** 0.5


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _skeleton(tree):
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v) for v in tree]
    return None


def draw(shapes: dict, seed: int, device, dtype) -> dict:
    """The parameter tree of ``shapes`` ((shape, init, axes[, std])
    leaves), drawn from ``seed`` on ``device`` in ``dtype``."""
    out = _skeleton(shapes)
    rand = []
    for path, (shape, init, _axes, *extra) in _leaves(shapes):
        if init in ("zeros", "ones"):
            fill = torch.zeros if init == "zeros" else torch.ones
            _set(out, path, fill(shape, dtype=dtype, device=device))
        else:
            rand.append((_std(shape, init, extra), path, tuple(shape)))
    rand.sort(key=lambda r: r[0])  # leaves of one std side by side
    total = sum(_numel(s) for _, _, s in rand)
    buf = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & SEED_MASK)
    for off in range(0, total, CHUNK):
        buf[off:off + CHUNK].normal_(0.0, 1.0, generator=gen)
    off = 0
    run_start, run_std = 0, None
    for std, path, shape in rand:
        if std != run_std:
            if run_std is not None:
                buf[run_start:off].mul_(run_std)
            run_start, run_std = off, std
        n = _numel(shape)
        _set(out, path, buf[off:off + n].view(shape))
        off += n
    if run_std is not None:
        buf[run_start:off].mul_(run_std)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
