"""Meshes over ``torch.distributed`` (the reference's ``launch/mesh.py``),
and the ambient mesh.

A live mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over every
process of the default group, one process per device, with the
reference's axis names (``pod``, ``data``, ``model``, ``pipe``, ``tp``).
Its device type follows the group's backend: NCCL means ``cuda``, gloo
``cpu`` (``init_distributed`` picks the backend from the device).  A
``MeshShape`` holds axis sizes only: it resolves specs
(``sharding/partitioning.resolve_spec``) for meshes larger than the
world, such as the production meshes.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ["MeshShape", "make_production_mesh", "make_mesh_for",
           "make_tp_mesh", "set_mesh", "get_mesh", "init_distributed",
           "tp_scope", "get_tp_scope", "tp_control_group"]


class MeshShape(NamedTuple):
    """Axis names and sizes, no processes."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def init_distributed(device="cuda", *, init_method="env://", rank=None,
                     world_size=None):
    """Initialise the default process group for ``device`` (NCCL for the
    card, gloo for the CPU) and return this process's device.  Under
    ``torchrun`` the rank, world size and rendezvous come from the
    environment; otherwise pass them (``init_method`` ``tcp://...`` or
    ``file://...``).  On the card each process takes the device of its
    local rank.  An existing group must have the device's backend."""
    from repro_torch import resolve_device

    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {dev}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"device {dev} needs {backend}")
    else:
        kw = {} if rank is None else dict(rank=rank, world_size=world_size)
        if dev.type == "cuda":
            kw["device_id"] = dev
        dist.init_process_group(backend, init_method=init_method, **kw)
    return dev


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _live(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 devices per pod; multi-pod adds a leading 2-pod
    axis.  A live mesh when the world is that large, else its
    ``MeshShape``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized() and _world() == math.prod(shape):
        return _live(shape, axes)
    return MeshShape(axes, shape)


def make_mesh_for(devices: int, model_parallel: int = 1,
                  axes=("data", "model")):
    """A live (devices // model_parallel, model_parallel) mesh over the
    default group, whose world must be ``devices`` processes."""
    if devices < 1 or devices % model_parallel:
        raise ValueError(f"devices={devices} is not a positive multiple of "
                         f"model_parallel={model_parallel}")
    if _world() != devices or not dist.is_initialized():
        raise ValueError(
            f"make_mesh_for: the mesh needs {devices} processes, the world "
            f"has {_world() if dist.is_initialized() else 0} (initialise "
            f"the process group first, e.g. under torchrun)")
    return _live((devices // model_parallel, model_parallel), axes)


_TP_MESHES: dict = {}  # tp -> (mesh or None, gloo control group)


def make_tp_mesh(tp: int):
    """A one-axis ``("tp",)`` mesh over the first ``tp`` processes of the
    world, for tensor-parallel serving (the reference takes the first
    ``tp`` devices); None on the processes outside it.  Every process of
    the world makes its groups together the first time (``new_group`` is
    collective), so one world can hold meshes of several degrees; later
    calls return the same mesh.  Beside the mesh's group it makes a gloo
    group over the same processes for host objects (``tp_control_group``:
    NCCL never carries them).  The axis is deliberately not ``model``:
    the logical-axis rules react only to pod/data/model."""
    if not dist.is_initialized() or _world() < tp:
        raise ValueError(f"make_tp_mesh: the mesh needs {tp} processes, "
                         f"the world has {_world()}")
    if tp not in _TP_MESHES:
        import datetime

        from torch.distributed.device_mesh import DeviceMesh

        ranks = list(range(tp))
        group = dist.new_group(ranks)
        # a follower waits for rank 0's next tick as long as a server
        # idles: the control group's timeout is long
        control = dist.new_group(ranks, backend="gloo",
                                 timeout=datetime.timedelta(days=30))
        mesh = (DeviceMesh.from_group(group, _device_type(),
                                      mesh_dim_names=("tp",))
                if dist.get_rank() < tp else None)
        _TP_MESHES[tp] = (mesh, control)
    return _TP_MESHES[tp][0]


def tp_control_group(tp: int):
    """The gloo group beside ``make_tp_mesh(tp)``'s mesh."""
    return _TP_MESHES[tp][1]


_MESH = None
_TP_SCOPE = None


@contextlib.contextmanager
def tp_scope(mesh):
    """Code inside runs one process's share of a tensor-parallel serving
    step over ``mesh`` (``make_tp_mesh``): attention over a head-sliced
    page pool gathers its heads over the mesh's group."""
    global _TP_SCOPE
    prev, _TP_SCOPE = _TP_SCOPE, mesh
    try:
        yield
    finally:
        _TP_SCOPE = prev


def get_tp_scope():
    """The mesh of the enclosing ``tp_scope``, None outside one."""
    return _TP_SCOPE


def set_mesh(mesh) -> None:
    """Install ``mesh`` (or None) as the ambient mesh of this process."""
    global _MESH
    _MESH = mesh


def get_mesh():
    """The ambient mesh, None when none is set."""
    return _MESH
