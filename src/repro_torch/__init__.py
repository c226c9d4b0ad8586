"""PyTorch/CUDA port of the CAMformer serving path.

The package mirrors ``src/repro`` module by module (``configs``,
``core``, ``kernels``, ``models``, ``serving``, ``launch``) and imports
nothing of it: the JAX package is the reference the port is tested
against, not a dependency.  Plain tensor code is PyTorch; every TPU
kernel of the reference has a CUDA C++ counterpart for Hopper
(``csrc/``: paged BA-CAM decode and paged flash attention on the
serving path, contiguous BA-CAM scoring and stage-1 top-k on the
contiguous-cache path, contiguous flash attention), built with ``nvcc``
at first use.

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` (the default of every entry point) raises when no card is
    present instead of falling back: a CPU run must be asked for.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
