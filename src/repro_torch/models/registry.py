"""Model registry: arch family -> ModelDef."""

from __future__ import annotations

from repro_torch.models import encdec, rglru, transformer, vlm
from repro_torch.models.transformer import ModelDef

__all__ = ["get_model_def"]

_FAMILY = {
    "dense": transformer.make_model_def,
    "moe": transformer.make_model_def,
    "hybrid": rglru.make_model_def,
    "encdec": encdec.make_model_def,
    "audio": encdec.make_model_def,
    "vlm": vlm.make_model_def,
}


def get_model_def(cfg) -> ModelDef:
    """The family's entry points.  The reference's ``ssm`` family
    (rwkv6) raises NotImplementedError naming the family."""
    try:
        return _FAMILY[cfg.family]()
    except KeyError:
        raise NotImplementedError(
            f"{cfg.name!r}: model family {cfg.family!r} is not ported yet "
            f"(the port has {sorted(_FAMILY)})") from None
