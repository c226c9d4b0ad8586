"""Shared utilities: the step counts of a traced step (``hlo``) and
atomic JSON writes (``io``)."""

from repro_torch.utils.io import write_json_atomic

__all__ = ["write_json_atomic"]
