"""Percentiles of the end-to-end metrics.

A frozen copy of ``benchmarks/serve_slo.py::_pcts``' arithmetic (numpy's
linear interpolation between order statistics), rewritten here so that
no later change to the program or to the JAX benchmark scripts moves a
benchmark number.
"""

from __future__ import annotations

import numpy as np


def percentile(values, q: float):
    """The ``q``-th percentile (0-100) of ``values``, linear
    interpolation; None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
