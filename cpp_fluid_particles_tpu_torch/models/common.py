"""Host-side helpers shared by the solver steps.

Port of ``cheb_next`` from ``cpp_fluid_particles_tpu/models/common.py``;
the rest of that module serves the gather engine, which is not ported.
"""

from __future__ import annotations

import numpy as np


def cheb_next(itn: int, omega: np.float32, rho2: float,
              start: int) -> np.float32:
    """Chebyshev semi-iteration weight for producing iterate ``itn``
    (1-based): 1 before the delayed start (identity extrapolation), then
    w = 2/(2-rho^2), then w = 4/(4-rho^2 w) ([2015][TOG][Wang]; see
    config.py pbd_chebyshev_rho / dfsph_chebyshev_rho).

    Computed on the host in float32 in the JAX package's operation order:
    ``2/(2-rho2)`` is a Python (double) quotient rounded to float32, and
    ``4/(4-rho2*w)`` is float32 arithmetic with rho2 rounded to float32,
    so the weight is the float32 the JAX package computes on the device."""
    if itn < start:
        return np.float32(1.0)
    if itn == start:
        return np.float32(2.0 / (2.0 - rho2))
    return np.float32(4.0) / (np.float32(4.0)
                              - np.float32(rho2) * np.float32(omega))
