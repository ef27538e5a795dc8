"""Uniform-grid constants and cell binning.

Port of ``cpp_fluid_particles_tpu/ops/grid.py:36-68``. Cell-id convention
matches the reference (src/CUDAFunctions.cuh:64-70); the compacted-cell
gather grid of the JAX package (``build_grid``) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig

# Fill value for padded position slots: far enough that every kernel
# evaluates to exactly 0 against any real particle, small enough that no
# intermediate (r^2, q^5-style terms) overflows float32.
POS_PAD = 1e6

# The 27-cell stencil in the reference's iteration order
# (m/9-1, (m%9)/3-1, m%3-1) — src/BasicSPHSolver.cu:62-66 et al.
STENCIL = np.array(
    [(m // 9 - 1, (m % 9) // 3 - 1, m % 3 - 1) for m in range(27)],
    dtype=np.int32,
)


def cell_coords(pos: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """(N,3) float positions -> (N,3) int32 cell coordinates.

    C-style truncation toward zero, like the reference's make_int3 cast
    (src/CUDAFunctions.cuh:76). The divisor is a tensor on ``pos``'s own
    device: on CUDA, PyTorch divides by a Python scalar as a multiply by
    its reciprocal, which is one ulp off true division for some positions
    and would bin them into the neighbouring cell."""
    cl = torch.full((), cfg.cell_length, dtype=pos.dtype, device=pos.device)
    return (pos / cl).to(torch.int32)
