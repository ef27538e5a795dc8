"""Divergence-Free SPH carry [Bender & Koschier 2015].

Port of the carry of ``cpp_fluid_particles_tpu/models/dfsph.py:31-40``.
The warm-start stiffness is carried per particle across steps; particle
identity is the array order and never changes, so the reference's re-sort
realignment of ``denWarmStiff`` (src/DFSPHSolver.cu:170-171) is not
needed. The step itself is ``models/dense_step.dfsph_step``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..state import FluidState


class DFSPHCarry(NamedTuple):
    warm_stiff: torch.Tensor  # (N,) accumulated density-solve stiffness
    div_warm: torch.Tensor    # (N,) accumulated divergence-solve stiffness
                              #     (used when cfg.dfsph_warm_divergence > 0)


def init_carry(state: FluidState) -> DFSPHCarry:
    """Two distinct zero tensors on the state's device."""
    def zeros():
        return torch.zeros((state.n,), dtype=torch.float32,
                           device=state.pos.device)
    return DFSPHCarry(warm_stiff=zeros(), div_warm=zeros())
