"""Position-Based Fluids carry [Macklin & Mueller 2013].

Port of the carry of ``cpp_fluid_particles_tpu/models/pbd.py:35-44``. The
carried last-step positions need no re-sorting (particle identity is the
array order), and the reference's first-step initialisation by exception
(src/PBDSolver.cu:44-47) becomes ``pos_last = pos`` at carry creation.
The step itself is ``models/dense_step.pbd_step``; the gather-engine step
and its re-binning oracle (``cfg.pbd_rebin_moving``) are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..state import FluidState


class PBDCarry(NamedTuple):
    pos_last: torch.Tensor  # (N, 3) positions at the previous step
    dp_warm: torch.Tensor   # (N, 3) previous frame's total projection shift
                            #        (used when cfg.pbd_warm_start > 0)


def init_carry(state: FluidState) -> PBDCarry:
    """``pos_last`` is a copy of ``state.pos``, not an alias of it;
    ``dp_warm`` is zeros."""
    return PBDCarry(pos_last=state.pos.clone(),
                    dp_warm=torch.zeros_like(state.pos))
