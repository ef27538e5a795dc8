"""cpp_fluid_particles_tpu_torch — the PyTorch / CUDA port of
``cpp_fluid_particles_tpu``.

Same module names and public names as the JAX package, which stays the
reference. Plain tensor code is torch; the neighbor-pass kernel that the
JAX package wrote in Pallas is a hand-written CUDA kernel for Hopper
(csrc/column_pass.cu), built with nvcc on first use. This package imports
neither jax nor the JAX package. So far it runs the WCSPH solver on the
sliding-box engine (see ROADMAP.md for what comes next).
"""

from .config import BENCH_DT, SimConfig, dam_break_config
from .simulation import SOLVERS, Simulation, resolve_solver
from .state import (
    FluidState,
    block_positions,
    boundary_positions,
    dam_break_positions,
    drop_scene,
    make_fluid_state,
    scaled_dam_scene,
)

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "dam_break_config",
    "BENCH_DT",
    "Simulation",
    "SOLVERS",
    "resolve_solver",
    "FluidState",
    "block_positions",
    "drop_scene",
    "scaled_dam_scene",
    "boundary_positions",
    "dam_break_positions",
    "make_fluid_state",
]
