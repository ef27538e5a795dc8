"""cpp_fluid_particles_tpu_torch — the PyTorch / CUDA port of
``cpp_fluid_particles_tpu``.

Same module names and public names as the JAX package, which stays the
reference. Plain tensor code is torch; the kernels that the JAX package
wrote in Pallas (the neighbor pass and the flat-grid prototype's pass of
exp/flat_pallas_proto.py) are hand-written CUDA kernels for Hopper
(csrc/column_pass.cu), built with nvcc on first use. This package imports
neither jax nor the JAX package. It runs the three solvers (WCSPH, DFSPH
and PBD, the default) on the sliding-box engine, on one device or, with
``Simulation(mesh=parallel.make_mesh())``, on an x-slab mesh of one
process per rank, or with ``parallel.make_mesh2d((nx, nz))`` on x-z blocks
(see ROADMAP.md for what comes next).
"""

from . import parallel
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
