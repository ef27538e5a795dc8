"""Particle state containers and scene construction.

Port of ``cpp_fluid_particles_tpu/state.py``: the whole per-particle state
is one structure-of-arrays of torch tensors on one device. The array order is
the particle identity and never changes, so the scene builders below must
produce positions bitwise equal to the JAX package's (they are the same
numpy code).

Scene construction reproduces src/main.cpp:73-117: a 36x24x24 dam-break
fluid block and six boundary walls sampled at half the cell length.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import SimConfig, dam_break_config


class FluidState(NamedTuple):
    """SoA fluid state (src/SPHParticles.h:20-60 equivalents)."""

    pos: torch.Tensor       # (N, 3) float32
    vel: torch.Tensor       # (N, 3) float32
    mass: torch.Tensor      # (N,)   float32
    density: torch.Tensor   # (N,)   float32
    pressure: torch.Tensor  # (N,)   float32

    @property
    def n(self) -> int:
        return self.pos.shape[0]


def make_fluid_state(pos: np.ndarray, cfg: SimConfig,
                     device: torch.device | str) -> FluidState:
    n = pos.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    return FluidState(
        pos=torch.as_tensor(np.asarray(pos, np.float32), **f32),
        vel=torch.zeros((n, 3), **f32),
        mass=torch.full((n,), cfg.m0, **f32),  # src/SPHSystem.cu:73
        density=torch.zeros((n,), **f32),
        pressure=torch.zeros((n,), **f32),
    )


def dam_break_positions(cfg: SimConfig) -> np.ndarray:
    """The 36x24x24 fluid block at (0.27, 0.10, 0.27) (src/main.cpp:75-85).

    Loop nesting matches the reference (i over y, j over x, k over z) so the
    particle ordering is identical.
    """
    s = cfg.spacing
    out = []
    for i in range(36):
        for j in range(24):
            for k in range(24):
                out.append((0.27 + s * j, 0.10 + s * i, 0.27 + s * k))
    return np.asarray(out, np.float32)


def block_positions(origin, n_xyz, spacing) -> np.ndarray:
    """A rectangular fluid block (generalisation of the reference's
    hard-coded 36x24x24 dam block, src/main.cpp:75-85)."""
    nx, ny, nz = n_xyz
    i, j, k = np.meshgrid(np.arange(ny), np.arange(nx), np.arange(nz),
                          indexing="ij")
    out = np.stack([
        origin[0] + spacing * j.ravel(),
        origin[1] + spacing * i.ravel(),
        origin[2] + spacing * k.ravel(),
    ], -1)
    return out.astype(np.float32)


def scaled_dam_scene(n_target: int, cfg_overrides=None,
                     mode: str = "fast"):
    """A scaled dam-break: a cube block of ~n_target particles filling
    about half the domain width. Returns (cfg, fluid_positions).

    The block spacing is exactly cell_length/2 and the origin sits at a
    quarter-cell offset, so lattice planes stay clear of cell boundaries
    (see the JAX package's ``state.scaled_dam_scene`` for why)."""
    side = int(round(n_target ** (1.0 / 3.0)))
    cfg0 = dam_break_config(mode=mode)
    spacing = cfg0.cell_length / 2.0
    extent = side * spacing
    space = float(np.ceil(extent * 2.0 * 100) / 100)
    cfg = dam_break_config(mode=mode,
                           space_size=(space, space, space),
                           **(cfg_overrides or {}))
    cl = cfg.cell_length
    origin = tuple(
        (np.floor(f * space / cl) + 0.25) * cl
        for f in (0.25, 0.1, 0.25))
    return cfg, block_positions(origin, (side, side, side), spacing)


def drop_scene(mode: str = "fast", cfg_overrides=None,
               pool_layers: int = 6, drop_side: int = 12,
               drop_height: float = 0.55):
    """A drop-into-pool scene: a shallow resting pool filling the floor
    plus a compact cube falling onto its center. Returns
    (cfg, fluid_positions). Same domain, walls and physics constants as
    the dam; only the fluid emitter differs."""
    cfg = dam_break_config(mode=mode, **(cfg_overrides or {}))
    s = cfg.spacing
    space = cfg.space_size
    # the wall insets are the JAX package's literals, reproduced bitwise
    nx = int((space[0] - 0.08) / s)
    nz = int((space[2] - 0.08) / s)
    pool = block_positions((0.04, 0.04, 0.04),
                           (nx, pool_layers, nz), s)
    extent = drop_side * s
    cx = 0.5 * (space[0] - extent)
    cz = 0.5 * (space[2] - extent)
    drop = block_positions((cx, drop_height, cz),
                           (drop_side, drop_side, drop_side), s)
    return cfg, np.concatenate([pool, drop], 0).astype(np.float32)


def boundary_positions(cfg: SimConfig) -> np.ndarray:
    """Six walls of the unit cube, 2*cell_size samples per axis, inset to
    [0.005, 0.995] * space (src/main.cpp:88-117). 14,408 particles for the
    default config."""
    space = np.asarray(cfg.space_size, np.float64)
    compact = 2 * np.asarray(cfg.cell_size, np.int64)  # (cx, cy, cz) doubled
    cbx, cy, cz = int(compact[0]), int(compact[1]), int(compact[2])
    denom = compact.astype(np.float64) - 1.0
    out = []

    def emit(ix, iy, iz):
        x = np.array([ix, iy, iz], np.float64) / denom * space
        out.append(0.99 * x + 0.005 * space)

    # front and back (z = 0 and z = cz-1)
    for i in range(cbx):
        for j in range(cy):
            emit(i, j, 0)
            emit(i, j, cz - 1)
    # top and bottom (y = 0 and y = cy-1), z interior
    for i in range(cbx):
        for j in range(cz - 2):
            emit(i, 0, j + 1)
            emit(i, cy - 1, j + 1)
    # left and right (x = 0 and x = cx-1), y and z interior
    for i in range(cy - 2):
        for j in range(cz - 2):
            emit(0, i + 1, j + 1)
            emit(cbx - 1, i + 1, j + 1)

    return np.asarray(out, np.float32)
