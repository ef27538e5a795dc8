"""Sliding-box solver steps — the main path.

Port of the WCSPH part of ``cpp_fluid_particles_tpu/models/dense_step.py``
for the default engine ``xlab``: the per-step state lives in the lane-major
grid of the fluid's sliding bounding box (ops/box.py), with one stacked
scatter in, every neighbor pass through ops/passes.py, every intermediate
update elementwise in grid space, and one stacked gather out.

Safety invariants used throughout: empty slots carry POS_PAD positions and
zero masses, so (a) every pair term vanishes against them, and (b) a slot
is "real" iff its x-position is < POS_GUARD, which gates the elementwise
position clamps.

Scalars that JAX computes in float32 from a float32 ``dt`` (``visc*dt``,
``dt*gravity``, the fallback's wall) are computed here on the host with
numpy float32, so both packages multiply by the same float.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import SimConfig
from ..ops import box as bx
from ..ops import passes as pp
from ..ops.dense import (DenseDims, build_dense_index, dims_for, fill_dense,
                         read_dense)
from ..ops.grid import POS_PAD
from ..state import FluidState

F32 = torch.float32
POS_GUARD = POS_PAD / 2.0


class Layout(NamedTuple):
    """The sliding-box grid layout of one step."""

    idx: bx.BoxIndex
    fill: Callable           # (fields, fills) -> stacked grid tensor
    read: Callable           # grid tensor -> (F, N)
    dims: DenseDims          # box dims for the fluid passes
    dims_b: DenseDims        # box dims for the boundary window
    bd: torch.Tensor         # boundary window (4, Kb, GB)


def _layout(pos, cfg, dims, dims_b, scene_d, box) -> Layout:
    bdims = DenseDims(box[0], box[1], box[2], dims.k)
    bdims_b = DenseDims(box[0], box[1], box[2], dims_b.k)
    idx = bx.build_box_index(pos, cfg, dims, bdims)
    bdx = bx.slice_boundary_box(scene_d.bd, dims, bdims, idx.origin)
    return Layout(
        idx=idx,
        fill=lambda fields, fills: bx.fill_box(idx, fields, fills, bdims),
        read=lambda arr: bx.read_box(idx, arr),
        dims=bdims, dims_b=bdims_b, bd=bdx)


def _base_metrics(idx: bx.BoxIndex, touch: torch.Tensor) -> Dict:
    """The JAX package's box metrics. ``capacity`` packs the auto-capacity
    scalars so that ONE host fetch reads them all: [grid_overflow,
    box_overflow, max_occupancy, box_ext(3), bd_touch, win_overflow,
    win_ext(3)]; the occupancy-split window fields are always zero here."""
    zeros3 = torch.zeros((3,), dtype=torch.int32, device=idx.ext.device)
    m = {"grid_overflow": idx.overflow,
         "box_overflow": idx.box_overflow,
         "box_ext": idx.ext,
         "active_cells": torch.prod(idx.ext).to(torch.int32),
         "max_occupancy": idx.max_occupancy,
         "win_ext": zeros3,
         "bd_touch": touch,
         "win_overflow": zeros3[0]}
    m["capacity"] = torch.cat([
        torch.stack([m["grid_overflow"], m["box_overflow"],
                     m["max_occupancy"]]), m["box_ext"],
        m["bd_touch"][None], m["win_overflow"][None], m["win_ext"]])
    return m


class DenseScene(NamedTuple):
    """Static boundary data [posx, posy, posz, mass] on the full-domain
    ghosted grid (4, Kb, G); each step cuts the box's window from it."""

    bd: torch.Tensor


def build_dense_scene(cfg: SimConfig, b_pos: np.ndarray, kb: int,
                      device, executor: Optional[pp.Executor] = None
                      ) -> DenseScene:
    """Akinci boundary mass (src/SPHSystem.cu:92-105) computed with the
    boundary grid itself as the only neighbor source."""
    dims_b = dims_for(cfg, kb)
    b_pos = torch.as_tensor(np.asarray(b_pos, np.float32), device=device)
    idx = build_dense_index(b_pos, cfg, dims_b)
    pads = [POS_PAD, POS_PAD, POS_PAD, 0.0]
    ones = torch.ones((b_pos.shape[0],), dtype=F32, device=device)
    fl = fill_dense(idx, [b_pos[:, 0], b_pos[:, 1], b_pos[:, 2], ones],
                    pads, dims_b)
    # the "boundary" j-source contributes nothing here (zero masses, real
    # positions): the W-sum runs boundary-vs-boundary through the fluid slot
    zero_bd = fl.clone()
    zero_bd[3] = 0.0
    wsum = pp.density_pass(fl, zero_bd, dims_b, dims_b, cfg, executor)
    b_mass = _const(cfg.rho_boundary, wsum) / torch.clamp(
        read_dense(idx, wsum[None])[0], min=cfg.epsilon)
    bd = fill_dense(idx, [b_pos[:, 0], b_pos[:, 1], b_pos[:, 2], b_mass],
                    pads, dims_b)
    return DenseScene(bd=bd)


def boundary_k(b_pos: np.ndarray, cfg: SimConfig) -> int:
    coords = np.floor_divide(np.asarray(b_pos), cfg.cell_length).astype(np.int64)
    cx, cy, cz = cfg.cell_size
    flat = (coords[:, 0] * cy + coords[:, 1]) * cz + coords[:, 2]
    _, counts = np.unique(flat, return_counts=True)
    return int(counts.max())


# ----------------------------------------------------------------------
# elementwise helpers (grid space)
# ----------------------------------------------------------------------

def _f32(x) -> float:
    """A host scalar rounded to float32, as JAX holds it."""
    return float(np.float32(x))


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A host scalar as a 0-d tensor on ``like``'s device, for divisions:
    PyTorch computes ``scalar / t`` as ``reciprocal(t) * scalar``, and on
    CUDA ``t / scalar`` as ``t * (1 / scalar)``; both can be one ulp off
    the true quotient that JAX computes. Filled on the device: no copy
    from the host, no sync."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _real_slot(pos_d: torch.Tensor) -> torch.Tensor:
    return pos_d[0] < POS_GUARD


def _clamp_pos_vel(pos_d, vel_d, cfg):
    """Wall clamp + inward-velocity zeroing (src/BasicSPHSolver.cu:85-96),
    gated to real slots so padded positions stay far away."""
    real = _real_slot(pos_d)
    out_p, out_v = [], []
    for c in range(3):
        hi = 0.99 * cfg.space_size[c]
        p, v = pos_d[c], vel_d[c]
        vc = torch.where(p <= 0.0, torch.clamp(v, min=0.0), v)
        vc = torch.where(p >= hi, torch.clamp(vc, max=0.0), vc)
        out_p.append(torch.where(real, torch.clamp(p, 0.0, hi), p))
        out_v.append(torch.where(real, vc, v))
    return torch.stack(out_p), torch.stack(out_v)


def _accel_clamp(a_d, cfg):
    """MAX_A acceleration clamp (src/BasicSPHSolver.cu:159-162)."""
    norm = torch.sqrt(a_d[0] * a_d[0] + a_d[1] * a_d[1] + a_d[2] * a_d[2])
    scale = torch.where(norm > cfg.max_accel,
                        _const(cfg.max_accel, norm)
                        / torch.clamp(norm, min=cfg.epsilon), 1.0)
    return a_d * scale[None]


def _uniform_mass_row(pos_d, cfg):
    """Grid mass row derived from slot occupancy (cfg.uniform_fluid_mass):
    real slots hold exactly the m0 a scattered uniform state.mass would,
    empty slots the 0.0 fill value."""
    return (_real_slot(pos_d).to(F32) * _f32(cfg.m0))[None]


def _pow7(x):
    """x**7 as the products JAX's integer_pow lowers to."""
    x2 = x * x
    return (x * x2) * (x2 * x2)


def _fallback(state: FluidState, cfg, dt):
    """Trajectory for particles that fell out of the grid: gravity + advect
    + clamp (they receive no pair forces — mirrors an isolated particle)."""
    dt32 = np.float32(dt)
    pos, vel = [], []
    for c in range(3):
        v = state.vel[:, c] + _f32(dt32 * np.float32(cfg.gravity[c]))
        p = state.pos[:, c] + dt * v
        hi = _f32(np.float32(0.99) * np.float32(cfg.space_size[c]))
        v = torch.where(p <= 0.0, torch.clamp(v, min=0.0), v)
        v = torch.where(p >= hi, torch.clamp(v, max=0.0), v)
        pos.append(torch.clamp(p, 0.0, hi))
        vel.append(v)
    return torch.stack(pos, 1), torch.stack(vel, 1)


def _merge_back(idx, gathered, fb_pos, fb_vel):
    """gathered: (F>=6, N) rows [pos3, vel3, ...]; invalid particles take the
    fallback trajectory."""
    v = idx.valid[:, None]
    return (torch.where(v, gathered[0:3].T, fb_pos),
            torch.where(v, gathered[3:6].T, fb_vel))


# ----------------------------------------------------------------------
# WCSPH (src/BasicSPHSolver.cu:237-260)
# ----------------------------------------------------------------------

def wcsph_step(state: FluidState, carry, scene_d: DenseScene,
               cfg: SimConfig, dt: float, dims: DenseDims,
               dims_b: DenseDims, box, executor: Optional[pp.Executor] = None):
    """One WCSPH frame over the sliding box of size ``box``. ``executor``
    runs the neighbor passes; None dispatches by device (ops/passes.py)."""
    if not (cfg.surface_tension > cfg.epsilon
            or cfg.air_pressure > cfg.epsilon):
        raise NotImplementedError(
            "WCSPH with surface tension and air pressure off needs "
            "density_visc_pass and pressure_force_pass, not ported yet "
            "(ROADMAP.md Queue 2 item 1d)")
    lo = _layout(state.pos, cfg, dims, dims_b, scene_d, box)
    idx, dims, dims_b, bdx = lo.idx, lo.dims, lo.dims_b, lo.bd
    pads3 = [POS_PAD, POS_PAD, POS_PAD]
    if cfg.uniform_fluid_mass:
        base = lo.fill([state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
                        state.vel[:, 0], state.vel[:, 1], state.vel[:, 2]],
                       pads3 + [0.0] * 3)
        pos_d, vel_d = base[0:3], base[3:6]
        mass_d = _uniform_mass_row(pos_d, cfg)
    else:
        base = lo.fill([state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
                        state.mass, state.vel[:, 0], state.vel[:, 1],
                        state.vel[:, 2]], pads3 + [0.0] * 4)
        pos_d, mass_d, vel_d = base[0:3], base[3:4], base[4:7]

    # Two traversals per frame (vs the reference's 7 neighbor kernels): T1
    # fuses every sum that reads [pos, mass, vel] (rho, color field,
    # viscosity); T2 every sum that also reads fields derived from T1
    # (surface + pressure). Velocity-update order (gravity, viscosity,
    # surface, pressure) matches the reference.
    dt32 = np.float32(dt)
    vel_d = torch.stack([vel_d[c] + _f32(dt32 * np.float32(cfg.gravity[c]))
                         for c in range(3)])
    pmv = torch.cat([pos_d, mass_d, vel_d], 0)
    o = pp.density_colorgrad_visc_pass(pmv, bdx, dims, dims_b, cfg, executor)
    rho = o[0]
    cg = o[1:4] / torch.clamp(o[4], min=cfg.epsilon)[None]
    vel_d = vel_d + o[5:8] * _f32(np.float32(cfg.visc) * dt32)
    p = torch.clamp(cfg.stiff * (_pow7(rho / _const(cfg.rho0, rho)) - 1.0),
                    min=0.0)
    sp = pp.surface_pressure_pass(
        torch.cat([pos_d, mass_d, rho[None], p[None], cg], 0),
        bdx, dims, dims_b, cfg, executor)
    vel_d = vel_d + sp[0:3] * dt
    vel_d = vel_d + _accel_clamp(sp[3:6], cfg) * dt

    pos_d = pos_d + dt * vel_d
    pos_d, vel_d = _clamp_pos_vel(pos_d, vel_d, cfg)

    out = lo.read(torch.cat([pos_d, vel_d, rho[None], p[None]], 0))
    fb_pos, fb_vel = _fallback(state, cfg, dt)
    pos, vel = _merge_back(idx, out, fb_pos, fb_vel)
    new_state = state._replace(pos=pos, vel=vel, density=out[6],
                               pressure=out[7])
    touch = (bdx[0] < POS_GUARD).sum().to(torch.int32)
    return new_state, carry, _base_metrics(idx, touch)


# WCSPH carries no cross-step per-particle state (models/wcsph.py:22-24)
DENSE_STEPS = {"wcsph": wcsph_step}
