"""Sliding-box solver steps — the main path.

Port of the WCSPH, DFSPH and PBD steps of
``cpp_fluid_particles_tpu/models/dense_step.py`` for the default engine
``xlab``: the per-step state lives in the lane-major grid of the fluid's
sliding bounding box (ops/box.py), with one stacked scatter in, every
neighbor pass through ops/passes.py, every intermediate update elementwise
in grid space, and one stacked gather out.

Safety invariants used throughout: empty slots carry POS_PAD positions and
zero masses, so (a) every pair term vanishes against them, and (b) a slot
is "real" iff its x-position is < POS_GUARD, which gates the elementwise
position clamps.

Scalars that JAX computes in float32 from a float32 ``dt`` (``visc*dt``,
``dt*gravity``, the fallback's wall) are computed here on the host with
numpy float32, so both packages multiply by the same float.

DFSPH's two Jacobi loops and PBD's projection loop run on the device in
the JAX package (``lax.while_loop``). Here the host drives them: each loop
condition reads the iteration's error sum (DFSPH, as the reference does
with its ``thrust::reduce``, src/DFSPHSolver.cu:206,360) or its ``alive``
flag (PBD) back to the host, one sync per iteration.

Under a mesh (``parallel.spatial_sharding``) each step runs on this rank's
block of the box (parallel/halo.py; an x-slab on a 1-D mesh): the same
replicated state and box index on every rank, the fill, passes and read on
the rank's window, one ghost exchange before every pass (ops/passes.py),
and every value the host decides on (DFSPH's error sums, PBD's exit flags, the boundary touch
count) reduced so that it is bitwise the single-device value.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import SimConfig
from ..ops import box as bx
from ..ops import passes as pp
from ..ops.dense import (DenseDims, build_dense_index, dims_for, fill_dense,
                         read_dense)
from ..ops.grid import POS_PAD
from ..parallel import halo
from ..parallel.mesh import current_mesh
from ..state import FluidState
from . import dfsph as dfsph_mod
from . import pbd as pbd_mod
from .common import cheb_next

F32 = torch.float32
POS_GUARD = POS_PAD / 2.0


class Layout(NamedTuple):
    """The sliding-box grid layout of one step: the whole box, or under a
    mesh this rank's block of it (parallel/halo.py)."""

    idx: bx.BoxIndex         # the whole box's index (the same on every rank)
    islots: torch.Tensor     # (N,) slot list of this rank's grid
    work: torch.Tensor       # islots in cell-major order: the passes' list
    #                          (surface_pressure takes islots)
    fill: Callable           # (fields, fills) -> stacked grid tensor
    read: Callable           # grid tensor -> (F, N)
    dims: DenseDims          # grid dims for the fluid passes
    dims_b: DenseDims        # grid dims for the boundary window
    bd: torch.Tensor         # boundary window (4, Kb, G)
    slab: Optional[halo.Slab]  # this rank's block, None on one device


def _layout(pos, cfg, dims, dims_b, scene_d, box) -> Layout:
    bdims = DenseDims(box[0], box[1], box[2], dims.k)
    bdims_b = DenseDims(box[0], box[1], box[2], dims_b.k)
    idx = bx.build_box_index(pos, cfg, dims, bdims)
    slab = halo.current_slab()
    if slab is None:
        bdx = bx.slice_boundary_box(scene_d.bd, dims, bdims, idx.origin)
        return Layout(
            idx=idx, islots=idx.slots, work=idx.work,
            fill=lambda fields, fills: bx.fill_box(idx, fields, fills,
                                                   bdims),
            read=lambda arr: bx.read_box(idx, arr),
            dims=bdims, dims_b=bdims_b, bd=bdx, slab=None)
    # every rank built the same index from the same state; it fills,
    # passes and reads its own particles on its window
    islots, work, ldims, ldims_b, bdx = bx.slab_window(
        idx, scene_d.bd, dims, bdims, bdims_b, slab)
    return Layout(
        idx=idx, islots=islots, work=work,
        fill=lambda fields, fills: bx.fill_box(idx._replace(slots=islots),
                                               fields, fills, ldims),
        read=lambda arr: torch.where(
            idx.valid[None, :], halo.read_sharded(arr, islots, slab.mesh),
            0.0),
        dims=ldims, dims_b=ldims_b, bd=bdx, slab=slab)


def _on_slab(step):
    """Under an ambient mesh (``parallel.spatial_sharding``), run ``step``
    on this rank's block of the box of size ``box``, split on every step
    from the box's x and z extents: its layout and every pass it runs see
    the block."""
    @functools.wraps(step)
    def run(state, carry, scene_d, cfg, dt, dims, dims_b, box,
            executor=None):
        mesh = current_mesh()
        if mesh is None:
            return step(state, carry, scene_d, cfg, dt, dims, dims_b, box,
                        executor)
        with halo.slab_context(halo.make_slab(mesh, box[0], box[2])):
            return step(state, carry, scene_d, cfg, dt, dims, dims_b, box,
                        executor)
    return run


def _whole(lo: Layout, x: torch.Tensor) -> torch.Tensor:
    """A grid tensor of the layout -> the whole box's, on every rank."""
    return x if lo.slab is None else halo.whole(x, lo.slab)


def _any(lo: Layout, mask: torch.Tensor) -> torch.Tensor:
    return (torch.any(mask) if lo.slab is None
            else halo.reduce_any(mask, lo.slab))


def _max(lo: Layout, x: torch.Tensor) -> torch.Tensor:
    return torch.max(x) if lo.slab is None else halo.reduce_max(x, lo.slab)


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
    # positions): the W-sum runs boundary-vs-boundary through the fluid
    # slot. The index's slot list names every real slot of fl once, in an
    # interior cell, and marks the rest with the trash value K*G; read_dense
    # reads only those slots back
    zero_bd = fl.clone()
    zero_bd[3] = 0.0
    wsum = pp.density_pass(fl, zero_bd, dims_b, dims_b, cfg, executor,
                           islots=idx.slots)
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


def _clamp_pos_only(pos_d, cfg):
    """Position-only wall clamp, as inside the PBD projection
    (src/PBDSolver.cu:212-223), gated to real slots so padded positions
    stay far away."""
    real = _real_slot(pos_d)
    return torch.stack([
        torch.where(real, torch.clamp(pos_d[c], 0.0,
                                      0.99 * cfg.space_size[c]), pos_d[c])
        for c in range(3)])


def _clamp_pos_vel(pos_d, vel_d, cfg):
    """Wall clamp + inward-velocity zeroing (src/BasicSPHSolver.cu:85-96),
    gated to real slots."""
    real = _real_slot(pos_d)
    out_v = []
    for c in range(3):
        hi = 0.99 * cfg.space_size[c]
        p, v = pos_d[c], vel_d[c]
        vc = torch.where(p <= 0.0, torch.clamp(v, min=0.0), v)
        vc = torch.where(p >= hi, torch.clamp(vc, max=0.0), vc)
        out_v.append(torch.where(real, vc, v))
    return _clamp_pos_only(pos_d, cfg), torch.stack(out_v)


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


def _grav(vel_d, cfg, dt):
    """vel += dt * G (src/BasicSPHSolver.cu:227-235), each product taken
    in float32 as JAX takes it from a float32 dt."""
    dt32 = np.float32(dt)
    return torch.stack([vel_d[c] + _f32(dt32 * np.float32(cfg.gravity[c]))
                        for c in range(3)])


def _visc_dt(cfg, dt) -> float:
    return _f32(np.float32(cfg.visc) * np.float32(dt))


def _surface_on(cfg) -> bool:
    return cfg.surface_tension > cfg.epsilon or cfg.air_pressure > cfg.epsilon


def _rows(x: torch.Tensor):
    """The three columns of an (N, 3) tensor, as rows to scatter."""
    return [x[:, c] for c in range(3)]


def _fill(lo: Layout, state: FluidState, cfg, extra, pads):
    """One scatter of [pos3, (mass), *extra] into the box grid, empty
    slots filled with POS_PAD, 0 and ``pads`` -> (pos_d, mass_d, the extra
    rows). With cfg.uniform_fluid_mass the mass row comes from slot
    occupancy instead of the scatter."""
    rows, extra, pads = _rows(state.pos), list(extra), list(pads)
    if cfg.uniform_fluid_mass:
        base = lo.fill(rows + extra, [POS_PAD] * 3 + pads)
        pos_d = base[0:3]
        return pos_d, _uniform_mass_row(pos_d, cfg), base[3:]
    base = lo.fill(rows + [state.mass] + extra, [POS_PAD] * 3 + [0.0] + pads)
    return base[0:3], base[3:4], base[4:]


def _advect_read(lo: Layout, state: FluidState, cfg, dt, pos_d, vel_d,
                 rows):
    """Advect + wall clamp in grid space, then one gather of [pos3, vel3,
    *rows] -> (pos, vel, the gathered rows); particles out of the grid
    take the fallback trajectory."""
    pos_d = pos_d + dt * vel_d
    pos_d, vel_d = _clamp_pos_vel(pos_d, vel_d, cfg)
    out = lo.read(torch.cat([pos_d, vel_d] + [r[None] for r in rows], 0))
    fb_pos, fb_vel = _fallback(state, cfg, dt)
    pos, vel = _merge_back(lo.idx, out, fb_pos, fb_vel)
    return pos, vel, out[6:]


def _touch(lo: Layout) -> torch.Tensor:
    """Real boundary slots in the box's window."""
    real = lo.bd[0] < POS_GUARD
    n = real.sum() if lo.slab is None else halo.reduce_sum(real, lo.slab)
    return n.to(torch.int32)


def _count(x: int, like: torch.Tensor) -> torch.Tensor:
    """A host count as a 0-d int32 metric on ``like``'s device."""
    return torch.full((), x, dtype=torch.int32, device=like.device)


def _pow7(x):
    """x**7 as the products JAX's integer_pow lowers to."""
    x2 = x * x
    return (x * x2) * (x2 * x2)


def _eos(rho, cfg):
    """Tait pressure, clamped at 0 (src/BasicSPHSolver.cu:103-111)."""
    return torch.clamp(cfg.stiff * (_pow7(rho / _const(cfg.rho0, rho)) - 1.0),
                       min=0.0)


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

@_on_slab
def wcsph_step(state: FluidState, carry, scene_d: DenseScene,
               cfg: SimConfig, dt: float, dims: DenseDims,
               dims_b: DenseDims, box, executor: Optional[pp.Executor] = None):
    """One WCSPH frame over the sliding box of size ``box``. ``executor``
    runs the neighbor passes; None dispatches by device (ops/passes.py)."""
    lo = _layout(state.pos, cfg, dims, dims_b, scene_d, box)
    dims, dims_b, bdx = lo.dims, lo.dims_b, lo.bd
    pos_d, mass_d, vel_d = _fill(lo, state, cfg, _rows(state.vel), [0.0] * 3)

    # Two traversals per frame (vs the reference's 7 neighbor kernels): T1
    # fuses every sum that reads [pos, mass, vel] (rho, color field,
    # viscosity); T2 every sum that also reads fields derived from T1
    # (surface + pressure). Velocity-update order (gravity, viscosity,
    # surface, pressure) matches the reference.
    vel_d = _grav(vel_d, cfg, dt)
    pmv = torch.cat([pos_d, mass_d, vel_d], 0)
    if _surface_on(cfg):
        o = pp.density_colorgrad_visc_pass(pmv, bdx, dims, dims_b, cfg,
                                           executor, islots=lo.work)
        rho = o[0]
        cg = o[1:4] / torch.clamp(o[4], min=cfg.epsilon)[None]
        vel_d = vel_d + o[5:8] * _visc_dt(cfg, dt)
        p = _eos(rho, cfg)
        # the one pass that runs faster on the slots in the particles'
        # order than in cell-major order: through the record kernel, 0.0639
        # against 0.0671 ms a launch, pack included, on the 300-frame WCSPH
        # dam (the particle-list kernel: 0.0723 against 0.0758 ms; CUDA
        # graph, PERF.md section 6)
        sp = pp.surface_pressure_pass(
            torch.cat([pos_d, mass_d, rho[None], p[None], cg], 0),
            bdx, dims, dims_b, cfg, executor, islots=lo.islots)
        vel_d = vel_d + sp[0:3] * dt
        vel_d = vel_d + _accel_clamp(sp[3:6], cfg) * dt
    else:
        o = pp.density_visc_pass(pmv, bdx, dims, dims_b, cfg, executor,
                                 islots=lo.work)
        rho = o[0]
        vel_d = vel_d + o[1:4] * _visc_dt(cfg, dt)
        p = _eos(rho, cfg)
        # no position moved since the fill: the list names every real slot;
        # on a card the pass walks a position pack of its own, one a frame
        a = pp.pressure_force_pass(
            torch.cat([pos_d, mass_d, rho[None], p[None]], 0),
            bdx, dims, dims_b, cfg, executor, islots=lo.work,
            records=pp.SharedPack())
        vel_d = vel_d + _accel_clamp(a, cfg) * dt

    pos, vel, out = _advect_read(lo, state, cfg, dt, pos_d, vel_d, [rho, p])
    new_state = state._replace(pos=pos, vel=vel, density=out[0],
                               pressure=out[1])
    return new_state, carry, _base_metrics(lo.idx, _touch(lo))


# ----------------------------------------------------------------------
# DFSPH (src/DFSPHSolver.cu:33-72)
# ----------------------------------------------------------------------

F32_MAX = float(np.finfo(np.float32).max)


class _Jacobi(NamedTuple):
    """The result of one host-driven Jacobi solve."""

    iters: int
    vel: torch.Tensor
    warm: torch.Tensor       # the accumulated stiffness
    total: torch.Tensor      # the last error sum compared (0-d)
    syncs: int               # error sums read back to the host


def _jacobi(vel, stiff0, correct, error, tau: float, min_iters: int,
            cheb2: float, cfg, whole=lambda err: err) -> _Jacobi:
    """The loop of both DFSPH solves (dense_step.py:426-526 of the JAX
    package): iterate while ``iters < min_iters or total > tau``, at most
    cfg.dfsph_max_iter times. ``total`` is the error sum of the last
    iterate, taken once ``iters >= min_iters``. With cheb2 > 0 the
    velocity iterate is Chebyshev-extrapolated. ``tau`` is a float32
    value: the host compares the float32 sum it reads back exactly.
    ``whole`` maps the error grid to the whole box's (under a mesh), so the
    sum is bitwise the single-device one."""
    v = v_prev = vel
    s = w = stiff0
    omega = np.float32(1.0)
    total = torch.full((), F32_MAX, dtype=vel.dtype, device=vel.device)
    it = syncs = 0
    while it < cfg.dfsph_max_iter:
        if it >= min_iters:
            syncs += 1
            if not total.item() > tau:
                break
        v_new = v + correct(s)
        if cheb2 > 0.0:
            omega = cheb_next(it + 1, omega, cheb2, cfg.chebyshev_start)
            v_new = float(omega) * (v_new - v_prev) + v_prev
            v_prev = v
        v = v_new
        err, s = error(v)
        w = w + s
        it += 1
        if it >= min_iters:
            total = torch.sum(torch.abs(whole(err)))
    return _Jacobi(it, v, w, total, syncs)


@_on_slab
def dfsph_step(state: FluidState, carry: dfsph_mod.DFSPHCarry,
               scene_d: DenseScene, cfg: SimConfig, dt: float,
               dims: DenseDims, dims_b: DenseDims, box,
               executor: Optional[pp.Executor] = None):
    """One DFSPH frame over the sliding box of size ``box``: divergence
    solve, non-pressure forces, density solve with warm start, advect.
    Metrics add the iteration counts and last error sums of both solves,
    and ``host_syncs``, the error sums the loops read back to the host."""
    lo = _layout(state.pos, cfg, dims, dims_b, scene_d, box)
    dims, dims_b, bdx = lo.dims, lo.dims_b, lo.bd
    pos_d, mass_d, rest = _fill(
        lo, state, cfg, _rows(state.vel) + [carry.warm_stiff, carry.div_warm],
        [0.0] * 5)
    vel_d, warm_d, divwarm_d = rest[0:3], rest[3], rest[4]
    pm = torch.cat([pos_d, mass_d], 0)

    # the positions stay fixed through the frame: one position pack serves
    # the surface-off density_alpha and every stiffness_accel of both
    # solves on a card
    pack = pp.SharedPack()
    surface_on = _surface_on(cfg)
    if surface_on:
        # fused traversal: rho/alpha + color-field sums share [pos, mass]
        da = pp.density_alpha_colorgrad_pass(pm, bdx, dims, dims_b, cfg,
                                             executor, islots=lo.work)
        cg = da[5:8] / torch.clamp(da[8], min=cfg.epsilon)[None]
    else:
        # the fill's own grid: the list names every real slot once
        da = pp.density_alpha_pass(pm, bdx, dims, dims_b, cfg, executor,
                                   islots=lo.work, records=pack)
    rho = da[0]
    alpha = _const(-1.0, rho) / torch.clamp(
        da[1] * da[1] + da[2] * da[2] + da[3] * da[3] + da[4],
        min=cfg.epsilon)
    dt_d = _const(dt, rho)
    n = state.n
    whole = functools.partial(_whole, lo)

    def div_pass(v_d):
        return pp.divergence_pass((pm, v_d), bdx, dims, dims_b, cfg,
                                  executor, islots=lo.work)

    def sa_pass(s_d):
        return pp.stiffness_accel_pass((pm, s_d[None]), bdx, dims, dims_b,
                                       cfg, executor, islots=lo.work,
                                       records=pack)

    # --- divergence solve (src/DFSPHSolver.cu:331-363) ---
    def div_error(v_d):
        err = torch.clamp(div_pass(v_d), min=0.0)
        err = torch.where((rho + dt * err < cfg.rho0) & (rho <= cfg.rho0),
                          0.0, err)
        # over-relaxed Jacobi (cfg.dfsph_sor; exact at the fixed point)
        return err, err * alpha * cfg.dfsph_sor

    # optional divergence warm start (cfg.dfsph_warm_divergence > 0; the
    # JAX package's extension — the reference warm-starts only the density
    # solve): last frame's accumulated stiffness before the first error
    if cfg.dfsph_warm_divergence > 0.0:
        vel_d = vel_d + sa_pass(divwarm_d * cfg.dfsph_warm_divergence)
    _, stiff0 = div_error(vel_d)
    cheb2 = float(cfg.dfsph_chebyshev_rho) ** 2
    div = _jacobi(vel_d, stiff0, sa_pass, div_error,
                  _f32(cfg.dfsph_divergence_threshold * n * cfg.rho0), 1,
                  0.0 if cfg.dfsph_cheb_density_only else cheb2, cfg,
                  whole)
    vel_d = div.vel

    # --- non-pressure forces ---
    vel_d = _grav(vel_d, cfg, dt)
    vel_d = vel_d + pp.viscosity_pass(
        (pm, vel_d), dims, cfg, executor,
        islots=lo.work) * _visc_dt(cfg, dt)
    if surface_on:
        # cg came fused with the density/alpha traversal above
        sa = pp.surface_pass(torch.cat([pos_d, mass_d, cg], 0), dims, cfg,
                             executor, islots=lo.work)
        vel_d = vel_d + sa * dt

    # --- density solve with warm start (src/DFSPHSolver.cu:160-210) ---
    def den_error(v_d):
        err = torch.clamp(dt * div_pass(v_d) + rho - cfg.rho0, min=0.0)
        return err, err * alpha * cfg.dfsph_sor

    # warm start applies through the same correction scale as in-loop
    # iterations: vel += a/dt (src/DFSPHSolver.cu correctDensityError_CUDA)
    vel_d = vel_d + sa_pass(warm_d) / dt_d
    _, stiff0 = den_error(vel_d)
    den = _jacobi(vel_d, stiff0, lambda s_d: sa_pass(s_d) / dt_d, den_error,
                  _f32(cfg.dfsph_density_threshold * n * cfg.rho0), 2,
                  cheb2, cfg, whole)

    pos, vel, out = _advect_read(lo, state, cfg, dt, pos_d, den.vel,
                                 [rho, den.warm, div.warm])
    new_state = state._replace(pos=pos, vel=vel, density=out[0])
    new_carry = dfsph_mod.DFSPHCarry(warm_stiff=out[1], div_warm=out[2])

    metrics = {
        **_base_metrics(lo.idx, _touch(lo)),
        "divergence_iters": _count(div.iters, rho),
        "density_iters": _count(den.iters, rho),
        "divergence_error": div.total,
        "density_error": den.total,
        "host_syncs": _count(div.syncs + den.syncs, rho),
    }
    return new_state, new_carry, metrics


# ----------------------------------------------------------------------
# PBD (src/PBDSolver.cu:34-73)
# ----------------------------------------------------------------------

@_on_slab
def pbd_step(state: FluidState, carry: pbd_mod.PBDCarry,
             scene_d: DenseScene, cfg: SimConfig, dt: float,
             dims: DenseDims, dims_b: DenseDims, box,
             executor: Optional[pp.Executor] = None):
    """One PBD frame over the sliding box of size ``box``: constraint
    projection, velocity from the position delta, XSPH viscosity (and the
    surface effects), gravity, advect. Metrics add ``pbd_iters`` and
    ``host_syncs``, the loop conditions read back to the host."""
    lo = _layout(state.pos, cfg, dims, dims_b, scene_d, box)
    dims, dims_b, bdx = lo.dims, lo.dims_b, lo.bd
    warm = cfg.pbd_warm_start > 0.0
    # no velocity rows: the step derives velocity from the position delta
    pos_d, mass_d, rest = _fill(
        lo, state, cfg,
        _rows(carry.pos_last) + (_rows(carry.dp_warm) if warm else []),
        [POS_PAD] * 3 + ([0.0] * 3 if warm else []))
    plast_d, dpw_d = rest[0:3], rest[3:6]

    # warm-start predictor (cfg.pbd_warm_start): start the projection from
    # the advected positions shifted by the carried previous-frame shift
    pos_adv_d = pos_d
    if warm:
        pos_d = _clamp_pos_only(pos_d + cfg.pbd_warm_start * dpw_d, cfg)

    rho0 = _const(cfg.rho0, pos_d)

    def project_once(p_d):
        # one position pack of p_d serves both passes on a card
        pack = pp.SharedPack()
        lam5 = pp.pbd_lambda_pass(torch.cat([p_d, mass_d], 0), bdx, dims,
                                  dims_b, cfg, executor,
                                  islots=lo.work, records=pack)
        rho = lam5[0]
        lam = torch.where(
            rho > cfg.rho0,
            -(rho / rho0 - 1.0)
            / (lam5[1] * lam5[1] + lam5[2] * lam5[2] + lam5[3] * lam5[3]
               + lam5[4] + cfg.epsilon),
            0.0) * cfg.pbd_relaxation
        alive = _any(lo, lam != 0.0)
        if cfg.pbd_density_tolerance > 0.0:
            # the optional convergence exit (the reference always runs the
            # full pbd_max_iter iterations)
            alive = alive & (_max(lo, rho) / rho0 - 1.0
                             > _f32(cfg.pbd_density_tolerance))
        dp = pp.stiffness_accel_pass((p_d, mass_d, lam[None]), bdx, dims,
                                     dims_b, cfg, executor, islots=lo.work,
                                     records=pack) / rho0
        return _clamp_pos_only(p_d + dp, cfg), rho, alive

    # --- projection (src/PBDSolver.cu:225-258), driven by the host: the
    # loop runs while ``it < 1 or alive``, at most pbd_max_iter times,
    # reading ``alive`` back once per test after the first iteration. An
    # all-zero lambda field makes dp exactly 0, so the exit skips only
    # iterations that change nothing. With cfg.pbd_chebyshev_rho > 0 the
    # iterate is Chebyshev-extrapolated from the one before it, where alive.
    cheb = cfg.pbd_chebyshev_rho > 0.0
    rho2 = float(cfg.pbd_chebyshev_rho) ** 2
    p_prev = pos_d
    omega = np.float32(1.0)
    rho = torch.zeros_like(pos_d[0])
    alive = None
    it = syncs = 0
    while it < cfg.pbd_max_iter:
        if it >= 1:
            syncs += 1
            if not bool(alive):
                break
        p_new, rho, alive = project_once(pos_d)
        if cheb:
            omega = cheb_next(it + 1, omega, rho2, cfg.chebyshev_start)
            p_new = _clamp_pos_only(torch.where(
                alive, float(omega) * (p_new - p_prev) + p_prev, p_new), cfg)
            p_prev = pos_d
        pos_d = p_new
        it += 1

    # --- velocity from the position delta (src/PBDSolver.cu:55-60), then
    # XSPH viscosity (:89-125) fused with the color field, then the surface
    # forces from that color field, all over the projected positions (with
    # surface effects off, the fluid-only xsph alone). The slots stay where
    # the fill put them, so the step's slot list still names every real
    # slot once for xsph_colorgrad, surface and xsph alike: a listed slot's
    # x stays below POS_PAD/2 through _clamp_pos_only, and a padding slot's
    # stays POS_PAD ---
    vel_d = (pos_d - plast_d) / _const(dt, pos_d)
    xsph_c = _f32(cfg.pbd_xsph_c / cfg.rho0)
    pmv = torch.cat([pos_d, mass_d, vel_d], 0)
    if _surface_on(cfg):
        o = pp.xsph_colorgrad_pass(pmv, bdx, dims, dims_b, cfg, executor,
                                   islots=lo.work)
        vel_d = vel_d + o[0:3] * xsph_c
        cg = o[3:6] / torch.clamp(o[6], min=cfg.epsilon)[None]
        sa = pp.surface_pass(torch.cat([pos_d, mass_d, cg], 0), dims, cfg,
                             executor, islots=lo.work)
        vel_d = vel_d + sa * dt
    else:
        vel_d = vel_d + pp.xsph_pass(pmv, dims, cfg, executor,
                                     islots=lo.work) * xsph_c
    vel_d = _grav(vel_d, cfg, dt)

    # --- remember + predict (src/PBDSolver.cu:71-79); the warm carry is
    # the total projection shift from this frame's advected positions (the
    # pads cancel to 0 exactly) ---
    plast_d = pos_d
    rows = [rho, *plast_d] + ([*(plast_d - pos_adv_d)] if warm else [])
    pos, vel, out = _advect_read(lo, state, cfg, dt, pos_d, vel_d, rows)
    valid = lo.idx.valid[:, None]
    # particles out of the grid keep their position as pos_last
    pos_last = torch.where(valid, out[1:4].T, state.pos)
    dp_warm = (torch.where(valid, out[4:7].T, 0.0) if warm
               else torch.zeros_like(state.pos))
    new_state = state._replace(pos=pos, vel=vel, density=out[0])
    new_carry = pbd_mod.PBDCarry(pos_last=pos_last, dp_warm=dp_warm)
    metrics = {**_base_metrics(lo.idx, _touch(lo)),
               "pbd_iters": _count(it, rho),
               "host_syncs": _count(syncs, rho)}
    return new_state, new_carry, metrics


# solver name -> step; WCSPH carries nothing across steps
# (models/wcsph.py:22-24), DFSPH its warm starts (models/dfsph.py), PBD
# its last positions and projection shift (models/pbd.py)
DENSE_STEPS = {"wcsph": wcsph_step, "dfsph": dfsph_step, "pbd": pbd_step}
