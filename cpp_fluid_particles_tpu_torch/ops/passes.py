"""Neighbor-pass bodies, the plain executor, and the executor dispatch.

Port of the neighbor passes of
``cpp_fluid_particles_tpu/ops/pallas_passes.py`` that the WCSPH, DFSPH and
PBD steps run, plus ``color_gradient`` and
``density_colorgrad``, which no step runs in either package. Each pass is
defined by two TERM functions in vector-component form over pair blocks
``(K_i, K_j, W)`` with the flat cell axis W minor:

  * ``fluid(i, j)`` — the one-sided fluid-fluid sums, reduced over j;
  * ``bdry(i, jb)`` — the fluid-boundary sums (boundary particles are static
    and receive no forces), or None for a fluid-only pass, which takes no
    boundary operand (``bd=None``, ``dims_b=None``).

Executors (same signature, ``(name, fl, bd, dims, dims_b, cfg,
islots=None) -> (n_out, K, G)``; ``islots`` lists the particles' slots
of fl's grid, the step's ``BoxIndex.work`` (in cell-major order; for
surface_pressure ``BoxIndex.slots``, in the particles' order) or the scene
build's boundary ``DenseIndex.slots``, which the callers of
``PARTICLE_PASSES`` give):

  * ``column_pass_plain`` — port of ``column_pass_xla`` (pallas_passes.py:287)
    with ``_std_body`` (:780): the plain lane-major 27-offset loop in torch
    ops. It runs on any device; it is the CPU path and the card's oracle.
  * ``column_pass_cuda`` (ops/column_pass_cuda.py) — the hand-written CUDA
    kernel that replaces the Pallas ``column_pass`` (pallas_passes.py:107).

``column_pass`` dispatches by device: CPU tensors take the plain executor,
CUDA tensors the kernel (which raises rather than falls back). On a card,
``PARTICLE_PASSES`` (pbd_lambda, stiffness_accel, divergence,
surface_pressure, density_colorgrad_visc, xsph_colorgrad,
density_alpha_colorgrad, density_visc, pressure_force, density_alpha, the
fluid-only viscosity, surface and xsph, and density) take the
particle-list kernel (``column_pass_cuda.particle_pass_cuda``), which
needs ``islots``, but for ``column_pass_cuda.RECORD_IDS`` (surface and
surface_pressure), which take the cell-packed record kernel
(``column_pass_cuda.record_pass_cuda``) over the same list; only
color_gradient and density_colorgrad, which nothing runs, take the column
kernel.
Outputs are zero on ghost cells and on empty i slots, up to the sign of
zero.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SimConfig
from ..parallel import halo
from . import kernels as kn
from .dense import DenseDims

# stencil offsets in the reference's m-loop order (src/BasicSPHSolver.cu:66):
# offset o -> displacement (o//9, o%9//3, o%3) into the ghosted grid;
# o=13 is the self offset.
_OFFS = np.array([(o // 9, (o % 9) // 3, o % 3) for o in range(27)], np.int32)


def _flat_offsets(dims: DenseDims) -> np.ndarray:
    """Flat ghosted-axis displacement of each stencil offset o (o=13 -> 0,
    offset 26-o is the negation)."""
    return ((_OFFS[:, 0] - 1) * dims.gy * dims.gz
            + (_OFFS[:, 1] - 1) * dims.gz + (_OFFS[:, 2] - 1)).astype(
        np.int32)


# pair-block conventions: i fields (K_i, W), j fields (K_j, W), pair block
# (K_i, K_j, W); _si reduces a pair block to i-particle shape
def _ii(v):
    return v[:, None, :]


def _jb(v):
    return v[None, :, :]


def _si(x):
    """Sum a pair block over j as torch.sum does, from +0.0 and in slot
    order, but one elementwise add per slot: each output then depends on
    neither its place in the tensor nor the thread count, so a block's
    window computes bitwise what the whole box computes (torch.sum's CPU
    kernel sums the last elements of a row, and K_j >= 18, in other
    orders)."""
    acc = 0.0 + x[..., 0, :]
    for j in range(1, x.shape[-2]):
        acc = acc + x[..., j, :]
    return acc


class Pair(NamedTuple):
    dx: torch.Tensor   # pair-block i - j separations per component
    dy: torch.Tensor
    dz: torch.Tensor
    r: torch.Tensor


def _geom(i, j) -> Pair:
    """i, j: stacked field tensors whose first three rows are position
    components. Returns pair separations/distance as pair blocks."""
    dx = _ii(i[0]) - _jb(j[0])
    dy = _ii(i[1]) - _jb(j[1])
    dz = _ii(i[2]) - _jb(j[2])
    return Pair(dx, dy, dz, torch.sqrt(dx * dx + dy * dy + dz * dz))


def _colorgrad_terms(j, g, w, cw, rho_ref):
    """He-2014 color-field sums [numx, numy, numz, den] (i side)."""
    volj = _jb(j[3]) / rho_ref
    cj = volj * cw
    return [_si(cj * g.dx), _si(cj * g.dy), _si(cj * g.dz), _si(volj * w)]


# ----------------------------------------------------------------------
# pass term functions. Field rows: positions 0..2, mass 3; extras per pass.
# The boundary operand is always [pos3, mass].
# ----------------------------------------------------------------------

def _density_terms(cfg: SimConfig):
    """rho = sum m_j W (fluid + boundary) — src/BasicSPHSolver.cu:54-83."""
    h = cfg.radius

    def fluid(i, j):
        return torch.stack([_si(_jb(j[3]) * kn.w_cubic(_geom(i, j).r, h))])

    return fluid, fluid


def _density_colorgrad_visc_terms(cfg: SimConfig):
    """rho + color field + Mueller viscosity over [pos3, mass, vel3]
    (pallas_passes.py:1238). Outputs [rho, numx, numy, numz, den, dvx, dvy,
    dvz]; the boundary contributes to rho and the color field only."""
    h = cfg.radius

    def fluid(i, j):
        g = _geom(i, j)
        w = kn.w_cubic(g.r, h)
        cw = kn.grad_w_cubic_coef(g.r, h)
        lap = kn.w_visc_laplacian(g.r, h) / cfg.rho0
        mj = _jb(j[3])
        dv = [_si(mj * (lap * (_jb(j[4 + c]) - _ii(i[4 + c]))))
              for c in range(3)]
        return torch.stack([_si(mj * w)]
                           + _colorgrad_terms(j, g, w, cw, cfg.rho0) + dv)

    def bdry(i, jb):
        g = _geom(i, jb)
        w = kn.w_cubic(g.r, h)
        cw = kn.grad_w_cubic_coef(g.r, h)
        rho = _si(_jb(jb[3]) * w)
        zero = torch.zeros_like(rho)
        return torch.stack([rho]
                           + _colorgrad_terms(jb, g, w, cw, cfg.rho_boundary)
                           + [zero, zero, zero])

    return fluid, bdry


def _surface_pressure_terms(cfg: SimConfig):
    """Surface tension/air pressure (src/BasicSPHSolver.cu:332-370) +
    symmetric pressure accel (ibid:113-165) over [pos3, mass, rho, p, cg3]
    (pallas_passes.py:1316). Outputs [sax, say, saz, pax, pay, paz], pa
    WITHOUT the MAX_A clamp; the boundary contributes to pressure only."""
    h, eps = cfg.radius, cfg.epsilon
    rho0sq = cfg.rho0 * cfg.rho0

    def over(f):
        return f[5] / torch.clamp(f[4] * f[4], min=eps)

    def fluid(i, j):
        g = _geom(i, j)
        cw = kn.grad_w_cubic_coef(g.r, h)
        ci2 = i[6] * i[6] + i[7] * i[7] + i[8] * i[8]
        cj2 = j[6] * j[6] + j[7] * j[7] + j[8] * j[8]
        ni = torch.sqrt(ci2)
        gate_i = _ii(ni / torch.clamp(ni, min=eps))
        st = (0.25 / rho0sq * cfg.surface_tension
              * (_ii(ci2) + _jb(cj2)) * kn.grad_w_surface_coef(g.r, h))
        si = st + (cfg.air_pressure / rho0sq) * gate_i * cw
        ps = (_ii(over(i)) + _jb(over(j))) * cw
        mj = _jb(j[3])
        return torch.stack([
            _si(mj * si * g.dx), _si(mj * si * g.dy), _si(mj * si * g.dz),
            -_si(mj * ps * g.dx), -_si(mj * ps * g.dy), -_si(mj * ps * g.dz),
        ])

    def bdry(i, jb):
        g = _geom(i, jb)
        coefb = -_jb(jb[3]) * _ii(over(i)) * kn.grad_w_cubic_coef(g.r, h)
        pa = [_si(coefb * g.dx), _si(coefb * g.dy), _si(coefb * g.dz)]
        zero = torch.zeros_like(pa[0])
        return torch.stack([zero, zero, zero] + pa)

    return fluid, bdry


def _pressure_force_terms(cfg: SimConfig):
    """Symmetric pressure accel (src/BasicSPHSolver.cu:113-165) over
    [pos3, mass, rho, p] (pallas_passes.py:893), WITHOUT the MAX_A clamp:
    the surface-off WCSPH traversal 2."""
    h, eps = cfg.radius, cfg.epsilon

    def over(f):
        return f[5] / torch.clamp(f[4] * f[4], min=eps)

    def fluid(i, j):
        g = _geom(i, j)
        s = (_ii(over(i)) + _jb(over(j))) * kn.grad_w_cubic_coef(g.r, h)
        mj = _jb(j[3])
        return torch.stack([-_si(mj * (s * g.dx)), -_si(mj * (s * g.dy)),
                            -_si(mj * (s * g.dz))])

    def bdry(i, jb):
        g = _geom(i, jb)
        coefb = -_jb(jb[3]) * _ii(over(i)) * kn.grad_w_cubic_coef(g.r, h)
        return torch.stack([_si(coefb * g.dx), _si(coefb * g.dy),
                            _si(coefb * g.dz)])

    return fluid, bdry


def _viscosity_terms(cfg: SimConfig):
    """Mueller viscosity sums (src/BasicSPHSolver.cu:183-225) over
    [pos3, mass, vel3] (pallas_passes.py:929), fluid only; the caller
    scales by visc*dt."""
    h = cfg.radius

    def fluid(i, j):
        g = _geom(i, j)
        lap = kn.w_visc_laplacian(g.r, h) / cfg.rho0
        mj = _jb(j[3])
        return torch.stack([_si(mj * (lap * (_jb(j[4 + c]) - _ii(i[4 + c]))))
                            for c in range(3)])

    return fluid, None


def _surface_terms(cfg: SimConfig):
    """Surface tension + air pressure accel (src/BasicSPHSolver.cu:332-370)
    over [pos3, mass, cg3] (pallas_passes.py:1013), fluid only."""
    h, eps = cfg.radius, cfg.epsilon
    rho0sq = cfg.rho0 * cfg.rho0

    def fluid(i, j):
        ci2 = i[4] * i[4] + i[5] * i[5] + i[6] * i[6]
        cj2 = j[4] * j[4] + j[5] * j[5] + j[6] * j[6]
        ni = torch.sqrt(ci2)
        gate_i = _ii(ni / torch.clamp(ni, min=eps))
        g = _geom(i, j)
        cw = kn.grad_w_cubic_coef(g.r, h)
        st = (0.25 / rho0sq * cfg.surface_tension
              * (_ii(ci2) + _jb(cj2)) * kn.grad_w_surface_coef(g.r, h))
        si = st + (cfg.air_pressure / rho0sq) * gate_i * cw
        mj = _jb(j[3])
        return torch.stack([_si(mj * si * g.dx), _si(mj * si * g.dy),
                            _si(mj * si * g.dz)])

    return fluid, None


def _alpha_terms(g, w, cw, mj):
    """DFSPH [rho, gsumx, gsumy, gsumz, slam] fluid sums
    (src/DFSPHSolver.cu:212-249); with cw / rho0, PBD's lambda sums over
    fluid and boundary alike."""
    r2c2 = cw * cw * (g.dx * g.dx + g.dy * g.dy + g.dz * g.dz)
    mcj = mj * cw
    return [_si(mj * w), _si(mcj * g.dx), _si(mcj * g.dy), _si(mcj * g.dz),
            _si(mj * mj * r2c2)]


def _alpha_bdry_terms(g, w, cw, mb):
    """The boundary's share of the DFSPH sums: none to slam, which runs
    over fluid neighbors only (pallas_passes.py:1081-1092)."""
    mcb = mb * cw
    rho = _si(mb * w)
    return [rho, _si(mcb * g.dx), _si(mcb * g.dy), _si(mcb * g.dz),
            torch.zeros_like(rho)]


def _density_alpha_terms(cfg: SimConfig):
    """DFSPH density + alpha terms over [pos3, mass] (pallas_passes.py:1047):
    outputs [rho, gsumx, gsumy, gsumz, slam]; the caller computes alpha."""
    h = cfg.radius

    def fluid(i, j):
        g = _geom(i, j)
        return torch.stack(_alpha_terms(g, kn.w_cubic(g.r, h),
                                        kn.grad_w_cubic_coef(g.r, h),
                                        _jb(j[3])))

    def bdry(i, jb):
        g = _geom(i, jb)
        return torch.stack(_alpha_bdry_terms(g, kn.w_cubic(g.r, h),
                                             kn.grad_w_cubic_coef(g.r, h),
                                             _jb(jb[3])))

    return fluid, bdry


def _density_alpha_colorgrad_terms(cfg: SimConfig):
    """DFSPH rho+alpha terms + color field over [pos3, mass]
    (pallas_passes.py:1416): outputs [rho, gsumx, gsumy, gsumz, slam, numx,
    numy, numz, den]."""
    h = cfg.radius

    def fluid(i, j):
        g = _geom(i, j)
        w, cw = kn.w_cubic(g.r, h), kn.grad_w_cubic_coef(g.r, h)
        return torch.stack(_alpha_terms(g, w, cw, _jb(j[3]))
                           + _colorgrad_terms(j, g, w, cw, cfg.rho0))

    def bdry(i, jb):
        g = _geom(i, jb)
        w, cw = kn.w_cubic(g.r, h), kn.grad_w_cubic_coef(g.r, h)
        return torch.stack(_alpha_bdry_terms(g, w, cw, _jb(jb[3]))
                           + _colorgrad_terms(jb, g, w, cw,
                                              cfg.rho_boundary))

    return fluid, bdry


def _divergence_terms(cfg: SimConfig):
    """e = sum_f m_j (v_i - v_j).gradW + sum_b m_b v_i.gradW over
    [pos3, mass, vel3] (src/DFSPHSolver.cu:74-92; pallas_passes.py:1097)."""
    h = cfg.radius

    def fluid(i, j):
        g = _geom(i, j)
        t = kn.grad_w_cubic_coef(g.r, h) * (
            (_ii(i[4]) - _jb(j[4])) * g.dx + (_ii(i[5]) - _jb(j[5])) * g.dy
            + (_ii(i[6]) - _jb(j[6])) * g.dz)
        return torch.stack([_si(_jb(j[3]) * t)])

    def bdry(i, jb):
        g = _geom(i, jb)
        cwb = _jb(jb[3]) * kn.grad_w_cubic_coef(g.r, h)
        return torch.stack([_si(cwb * (_ii(i[4]) * g.dx + _ii(i[5]) * g.dy
                                       + _ii(i[6]) * g.dz))])

    return fluid, bdry


def _stiffness_accel_terms(cfg: SimConfig):
    """a = sum_f m_j (s_i + s_j) gradW + sum_b m_b s_i gradW over
    [pos3, mass, stiff] (src/DFSPHSolver.cu:118-136;
    pallas_passes.py:1124)."""
    h = cfg.radius

    def fluid(i, j):
        g = _geom(i, j)
        s = (_ii(i[4]) + _jb(j[4])) * kn.grad_w_cubic_coef(g.r, h)
        mj = _jb(j[3])
        return torch.stack([_si(mj * (s * g.dx)), _si(mj * (s * g.dy)),
                            _si(mj * (s * g.dz))])

    def bdry(i, jb):
        g = _geom(i, jb)
        coefb = _jb(jb[3]) * _ii(i[4]) * kn.grad_w_cubic_coef(g.r, h)
        return torch.stack([_si(coefb * g.dx), _si(coefb * g.dy),
                            _si(coefb * g.dz)])

    return fluid, bdry


def _density_visc_terms(cfg: SimConfig):
    """rho + Mueller viscosity over [pos3, mass, vel3]
    (pallas_passes.py:1284), the surface-off WCSPH traversal 1: outputs
    [rho, dvx, dvy, dvz]; the boundary contributes to rho only."""
    h = cfg.radius

    def fluid(i, j):
        g = _geom(i, j)
        lap = kn.w_visc_laplacian(g.r, h) / cfg.rho0
        mj = _jb(j[3])
        return torch.stack([_si(mj * kn.w_cubic(g.r, h))]
                           + [_si(mj * (lap * (_jb(j[4 + c]) - _ii(i[4 + c]))))
                              for c in range(3)])

    def bdry(i, jb):
        rho = _si(_jb(jb[3]) * kn.w_cubic(_geom(i, jb).r, h))
        zero = torch.zeros_like(rho)
        return torch.stack([rho, zero, zero, zero])

    return fluid, bdry


def _pbd_lambda_terms(cfg: SimConfig):
    """PBD density + lambda sums over [pos3, mass] (src/PBDSolver.cu:127-168;
    pallas_passes.py:1156-1198): outputs [rho, gsumx, gsumy, gsumz, slam]
    with the gradient divided by rho0. Fluid and boundary take the SAME
    form, slam included (the reference calls one device function for
    both)."""
    h = cfg.radius

    def fluid(i, j):
        g = _geom(i, j)
        return torch.stack(_alpha_terms(
            g, kn.w_cubic(g.r, h), kn.grad_w_cubic_coef(g.r, h) / cfg.rho0,
            _jb(j[3])))

    return fluid, fluid


def _xsph_dv(i, j, g, w):
    """XSPH sums [dvx, dvy, dvz] = sum m_j (v_j - v_i) W (i side)."""
    mj = _jb(j[3])
    return [_si(mj * (w * (_jb(j[4 + c]) - _ii(i[4 + c])))) for c in range(3)]


def _xsph_terms(cfg: SimConfig):
    """XSPH viscosity sums (src/PBDSolver.cu:89-125) over [pos3, mass, vel3]
    (pallas_passes.py:953), fluid only; the caller scales by c/rho0."""
    h = cfg.radius

    def fluid(i, j):
        g = _geom(i, j)
        return torch.stack(_xsph_dv(i, j, g, kn.w_cubic(g.r, h)))

    return fluid, None


def _xsph_colorgrad_terms(cfg: SimConfig):
    """XSPH sums + color field over [pos3, mass, vel3]
    (pallas_passes.py:1377): outputs [dvx, dvy, dvz, numx, numy, numz,
    den]; the boundary contributes to the color field only."""
    h = cfg.radius

    def fluid(i, j):
        g = _geom(i, j)
        w, cw = kn.w_cubic(g.r, h), kn.grad_w_cubic_coef(g.r, h)
        return torch.stack(_xsph_dv(i, j, g, w)
                           + _colorgrad_terms(j, g, w, cw, cfg.rho0))

    def bdry(i, jb):
        g = _geom(i, jb)
        cg = _colorgrad_terms(jb, g, kn.w_cubic(g.r, h),
                              kn.grad_w_cubic_coef(g.r, h), cfg.rho_boundary)
        zero = torch.zeros_like(cg[0])
        return torch.stack([zero, zero, zero] + cg)

    return fluid, bdry


def _color_gradient_terms(cfg: SimConfig):
    """He-2014 color-field sums (src/BasicSPHSolver.cu:277-318) over
    [pos3, mass] (pallas_passes.py:992): outputs [numx, numy, numz, den],
    fluid with rho0 and boundary with rho_boundary."""
    h = cfg.radius

    def terms(rho_ref):
        def body(i, j):
            g = _geom(i, j)
            return torch.stack(_colorgrad_terms(
                j, g, kn.w_cubic(g.r, h), kn.grad_w_cubic_coef(g.r, h),
                rho_ref))
        return body

    return terms(cfg.rho0), terms(cfg.rho_boundary)


def _density_colorgrad_terms(cfg: SimConfig):
    """rho + color field over [pos3, mass] (pallas_passes.py:1207): outputs
    [rho, numx, numy, numz, den], fluid and boundary."""
    h = cfg.radius

    def terms(rho_ref):
        def body(i, j):
            g = _geom(i, j)
            w = kn.w_cubic(g.r, h)
            return torch.stack([_si(_jb(j[3]) * w)] + _colorgrad_terms(
                j, g, w, kn.grad_w_cubic_coef(g.r, h), rho_ref))
        return body

    return terms(cfg.rho0), terms(cfg.rho_boundary)


class PassSpec(NamedTuple):
    fi: int            # fluid field rows read
    n_out: int         # output rows
    terms: Callable    # cfg -> (fluid, bdry)
    has_bd: bool = True  # False: fluid only, no boundary operand


# every instance of the JAX package's column_pass: those of the WCSPH, DFSPH
# and PBD steps, and the two that no step runs; the CUDA kernel binds one
# template instance per entry
PASSES = {
    "density": PassSpec(4, 1, _density_terms),
    "density_colorgrad_visc": PassSpec(7, 8, _density_colorgrad_visc_terms),
    "surface_pressure": PassSpec(9, 6, _surface_pressure_terms),
    "density_alpha_colorgrad": PassSpec(4, 9,
                                        _density_alpha_colorgrad_terms),
    "divergence": PassSpec(7, 1, _divergence_terms),
    "stiffness_accel": PassSpec(5, 3, _stiffness_accel_terms),
    "viscosity": PassSpec(7, 3, _viscosity_terms, has_bd=False),
    "surface": PassSpec(7, 3, _surface_terms, has_bd=False),
    "density_alpha": PassSpec(4, 5, _density_alpha_terms),
    "density_visc": PassSpec(7, 4, _density_visc_terms),
    "pressure_force": PassSpec(6, 3, _pressure_force_terms),
    "pbd_lambda": PassSpec(4, 5, _pbd_lambda_terms),
    "xsph_colorgrad": PassSpec(7, 7, _xsph_colorgrad_terms),
    "xsph": PassSpec(7, 3, _xsph_terms, has_bd=False),
    "color_gradient": PassSpec(4, 4, _color_gradient_terms),
    "density_colorgrad": PassSpec(4, 5, _density_colorgrad_terms),
}
BOUNDARY_ROWS = 4      # [pos3, mass]

# the passes that run, on a card, through the particle-list kernel over a
# slot list (ops/column_pass_cuda.py particle_pass_cuda): the step's, or for
# the scene build's density the boundary grid's own
PARTICLE_PASSES = ("pbd_lambda", "stiffness_accel", "divergence",
                   "surface_pressure", "density_colorgrad_visc",
                   "xsph_colorgrad", "viscosity", "surface",
                   "density_alpha_colorgrad", "density_visc",
                   "pressure_force", "density_alpha", "xsph", "density")

# the bodies of the flat-grid prototype (exp/flat_pallas_proto.py:147-188:
# density_terms, sa_terms, dcv_terms) -> the pass whose fluid half each is;
# each reads that pass's rows (sa reads row 4 as s)
FLAT_BODIES = {"density": "density", "sa": "stiffness_accel",
               "dcv": "density_colorgrad_visc"}


def column_pass_plain(name: str, fl: torch.Tensor,
                      bd: Optional[torch.Tensor], dims: DenseDims,
                      dims_b: Optional[DenseDims],
                      cfg: SimConfig, fluid_only: bool = False,
                      islots: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Plain 27-offset lane-major executor: the ghost ring makes every
    stencil offset ONE contiguous slice of the flat cell axis, and the
    pair blocks are (K_i, K_j, W). The i window trims the leading and
    trailing P = flat_p ghost cells; the interior ghost cells compute
    zeros (their slots hold POS_PAD / zero mass), and the trimmed ends are
    padded back with zeros. fl: (Fi, K, G); bd: (Fb, Kb, G) with the same
    ghosted cell geometry, or None for a fluid-only pass. fluid_only: the
    fluid term alone of a pass that has a boundary term (bd None), as the
    flat prototype's oracle ``xla27`` sums it
    (exp/flat_pallas_proto.py:191-210). ``islots`` (the executor
    protocol's slot list) is ignored: every slot is computed."""
    fluid, bdry = PASSES[name].terms(cfg)
    if fluid_only:
        if bd is not None:
            raise ValueError("column_pass_plain: fluid_only takes no "
                             "boundary operand (bd=None)")
        bdry = None
    p = dims.flat_p
    w = dims.g - 2 * p
    i_flat = fl[:, :, p:p + w]
    acc = None
    for s in (_flat_offsets(dims) + p).tolist():
        out = fluid(i_flat, fl[:, :, s:s + w])
        if bdry is not None:
            out = out + bdry(i_flat, bd[:, :, s:s + w])
        acc = out if acc is None else acc + out
    return F.pad(acc, (p, p))


Executor = Callable[..., torch.Tensor]


def column_pass(name: str, fl, bd, dims, dims_b, cfg,
                executor: Optional[Executor] = None,
                islots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run pass ``name``. ``fl`` is the stacked field grid or a tuple of
    field groups, stacked here (as the JAX package's ``_run`` does).
    executor=None dispatches by the device of ``fl``: the plain executor on
    the CPU, the CUDA kernel on a GPU, and for ``PARTICLE_PASSES`` the
    particle-list kernel over ``islots``, which a GPU then requires.
    ``islots`` is handed on to an executor as a keyword.

    Under a block (``parallel.halo.slab_context``, which the solver steps
    enter under a mesh) ``fl``, ``bd`` and ``islots`` are the rank's
    window: the ghost cells a neighbour owns of a copy of ``fl`` are
    refreshed (``halo.exchange``) before the executor runs, and a rank
    that owns no cell runs nothing and returns zeros."""
    slab = halo.current_slab()
    if isinstance(fl, tuple):
        fl = torch.cat(fl, 0)
    elif slab is not None:
        fl = fl.contiguous().clone()
    if slab is not None:
        if (dims.cx, dims.cz) != (slab.x1 - slab.x0, slab.z1 - slab.z0):
            raise ValueError(f"{name}: dims {tuple(dims)} are not the "
                             f"window of block x [{slab.x0}, {slab.x1}), "
                             f"z [{slab.z0}, {slab.z1})")
        if slab.empty:
            return fl.new_zeros((PASSES[name].n_out, dims.k, dims.g))
        halo.exchange(fl, slab)
    if executor is None:
        if fl.device.type == "cpu":
            executor = column_pass_plain
        elif fl.device.type == "cuda":
            from . import column_pass_cuda as cc
            if name in PARTICLE_PASSES:
                if islots is None:
                    raise ValueError(f"{name} on {fl.device} runs the "
                                     "particle-list kernel, which needs "
                                     "islots")
                run = (cc.record_pass_cuda if name in cc.RECORD_IDS
                       else cc.particle_pass_cuda)
                return run(name, fl, bd, islots, dims, dims_b, cfg)
            executor = cc.column_pass_cuda
        else:
            raise ValueError(f"no neighbor-pass executor for {fl.device}")
    return executor(name, fl, bd, dims, dims_b, cfg, islots=islots)


def flat_pallas_pass(body: str, fl: torch.Tensor, dims: DenseDims,
                     cfg: SimConfig) -> torch.Tensor:
    """Counterpart of the flat-grid prototype's Pallas kernel
    (exp/flat_pallas_proto.py:67): the fluid-only ``body`` (a key of
    FLAT_BODIES) summed one-sided over the 27 offsets of the flat ghosted
    grid, with no boundary operand. ``fl`` (rows, K, G) holds the rows its
    pass reads (density: [pos3, mass]; sa: [pos3, mass, s]; dcv: [pos3,
    mass, vel3]). Returns (n_out, K, G): zero on the first and last
    ``dims.flat_p`` cells, on the other ghost cells and on empty slots.
    Dispatches by the device of ``fl``: the plain executor on the CPU, the
    brick-tiled CUDA kernel (``column_pass_cuda.flat_pass_cuda``, which
    checks its operands) on a GPU."""
    if body not in FLAT_BODIES:
        raise ValueError(f"unknown flat body {body!r}; one of "
                         f"{sorted(FLAT_BODIES)}")
    if fl.device.type == "cuda":
        from .column_pass_cuda import flat_pass_cuda
        return flat_pass_cuda(body, fl, dims, cfg)
    if fl.device.type != "cpu":
        raise ValueError(f"no flat-pass executor for {fl.device}")
    want = (PASSES[FLAT_BODIES[body]].fi, dims.k, dims.g)
    if tuple(fl.shape) != want:
        raise ValueError(f"flat_pallas_pass: {body} takes fl of shape "
                         f"{want}, got {tuple(fl.shape)}")
    return column_pass_plain(FLAT_BODIES[body], fl, None, dims, None, cfg,
                             fluid_only=True)


def density_pass(fl, bd, dims, dims_b, cfg, executor=None, *, islots):
    """fl, bd: [pos3, mass]; islots: the slot list of fl's grid (the scene
    build's boundary ``DenseIndex.slots``). Returns the (K, G) density
    grid."""
    return column_pass("density", fl, bd, dims, dims_b, cfg, executor,
                       islots=islots)[0]


def density_colorgrad_visc_pass(fl, bd, dims, dims_b, cfg, executor=None, *,
                                islots):
    """fl: [pos3, mass, vel3]; bd: [pos3, mass]; islots: the step's
    ``BoxIndex.work``. Returns (8, K, G)."""
    return column_pass("density_colorgrad_visc", fl, bd, dims, dims_b, cfg,
                       executor, islots=islots)


def surface_pressure_pass(fl, bd, dims, dims_b, cfg, executor=None, *,
                          islots):
    """fl: [pos3, mass, rho, p, cg3]; bd: [pos3, mass]; islots: the step's
    ``BoxIndex.slots`` (in the particles' order). Returns (6, K, G)."""
    return column_pass("surface_pressure", fl, bd, dims, dims_b, cfg,
                       executor, islots=islots)


def density_visc_pass(fl, bd, dims, dims_b, cfg, executor=None, *, islots):
    """fl: [pos3, mass, vel3]; bd: [pos3, mass]; islots: the step's
    ``BoxIndex.work``. Returns (4, K, G): [rho, dvx, dvy, dvz]."""
    return column_pass("density_visc", fl, bd, dims, dims_b, cfg, executor,
                       islots=islots)


def pressure_force_pass(fl, bd, dims, dims_b, cfg, executor=None, *,
                        islots):
    """fl: [pos3, mass, rho, p]; bd: [pos3, mass]; islots: the step's
    ``BoxIndex.work``. Returns (3, K, G)."""
    return column_pass("pressure_force", fl, bd, dims, dims_b, cfg,
                       executor, islots=islots)


def density_alpha_pass(fl, bd, dims, dims_b, cfg, executor=None, *, islots):
    """fl, bd: [pos3, mass]; islots: the step's ``BoxIndex.work``. Returns
    (5, K, G): [rho, gsumx, gsumy, gsumz, slam]."""
    return column_pass("density_alpha", fl, bd, dims, dims_b, cfg, executor,
                       islots=islots)


def density_alpha_colorgrad_pass(fl, bd, dims, dims_b, cfg, executor=None, *,
                                 islots):
    """fl, bd: [pos3, mass]; islots: the step's ``BoxIndex.work``. Returns
    (9, K, G): density_alpha's five rows, then [numx, numy, numz, den]."""
    return column_pass("density_alpha_colorgrad", fl, bd, dims, dims_b, cfg,
                       executor, islots=islots)


def divergence_pass(fl, bd, dims, dims_b, cfg, executor=None, *, islots):
    """fl: the field groups ([pos3, mass], vel3); bd: [pos3, mass];
    islots: the step's ``BoxIndex.work``. Returns the (K, G) divergence
    grid."""
    return column_pass("divergence", fl, bd, dims, dims_b, cfg, executor,
                       islots=islots)[0]


def stiffness_accel_pass(fl, bd, dims, dims_b, cfg, executor=None, *,
                         islots):
    """fl: the field groups ([pos3, mass], stiff[None]); bd: [pos3, mass];
    islots: the step's ``BoxIndex.work``. Returns (3, K, G)."""
    return column_pass("stiffness_accel", fl, bd, dims, dims_b, cfg,
                       executor, islots=islots)


def viscosity_pass(fl, dims, cfg, executor=None, *, islots):
    """fl: the field groups ([pos3, mass], vel3); fluid only; islots: the
    step's ``BoxIndex.work``. Returns (3, K, G); the caller scales by
    visc*dt."""
    return column_pass("viscosity", fl, None, dims, None, cfg, executor,
                       islots=islots)


def surface_pass(fl, dims, cfg, executor=None, *, islots):
    """fl: [pos3, mass, cg3]; fluid only; islots: the step's
    ``BoxIndex.work``. Returns (3, K, G)."""
    return column_pass("surface", fl, None, dims, None, cfg, executor,
                       islots=islots)


def pbd_lambda_pass(fl, bd, dims, dims_b, cfg, executor=None, *, islots):
    """fl, bd: [pos3, mass]; islots: the step's ``BoxIndex.work``.
    Returns (5, K, G): [rho, gsumx, gsumy, gsumz, slam]."""
    return column_pass("pbd_lambda", fl, bd, dims, dims_b, cfg, executor,
                       islots=islots)


def xsph_colorgrad_pass(fl, bd, dims, dims_b, cfg, executor=None, *,
                        islots):
    """fl: [pos3, mass, vel3]; bd: [pos3, mass]; islots: the step's
    ``BoxIndex.work``. Returns (7, K, G): [dvx, dvy, dvz, numx, numy,
    numz, den]; the caller scales dv by c/rho0."""
    return column_pass("xsph_colorgrad", fl, bd, dims, dims_b, cfg,
                       executor, islots=islots)


def xsph_pass(fl, dims, cfg, executor=None, *, islots):
    """fl: [pos3, mass, vel3]; fluid only; islots: the step's
    ``BoxIndex.work``. Returns (3, K, G); the caller scales by c/rho0."""
    return column_pass("xsph", fl, None, dims, None, cfg, executor,
                       islots=islots)


def color_gradient_pass(fl, bd, dims, dims_b, cfg, executor=None):
    """fl, bd: [pos3, mass]. Returns (4, K, G): [numx, numy, numz, den]."""
    return column_pass("color_gradient", fl, bd, dims, dims_b, cfg,
                       executor)


def density_colorgrad_pass(fl, bd, dims, dims_b, cfg, executor=None):
    """fl, bd: [pos3, mass]. Returns (5, K, G): [rho, numx, numy, numz,
    den]."""
    return column_pass("density_colorgrad", fl, bd, dims, dims_b, cfg,
                       executor)
