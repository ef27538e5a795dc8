"""Neighbor-pass bodies, the plain executor, and the executor dispatch.

Port of the parts of ``cpp_fluid_particles_tpu/ops/pallas_passes.py`` that
the WCSPH main path runs. Each pass is defined by two TERM functions in
vector-component form over pair blocks ``(K_i, K_j, W)`` with the flat cell
axis W minor:

  * ``fluid(i, j)`` — the one-sided fluid-fluid sums, reduced over j;
  * ``bdry(i, jb)`` — the fluid-boundary sums (boundary particles are static
    and receive no forces).

Executors (same signature, ``(name, fl, bd, dims, dims_b, cfg) -> (n_out,
K, G)``):

  * ``column_pass_plain`` — port of ``column_pass_xla`` (pallas_passes.py:287)
    with ``_std_body`` (:780): the plain lane-major 27-offset loop in torch
    ops. It runs on any device; it is the CPU path and the card's oracle.
  * ``column_pass_cuda`` (ops/column_pass_cuda.py) — the hand-written CUDA
    kernel that replaces the Pallas ``column_pass`` (pallas_passes.py:107).

``column_pass`` dispatches by device: CPU tensors take the plain executor,
CUDA tensors the kernel (which raises rather than falls back). Outputs are
zero on ghost cells and on empty i slots, up to the sign of zero.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SimConfig
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
    return torch.sum(x, -2)


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


class PassSpec(NamedTuple):
    fi: int            # fluid field rows read
    n_out: int         # output rows
    terms: Callable    # cfg -> (fluid, bdry)


# the kernel instances of the main path; the CUDA kernel binds one
# template instance per entry
PASSES = {
    "density": PassSpec(4, 1, _density_terms),
    "density_colorgrad_visc": PassSpec(7, 8, _density_colorgrad_visc_terms),
    "surface_pressure": PassSpec(9, 6, _surface_pressure_terms),
}
BOUNDARY_ROWS = 4      # [pos3, mass]


def column_pass_plain(name: str, fl: torch.Tensor, bd: torch.Tensor,
                      dims: DenseDims, dims_b: DenseDims,
                      cfg: SimConfig) -> torch.Tensor:
    """Plain 27-offset lane-major executor: the ghost ring makes every
    stencil offset ONE contiguous slice of the flat cell axis, and the
    pair blocks are (K_i, K_j, W). The i window trims the leading and
    trailing P = flat_p ghost cells; the interior ghost cells compute
    zeros (their slots hold POS_PAD / zero mass), and the trimmed ends are
    padded back with zeros. fl: (Fi, K, G); bd: (Fb, Kb, G) with the same
    ghosted cell geometry."""
    fluid, bdry = PASSES[name].terms(cfg)
    p = dims.flat_p
    w = dims.g - 2 * p
    i_flat = fl[:, :, p:p + w]
    acc = None
    for s in (_flat_offsets(dims) + p).tolist():
        out = fluid(i_flat, fl[:, :, s:s + w]) + bdry(i_flat, bd[:, :, s:s + w])
        acc = out if acc is None else acc + out
    return F.pad(acc, (p, p))


Executor = Callable[..., torch.Tensor]


def column_pass(name: str, fl, bd, dims, dims_b, cfg,
                executor: Optional[Executor] = None) -> torch.Tensor:
    """Run pass ``name``. executor=None dispatches by the device of ``fl``:
    the plain executor on the CPU, the CUDA kernel on a GPU."""
    if executor is None:
        if fl.device.type == "cpu":
            executor = column_pass_plain
        elif fl.device.type == "cuda":
            from .column_pass_cuda import column_pass_cuda
            executor = column_pass_cuda
        else:
            raise ValueError(f"no neighbor-pass executor for {fl.device}")
    return executor(name, fl, bd, dims, dims_b, cfg)


def density_pass(fl, bd, dims, dims_b, cfg, executor=None):
    """fl, bd: [pos3, mass]. Returns the (K, G) density grid."""
    return column_pass("density", fl, bd, dims, dims_b, cfg, executor)[0]


def density_colorgrad_visc_pass(fl, bd, dims, dims_b, cfg, executor=None):
    """fl: [pos3, mass, vel3]; bd: [pos3, mass]. Returns (8, K, G)."""
    return column_pass("density_colorgrad_visc", fl, bd, dims, dims_b, cfg,
                       executor)


def surface_pressure_pass(fl, bd, dims, dims_b, cfg, executor=None):
    """fl: [pos3, mass, rho, p, cg3]; bd: [pos3, mass]. Returns (6, K, G)."""
    return column_pass("surface_pressure", fl, bd, dims, dims_b, cfg,
                       executor)
