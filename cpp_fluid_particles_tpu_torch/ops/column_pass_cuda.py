"""Binding of the hand-written CUDA neighbor-pass kernel (csrc/column_pass.cu).

The kernel replaces the JAX package's Pallas ``column_pass``
(cpp_fluid_particles_tpu/ops/pallas_passes.py:107). Its source is compiled
by ``nvcc`` for sm_90a into a shared library with a plain C interface, on
first use, into ``_build/`` under this package (ignored by git), keyed by a
hash of the source and the flags, and loaded with ctypes. A missing
``nvcc`` or a failed build raises: there is no fallback.

``column_pass_cuda`` has the executor signature of
``ops.passes.column_pass_plain`` and takes CUDA tensors only.
``particle_pass_cuda`` runs ``passes.PARTICLE_PASSES`` (pbd_lambda,
stiffness_accel, divergence, surface_pressure, density_colorgrad_visc,
xsph_colorgrad, density_alpha_colorgrad, density_visc, pressure_force,
density_alpha, the fluid-only viscosity, surface and xsph, and the scene
build's density) through the particle-list kernel, a group of ``LANES``
lanes per particle of a slot list whose sums one of ``REDUCTIONS``
combines, at the (width, reduction) pairs ``variants`` gives for the pass's
sum count. ``record_pass_cuda`` runs surface and surface_pressure
(``RECORD_IDS``) through the cell-packed record kernel: ``pack_records``
(the pack kernel on a card, ``pack_records_plain`` on the CPU) writes one
record per (cell, slot) of the operand, and the walk reads those records in
the particle-list kernel's groups and order, bitwise its output.
``passes.column_pass`` sends the fourteen passes to one of the two on a
card (``RECORD_IDS`` to the record kernel), so no path launches
``column_pass_cuda``: it stays the yardstick, and the executor of
color_gradient and density_colorgrad, which nothing runs.
``flat_pass_cuda`` runs the fluid-only bodies of exp/flat_pallas_proto.py
(``passes.FLAT_BODIES``) through the brick-tiled kernel that replaces its
``flat_pallas_pass`` (``passes.flat_pallas_pass`` dispatches to it), or
through the untiled kernel as its yardstick.
``LAUNCHES`` counts the launches of each pass instance, of each
particle-list instance (``particle_<name>``), of each record instance's
pack and walk (``pack_<name>``, ``record_<name>``) and of each fluid-only
instance of the prototype's bodies, tiled and untiled.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from ..config import PI, SimConfig
from . import kernels as kn
from .dense import DenseDims
from .grid import POS_PAD
from .passes import BOUNDARY_ROWS, FLAT_BODIES, PARTICLE_PASSES, PASSES

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "column_pass.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# pass name -> template instance in column_pass_launch (csrc/column_pass.cu)
PASS_IDS = {"density": 0, "density_colorgrad_visc": 1, "surface_pressure": 2,
            "density_alpha_colorgrad": 3, "divergence": 4,
            "stiffness_accel": 5, "viscosity": 6, "surface": 7,
            "density_alpha": 8, "density_visc": 9, "pressure_force": 10,
            "pbd_lambda": 11, "xsph_colorgrad": 12, "xsph": 13,
            "color_gradient": 14, "density_colorgrad": 15}

# prototype body -> its id in flat_pass_launch (csrc/column_pass.cu)
FLAT_IDS = {"density": 0, "sa": 1, "dcv": 2}

# bricks of the tiled kernel, the first whose halo'd cells fit shared memory
# wins: shrink along x, then y, keeping the contiguous z-runs long. One block
# per brick, so a smaller brick spreads the occupied cells over more SMs:
# 2x4x4 was the fastest on the frame-150 dam at K 24, 0.62x the time of a
# 4^3 brick, whose 86 busy blocks left SMs idle (PERF.md, kernel table)
BRICKS = ((2, 4, 4), (2, 2, 4), (2, 2, 2))
SHARED_LIMIT = 232_448   # dynamic shared memory of one Hopper block, bytes

# group widths of the particle-list kernel (lanes per particle), the
# default first: 32 lanes (one offset each, 5 idle) took 0.88-0.96x the
# time of 8 or 16 for pbd_lambda, stiffness_accel, divergence, viscosity
# and surface on the full dam at K 16-18, with the slot list in the
# particles' order (divergence: 0.0591 ms at W 32, 0.0652 at W 8, 0.0668
# at W 16; viscosity: 0.0598 at W 32, 0.0624 at W 8, 0.0630 at W 16,
# butterfly; PERF.md, kernel table)
LANES = (32, 8, 16)

# passes whose default width is not LANES[0]: surface_pressure, 6 sums
# that each group's butterfly reduces, took 0.0754 ms at W 8 against 0.0841
# at W 16 and 0.0865 at W 32 on the full dam at K 22, in both runs of each
# width in one call; density_visc (4 sums) on the WCSPH dam at K 22 took
# 0.0608 ms at W 16 (transpose; butterfly 0.0611) against 0.0613 / 0.0624
# at W 8 and 0.0660 / 0.0671 at W 32 (transpose / butterfly); on DFSPH's
# state at K 16, where it never runs, W 8 and 32 led by 2-3%; the
# surface-off pressure_force (3 sums, the WCSPH dam at K 22) took 0.0618
# and 0.0610 ms at W 8 (transpose) in two calls, against 0.0619-0.0623 at
# W 16 and 0.0625-0.0634 at W 32, where it alone does not spill (PERF.md,
# kernel table). With the slot list in cell-major order (BoxIndex.work),
# the four particles of a warp at W 8 mostly share a cell and so read the
# same neighbour slots: divergence (DFSPH's 300-frame state, K 16) took
# 0.0470 ms at W 8 against 0.0493 at W 32 and 0.0496 at W 16, and 1.149
# against 1.799 at W 32 on the 1M recipe's state; density_colorgrad_visc
# (WCSPH's, K 22) 0.0611 at W 8 (butterfly) against 0.0622 transposed and
# 0.0747 at its former W 32 transposed (CUDA-graph ms, best of two, one
# call; PERF.md section 6)
PASS_LANES = {"surface_pressure": 8, "density_visc": 16,
              "pressure_force": 8, "divergence": 8,
              "density_colorgrad_visc": 8}

# how the particle-list kernel reduces a group's sums, as its template
# argument kTranspose: "butterfly", xor adds of every sum at every step
# (kOut * log2 W shuffles per lane), or "transpose", each step halving the
# sums a lane holds (S - 1 + log2(W/S) shuffles, S the sums padded to a
# power of two); csrc/column_pass.cu says how
REDUCTIONS = ("butterfly", "transpose")

# passes whose default reduction is not REDUCTIONS[0]: on the full dam
# (K 22 and 18), both runs of each in one call, xsph_colorgrad (7 sums)
# took 0.0734 ms transposed at W 32 against the butterfly's 0.0758 (its
# best butterfly, W 8: 0.0747); for surface_pressure (6 sums) the transpose
# was no faster at any width (W 8 0.0765 against 0.0755; PERF.md, kernel
# table). The fluid-only surface (3 sums, K 16) took 0.0605 ms
# transposed at W 32 against the butterfly's
# 0.0632 (W 8: 0.0665 / 0.0674, W 16: 0.0680 / 0.0682); for viscosity (3
# sums, K 16) the two tied at W 32 (0.0599 / 0.0598), so it keeps the
# butterfly. density_alpha_colorgrad (9 sums, K 16; the transpose only at
# W 16 and 32) took 0.0625 transposed at W 32 against the butterfly's
# 0.0655 (W 16: 0.0661 / 0.0683, butterfly W 8 0.0654); density_visc
# (4 sums) the transpose by a hair at its W 16 (0.0608 / 0.0611). The
# surface-off density_alpha (5 sums, DFSPH's state at K 16) took 0.0565 ms
# transposed at W 32 against the butterfly's 0.0581 (W 8: 0.0598 / 0.0599,
# W 16: 0.0609 / 0.0614, transpose / butterfly), and pressure_force (3
# sums) 0.0618 / 0.0610 transposed at its W 8 against the butterfly's
# 0.0620 / 0.0623, two calls. In two calls, the fluid-only xsph (3 sums,
# one surface-off PBD step from the 300-frame parity state, K 18) took
# 0.0526 and 0.0522 ms transposed at W 32 against the butterfly's 0.0531
# and 0.0528 (W 16: 0.0560, 0.0553 / 0.0560, 0.0554; W 8: 0.0575, 0.0565
# / 0.0566, 0.0564, transpose / butterfly); the scene build's density (1
# sum, the boundary grid, Kb 7, 14,408 listed slots) 0.0400 and 0.0410
# transposed at W 32 against the butterfly's 0.0404 and 0.0410 (W 16:
# 0.0394, 0.0416 / 0.0426, 0.0411; W 8: 0.0415, 0.0413 / 0.0439, 0.0418),
# each pair spreading 10-20% run to run, so it keeps W 32, where it alone
# does not spill (W 8 and 16 spill 32 B)
PASS_REDUCTION = {"xsph_colorgrad": "transpose", "surface": "transpose",
                  "density_alpha_colorgrad": "transpose",
                  "density_visc": "transpose", "density_alpha": "transpose",
                  "pressure_force": "transpose", "xsph": "transpose",
                  "density": "transpose"}

# launches per pass instance, per particle-list instance (particle_<name>),
# and per fluid-only instance of the prototype's bodies (flat_<body>: the
# tiled kernel; untiled_<body>: column_pass_kernel); bumped once per
# successful launch
# pass name -> its id in pack_records_launch and record_pass_launch
# (csrc/column_pass.cu): the passes the cell-packed record kernel serves
RECORD_IDS = {"surface_pressure": 2, "surface": 7}

# slots a batch of the record kernel's walk loads before it tests the
# first for padding (batches of 4 lost to both on every dam state: PERF.md
# section 6)
UNROLLS = (1, 2)

# the record kernel's (lanes, reduction, unroll) per pass. On the 300-frame
# dam states (NVIDIA H100 80GB HBM3, 700 W; CUDA graph, pack included,
# best of two; PERF.md section 6), surface took 0.0490 ms on DFSPH's (K
# 16) and on PBD's (K 18) at W 8 transposed, unroll 1 (butterfly 0.0489 /
# 0.0496, unroll 2 0.0495 / 0.0497, W 32 0.0535 / 0.0539) against the
# particle-list kernel's 0.0547 / 0.0549 at its default, W 32 transposed
# (0.0499 / 0.0512 at W 8 transposed); surface_pressure (WCSPH's, K 22)
# 0.0639 at W 8 butterfly, unroll 2, in the particles' order (unroll 1
# 0.0661, transposed 0.0649, cell-major 0.0672) against the particle-list
# kernel's 0.0652 at its default, W 8 butterfly (0.0638 at W 8
# transposed). Unroll 4 lost to both unrolls on every state.
RECORD_DEFAULTS = {"surface": (8, "transpose", 1),
                   "surface_pressure": (8, "butterfly", 2)}

LAUNCHES = {name: 0 for name in PASS_IDS}
LAUNCHES.update({f"particle_{name}": 0 for name in PARTICLE_PASSES})
LAUNCHES.update({f"{kind}_{name}": 0 for kind in ("pack", "record")
                 for name in RECORD_IDS})
LAUNCHES.update({f"{kind}_{body}": 0 for kind in ("flat", "untiled")
                 for body in FLAT_IDS})


def variants(name: str) -> tuple:
    """The (lanes, reduction) pairs the particle-list kernel takes for pass
    ``name``, in the order of LANES and REDUCTIONS: the butterfly at every
    width, the transpose only where the pass's sums, padded to a power of
    two, fit the group, since it leaves each lane one sum (9 sums pad to
    16: W 16 and 32 only). csrc/column_pass.cu:launch_reduction
    instantiates the same pairs."""
    padded = 1 << (PASSES[name].n_out - 1).bit_length()
    return tuple((lanes, red) for lanes in LANES for red in REDUCTIONS
                 if red == "butterfly" or padded <= lanes)


def default_lanes(name: str) -> int:
    """The group width the particle-list kernel runs pass ``name`` at."""
    return PASS_LANES.get(name, LANES[0])


def default_reduction(name: str) -> str:
    """The reduction the particle-list kernel runs pass ``name`` with."""
    return PASS_REDUCTION.get(name, REDUCTIONS[0])


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "neighbor-pass kernel cannot be built")
    return path


def build() -> Path:
    """Compile csrc/column_pass.cu unless a library for this exact source
    and flags exists; return the library's path. The compiler's output
    (ptxas register and spill report) is kept beside it as ``.log``."""
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"column_pass_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.column_pass_launch
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ci, vp, vp, vp, ci, ci, ci, ci, ci, vp, ci, ci, vp]
    fn.restype = ci
    fn = lib.flat_pass_launch
    fn.argtypes = [ci, ci, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp, ci, ci,
                   vp]
    fn.restype = ci
    fn = lib.particle_pass_launch
    fn.argtypes = [ci, ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp,
                   ci, ci, vp]
    fn.restype = ci
    fn = lib.pack_records_launch
    fn.argtypes = [ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp, ci, ci,
                   vp]
    fn.restype = ci
    fn = lib.record_pass_launch
    fn.argtypes = [ci, ci, ci, ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                   ci, vp, ci, ci, vp]
    fn.restype = ci
    return lib


def _consts(cfg: SimConfig):
    """Kernel constants in the order of csrc/column_pass.cu:Consts,
    computed in double as the Python passes compute them."""
    h, rho0sq = cfg.radius, cfg.rho0 * cfg.rho0
    vals = [h, kn.EPS, cfg.epsilon, PI, 0.25 / (PI * h * h * h), h ** 5,
            PI * h ** 6, PI * h ** 9, 0.0156 * h ** 6, cfg.rho0,
            cfg.rho_boundary, 0.25 / rho0sq * cfg.surface_tension,
            cfg.air_pressure / rho0sq, POS_PAD / 2.0, (h * (1 + 1e-4)) ** 2]
    return (ctypes.c_float * len(vals))(*vals)


def _check(t: torch.Tensor, what: str, shape,
           fn: str = "column_pass_cuda") -> None:
    if not t.is_cuda:
        raise ValueError(f"{fn}: {what} is on {t.device}, not a CUDA device")
    if t.dtype != torch.float32:
        raise ValueError(f"{fn}: {what} is {t.dtype}, not float32")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {what} is not contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"{fn}: {what} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def _check_operands(fn: str, name: str, fl: torch.Tensor,
                    bd: Optional[torch.Tensor], dims: DenseDims,
                    dims_b: Optional[DenseDims]):
    """Check pass ``name``'s grids -> (boundary pointer or None, Kb)."""
    spec = PASSES[name]
    _check(fl, "fl", (spec.fi, dims.k, dims.g), fn)
    if spec.has_bd != (bd is not None):
        raise ValueError(f"{fn}: pass {name} takes "
                         + ("a boundary operand" if spec.has_bd
                            else "no boundary operand (bd=None)"))
    if bd is None:
        return None, 0
    if dims_b[:3] != dims[:3]:
        raise ValueError(f"{fn}: fluid and boundary grids must share the "
                         "ghosted cell geometry")
    _check(bd, "bd", (BOUNDARY_ROWS, dims_b.k, dims.g), fn)
    if bd.device != fl.device:
        raise ValueError(f"{fn}: fl and bd on different devices")
    return bd.data_ptr(), dims_b.k


def column_pass_cuda(name: str, fl: torch.Tensor,
                     bd: Optional[torch.Tensor], dims: DenseDims,
                     dims_b: Optional[DenseDims], cfg: SimConfig,
                     islots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch pass ``name`` on ``fl`` (Fi, K, G) and ``bd`` (4, Kb, G) on
    the current stream of their device; returns (n_out, K, G). A
    fluid-only pass (``has_bd`` False) takes ``bd=None, dims_b=None``, and
    the kernel gets a null boundary pointer and Kb = 0. ``islots``, the
    executor protocol's slot list, is ignored: this kernel walks every
    slot of the grid."""
    spec = PASSES[name]
    bd_ptr, kb = _check_operands("column_pass_cuda", name, fl, bd, dims,
                                 dims_b)
    out = torch.empty((spec.n_out, dims.k, dims.g), dtype=torch.float32,
                      device=fl.device)
    consts = _consts(cfg)
    stream = torch.cuda.current_stream(fl.device).cuda_stream
    err = _library().column_pass_launch(
        PASS_IDS[name], fl.data_ptr(), bd_ptr, out.data_ptr(), dims.k, kb,
        dims.gx, dims.gy, dims.gz, consts, len(consts), fl.device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"column_pass_cuda: launching {name} failed "
                           f"with CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def _group(fn: str, name: str, lanes: Optional[int],
           reduction: Optional[str], islots: torch.Tensor, defaults):
    """The (lanes, reduction) a group kernel runs pass ``name`` at
    (``defaults`` where None), refused outside ``variants(name)``, after
    checking that ``islots`` is 1-D, int64 and contiguous."""
    lanes = defaults[0] if lanes is None else lanes
    if lanes not in LANES:
        raise ValueError(f"{fn}: lanes {lanes} is not one of {LANES}")
    reduction = defaults[1] if reduction is None else reduction
    if reduction not in REDUCTIONS:
        raise ValueError(f"{fn}: reduction {reduction!r} is not one of "
                         f"{REDUCTIONS}")
    if (lanes, reduction) not in variants(name):
        raise ValueError(f"{fn}: pass {name} has {PASSES[name].n_out} sums, "
                         f"too many for the {reduction} reduction at {lanes} "
                         f"lanes; its variants are {variants(name)}")
    if islots.dtype != torch.int64 or islots.dim() != 1:
        raise ValueError(f"{fn}: islots must be 1-D int64, got "
                         f"{islots.dtype} of shape {tuple(islots.shape)}")
    if not islots.is_contiguous():
        raise ValueError(f"{fn}: islots is not contiguous")
    return lanes, reduction


def particle_pass_cuda(name: str, fl: torch.Tensor,
                       bd: Optional[torch.Tensor], islots: torch.Tensor,
                       dims: DenseDims, dims_b: Optional[DenseDims],
                       cfg: SimConfig,
                       lanes: Optional[int] = None,
                       reduction: Optional[str] = None) -> torch.Tensor:
    """Pass ``name`` (one of ``passes.PARTICLE_PASSES``) through the
    particle-list kernel on the current stream of ``fl``'s device: a group
    of ``lanes`` lanes (one of LANES; default ``default_lanes(name)``) for
    each particle of ``islots``, the step's ``BoxIndex.work`` or the
    scene's boundary ``DenseIndex.slots`` ((N,) int64 into the flat (K, G)
    slot axis, K*G for an invalid particle), its sums
    combined by ``reduction`` (one of REDUCTIONS; default
    ``default_reduction(name)``); a pair outside ``variants(name)`` is
    refused before anything runs. A fluid-only pass (``has_bd`` False)
    takes ``bd=None, dims_b=None``, and the kernel gets a null boundary
    pointer and Kb = 0; a boundary operand where a pass takes none, or
    none where it takes one, is refused. Returns (n_out, K, G), zeroed by one
    memset before the launch (it counts in the kernel's time): the kernel
    writes only the listed slots. Counted as ``particle_<name>``."""
    fn = "particle_pass_cuda"
    if name not in PARTICLE_PASSES:
        raise ValueError(f"{fn}: pass {name!r} has no particle-list kernel; "
                         f"one of {PARTICLE_PASSES}")
    lanes, reduction = _group(fn, name, lanes, reduction, islots,
                              (default_lanes(name), default_reduction(name)))
    bd_ptr, kb = _check_operands(fn, name, fl, bd, dims, dims_b)
    if islots.device != fl.device:
        raise ValueError(f"{fn}: islots is on {islots.device}, fl on "
                         f"{fl.device}")
    out = torch.zeros((PASSES[name].n_out, dims.k, dims.g),
                      dtype=torch.float32, device=fl.device)
    n = islots.shape[0]
    if n == 0:
        return out
    consts = _consts(cfg)
    stream = torch.cuda.current_stream(fl.device).cuda_stream
    err = _library().particle_pass_launch(
        PASS_IDS[name], lanes, REDUCTIONS.index(reduction), fl.data_ptr(),
        bd_ptr, islots.data_ptr(), out.data_ptr(), n, dims.k, kb, dims.gx,
        dims.gy, dims.gz, consts, len(consts), fl.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launching {name} with {lanes} lanes and "
                           f"the {reduction} reduction failed with CUDA "
                           f"error {err}")
    LAUNCHES[f"particle_{name}"] += 1
    return out


class Records(NamedTuple):
    """The cell-packed records of one pass operand, slot s of cell c at
    row c*K + s (boundary c*Kb + s)."""
    geo: torch.Tensor             # (G*K, 4) [x, y, z, m]
    side: torch.Tensor            # (G*K,) |cg|^2, or (G*K, 2) with p/rho^2
    bgeo: Optional[torch.Tensor]  # (G*Kb, 4) the boundary's, or None


def _side_plain(name: str, fl: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """The slots' j side as the plain pass bodies form it (ops/passes.py
    _surface_terms, _surface_pressure_terms): (1, K, G) |cg|^2, and for
    surface_pressure (2, K, G) with p / max(eps, rho^2)."""
    row = 4 if name == "surface" else 6
    c2 = fl[row] * fl[row] + fl[row + 1] * fl[row + 1] \
        + fl[row + 2] * fl[row + 2]
    if name == "surface":
        return c2[None]
    return torch.stack([c2, fl[5] / torch.clamp(fl[4] * fl[4],
                                                min=cfg.epsilon)])


def _cell_major(x: torch.Tensor) -> torch.Tensor:
    """(rows, K, G) -> (G*K, rows): slot s of cell c at row c*K + s."""
    return x.permute(2, 1, 0).reshape(-1, x.shape[0]).contiguous()


def pack_records_plain(name: str, fl: torch.Tensor,
                       bd: Optional[torch.Tensor], cfg: SimConfig) -> Records:
    """The records of pass ``name`` (one of RECORD_IDS) in torch ops: what
    the pack kernel writes, bitwise on a card (its |cg|^2 is rounded as
    here, never contracted)."""
    side = _cell_major(_side_plain(name, fl, cfg))
    return Records(_cell_major(fl[:4]),
                   side[:, 0].contiguous() if name == "surface" else side,
                   None if bd is None else _cell_major(bd))


def pack_records(name: str, fl: torch.Tensor, bd: Optional[torch.Tensor],
                 dims: DenseDims, dims_b: Optional[DenseDims],
                 cfg: SimConfig) -> Records:
    """The cell-packed records of pass ``name`` (one of RECORD_IDS) from its
    operand ``fl`` (Fi, K, G) and, for surface_pressure, the boundary
    window ``bd`` (4, Kb, G), every (cell, slot) of the ghosted grid: on
    the CPU ``pack_records_plain``; on a card the pack kernel, one launch
    on the current stream into buffers from ``torch.empty`` (no sync, so a
    CUDA graph can hold it), counted as ``pack_<name>``."""
    fn = "pack_records"
    if name not in RECORD_IDS:
        raise ValueError(f"{fn}: pass {name!r} has no record kernel; one of "
                         f"{tuple(RECORD_IDS)}")
    if fl.device.type == "cpu":
        want = (PASSES[name].fi, dims.k, dims.g)
        if tuple(fl.shape) != want or (bd is None) == PASSES[name].has_bd:
            raise ValueError(f"{fn}: {name} takes fl of shape {want}"
                             + (" and a boundary operand"
                                if PASSES[name].has_bd else " alone"))
        return pack_records_plain(name, fl, bd, cfg)
    bd_ptr, kb = _check_operands(fn, name, fl, bd, dims, dims_b)
    return _pack(name, fl, bd_ptr, dims, kb, _consts(cfg),
                 torch.cuda.current_stream(fl.device).cuda_stream)


def _pack(name, fl, bd_ptr, dims, kb, consts, stream) -> Records:
    """The pack kernel on checked operands."""
    n = dims.g * dims.k
    geo = torch.empty((n, 4), dtype=torch.float32, device=fl.device)
    side = torch.empty((n,) if name == "surface" else (n, 2),
                       dtype=torch.float32, device=fl.device)
    bgeo = None if bd_ptr is None else torch.empty(
        (dims.g * kb, 4), dtype=torch.float32, device=fl.device)
    err = _library().pack_records_launch(
        RECORD_IDS[name], fl.data_ptr(), bd_ptr, geo.data_ptr(),
        side.data_ptr(), None if bgeo is None else bgeo.data_ptr(), dims.k,
        kb, dims.gx, dims.gy, dims.gz, consts, len(consts), fl.device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"pack_records: packing {name} failed with CUDA "
                           f"error {err}")
    LAUNCHES[f"pack_{name}"] += 1
    return Records(geo, side, bgeo)


def _check_records(fn: str, name: str, recs: Records, fl: torch.Tensor,
                   dims: DenseDims, dims_b: Optional[DenseDims]) -> None:
    """Check records handed to the walk against pass ``name``'s grids: the
    walk indexes them by the grids' K, Kb and G, so a pack of another pass,
    K or window would send it out of bounds."""
    n = dims.g * dims.k
    want = {"geo": (n, 4), "side": (n,) if name == "surface" else (n, 2),
            "bgeo": None}
    if PASSES[name].has_bd:
        want["bgeo"] = (dims.g * (dims_b.k if dims_b is not None else 0), 4)
    for what, shape in want.items():
        t = getattr(recs, what)
        if t is None and shape is None:
            continue
        if t is None or shape is None:
            got = "None" if t is None else "given"
            raise ValueError(f"{fn}: records.{what} is {got}; {name} takes "
                             f"{shape}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{fn}: records.{what} has shape "
                             f"{tuple(t.shape)}, expected {shape} for {name}"
                             f" at K {dims.k}, G {dims.g}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{fn}: records.{what} is not contiguous "
                             "float32")
        if t.device != fl.device:
            raise ValueError(f"{fn}: records.{what} is on {t.device}, fl on "
                             f"{fl.device}")


def record_pass_cuda(name: str, fl: torch.Tensor, bd: Optional[torch.Tensor],
                     islots: torch.Tensor, dims: DenseDims,
                     dims_b: Optional[DenseDims], cfg: SimConfig,
                     lanes: Optional[int] = None,
                     reduction: Optional[str] = None,
                     unroll: Optional[int] = None,
                     records: Optional[Records] = None) -> torch.Tensor:
    """Pass ``name`` (one of RECORD_IDS) through the cell-packed record
    kernel on the current stream of ``fl``'s device: ``pack_records`` of
    ``fl`` and ``bd`` (unless ``records``, checked against the grids, hands
    them in), then the walk, a group of ``lanes`` lanes per particle of
    ``islots`` reduced by ``reduction`` as ``particle_pass_cuda`` takes
    them, loading ``unroll`` (one of UNROLLS; default the pass's in
    RECORD_DEFAULTS) slots' records a batch. Returns
    (n_out, K, G), zeroed by one memset before the walk, which writes only
    the listed slots; the walk is counted as ``record_<name>``."""
    fn = "record_pass_cuda"
    if name not in RECORD_IDS:
        raise ValueError(f"{fn}: pass {name!r} has no record kernel; one of "
                         f"{tuple(RECORD_IDS)}")
    lanes, reduction = _group(fn, name, lanes, reduction, islots,
                              RECORD_DEFAULTS[name])
    unroll = RECORD_DEFAULTS[name][2] if unroll is None else unroll
    if unroll not in UNROLLS:
        raise ValueError(f"{fn}: unroll {unroll} is not one of {UNROLLS}")
    if records is not None:
        _check_records(fn, name, records, fl, dims, dims_b)
    bd_ptr, kb = _check_operands(fn, name, fl, bd, dims, dims_b)
    if islots.device != fl.device:
        raise ValueError(f"{fn}: islots is on {islots.device}, fl on "
                         f"{fl.device}")
    consts = _consts(cfg)
    stream = torch.cuda.current_stream(fl.device).cuda_stream
    if records is None:
        records = _pack(name, fl, bd_ptr, dims, kb, consts, stream)
    out = torch.zeros((PASSES[name].n_out, dims.k, dims.g),
                      dtype=torch.float32, device=fl.device)
    n = islots.shape[0]
    if n == 0:
        return out
    err = _library().record_pass_launch(
        RECORD_IDS[name], lanes, REDUCTIONS.index(reduction), unroll,
        records.geo.data_ptr(), records.side.data_ptr(),
        None if records.bgeo is None else records.bgeo.data_ptr(),
        islots.data_ptr(), out.data_ptr(), n, dims.k, kb, dims.gx, dims.gy,
        dims.gz, consts, len(consts), fl.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: launching {name} with {lanes} lanes, the "
                           f"{reduction} reduction and unroll {unroll} failed "
                           f"with CUDA error {err}")
    LAUNCHES[f"record_{name}"] += 1
    return out


def brick_bytes(rows: int, k: int, brick) -> int:
    """Shared bytes of the tiled kernel on ``brick``: rows x K slots x the
    brick's halo'd cells, plus one occupancy count per halo cell, 4 bytes
    each."""
    cells = 1
    for d in brick:
        cells *= d + 2
    return (rows * k + 1) * cells * 4


def flat_brick(rows: int, k: int):
    """-> (brick, shared bytes) of the tiled kernel for a body that stages
    ``rows`` rows of K = ``k`` slots: the first of BRICKS that fits. Raises
    ValueError when not even the smallest brick fits."""
    for brick in BRICKS:
        nbytes = brick_bytes(rows, k, brick)
        if nbytes <= SHARED_LIMIT:
            return brick, nbytes
    raise ValueError(
        f"flat_pass_cuda: {rows} rows x K={k} slots do not fit "
        f"{SHARED_LIMIT} bytes of shared memory even with brick "
        f"{BRICKS[-1]}")


def flat_pass_cuda(body: str, fl: torch.Tensor, dims: DenseDims,
                   cfg: SimConfig, tiled: bool = True,
                   brick=None) -> torch.Tensor:
    """The prototype's fluid-only ``body`` (``passes.FLAT_BODIES``) over
    ``fl`` (rows, K, G), exactly the rows its pass reads, on the current
    stream of its device; returns (n_out, K, G). tiled: the brick kernel
    (counted as ``flat_<body>``) on ``brick``, one of BRICKS (default: the
    first that fits, ``flat_brick``); else the untiled column_pass_kernel on
    the same functor (``untiled_<body>``)."""
    spec = PASSES[FLAT_BODIES[body]]
    _check(fl, "fl", (spec.fi, dims.k, dims.g), "flat_pass_cuda")
    if not tiled:
        brick = (0, 0, 0)
    elif brick is None:
        brick = flat_brick(spec.fi, dims.k)[0]
    elif tuple(brick) not in BRICKS:
        raise ValueError(f"flat_pass_cuda: brick {brick} is not one of "
                         f"{BRICKS}")
    elif brick_bytes(spec.fi, dims.k, brick) > SHARED_LIMIT:
        raise ValueError(f"flat_pass_cuda: brick {brick} at K={dims.k} does "
                         f"not fit {SHARED_LIMIT} bytes of shared memory")
    out = torch.empty((spec.n_out, dims.k, dims.g), dtype=torch.float32,
                      device=fl.device)
    consts = _consts(cfg)
    stream = torch.cuda.current_stream(fl.device).cuda_stream
    err = _library().flat_pass_launch(
        FLAT_IDS[body], int(tiled), fl.data_ptr(), out.data_ptr(), dims.k,
        dims.gx, dims.gy, dims.gz, *brick, consts, len(consts),
        fl.device.index, stream)
    kind = "flat" if tiled else "untiled"
    if err != 0:
        raise RuntimeError(f"flat_pass_cuda: launching {kind} {body} failed "
                           f"with CUDA error {err}")
    LAUNCHES[f"{kind}_{body}"] += 1
    return out
