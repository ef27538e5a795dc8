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
sum count. ``record_pass_cuda`` runs surface, surface_pressure,
xsph_colorgrad and viscosity (``RECORD_IDS``) through the cell-packed
record kernel, and pbd_lambda, stiffness_accel and the surface-off
pressure_force and density_alpha (``COUNTED``) through the counted record
walk:
``pack_records`` (the pack kernel on a card, ``pack_records_plain`` on the
CPU) writes the records of the operand's (cell, slot)s that a walk reads
(``walked``; for ``COUNTED`` one position pack with each cell's count of
real slots, which serves every pass on the same positions), and the walk
reads them in the particle-list kernel's groups and order, bitwise its
output.
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
pack and walk (``pack_key(name)``: ``pack_<name>``, or ``pack_positions``
for the shared position pack; ``record_<name>``) and of each fluid-only
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
# width in one call; the surface-off pressure_force (3 sums, the WCSPH dam
# at K 22) took 0.0618 and 0.0610 ms at W 8 (transpose) in two calls,
# against 0.0619-0.0623 at W 16 and 0.0625-0.0634 at W 32, where it alone
# does not spill (PERF.md, kernel table). With the slot list in
# cell-major order (BoxIndex.work), the four particles of a warp at W 8
# mostly share a cell and so read the same neighbour slots: divergence
# (DFSPH's 300-frame state, K 16) took 0.0470 ms at W 8 against 0.0493 at
# W 32 and 0.0496 at W 16, and 1.149 against 1.799 at W 32 on the 1M
# recipe's state; density_colorgrad_visc
# (WCSPH's, K 22) 0.0611 at W 8 (butterfly) against 0.0622 transposed and
# 0.0747 at its former W 32 transposed (CUDA-graph ms, best of two, one
# call; PERF.md section 6); density_alpha_colorgrad (DFSPH's, K 18) 0.0526
# at W 16 transposed against 0.0553 at its former W 32 transposed (W 8,
# butterfly only: 0.0558), and 1.414 against 1.929 on the 1M recipe's
# state (W 8 there 1.232); in both ladder passes of one call (NVIDIA H100
# 80GB HBM3, 700 W; CUDA-graph ms), density_visc (4 sums, WCSPH's
# surface-off step from its 300-frame state, K 22) 0.0457 / 0.0455 at W 8
# transposed against 0.0517 / 0.0515 at its former W 16 transposed (W 8
# butterfly 0.0527 / 0.0511, W 32 0.0570-0.0586), and viscosity (3 sums,
# DFSPH's, K 16) 0.0420 / 0.0416 at W 8 transposed against 0.0451 / 0.0466
# at its former W 32 butterfly (W 8 butterfly 0.0417 / 0.0420), the
# particle-list kernel being viscosity's yardstick (it runs the record
# kernel); the yardsticks of the counted walk, pbd_lambda and
# stiffness_accel (PBD's 300-frame state, K 18, both ladder passes), 0.0497
# / 0.0504 and 0.0434 / 0.0443 at W 8 butterfly against 0.0536 / 0.0539
# and 0.0469 / 0.0463 at W 32 (on DFSPH's state stiffness_accel 0.0476 /
# 0.0486 against 0.0479 / 0.0476); and of the surface-off counted walks,
# pressure_force 0.0508 / 0.0506 at its W 8 transposed (butterfly 0.0524 /
# 0.0522, W 16-32 0.0570-0.0592)
PASS_LANES = {"surface_pressure": 8, "density_visc": 8,
              "pressure_force": 8, "divergence": 8,
              "density_colorgrad_visc": 8, "density_alpha_colorgrad": 16,
              "viscosity": 8, "pbd_lambda": 8, "stiffness_accel": 8}

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
# table). The fluid-only surface (3 sums, K 16) took 0.0605 ms transposed
# at W 32 against the butterfly's 0.0632 (W 8: 0.0665 / 0.0674, W 16:
# 0.0680 / 0.0682); viscosity (3 sums) takes it at its W 8 (see
# PASS_LANES). density_alpha_colorgrad (9 sums, K 16; the transpose only
# at W 16 and 32) took 0.0625 transposed at W 32 against the butterfly's
# 0.0655 (W 16: 0.0661 / 0.0683, butterfly W 8 0.0654); density_visc
# (4 sums) 0.0457 / 0.0455 transposed at its W 8 against the butterfly's
# 0.0527 / 0.0511 (one call, both ladder passes). The
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
# does not spill (W 8 and 16 spill 32 B). Re-laddered as the counted
# walk's yardstick (one call, both ladder passes, graph ms), density_alpha
# kept W 32 transposed, 0.0490 / 0.0490 against 0.0500 / 0.0506 at W 8
# and 0.0501 / 0.0500 at W 16 transposed, and pressure_force W 8
# transposed, 0.0508 / 0.0506
PASS_REDUCTION = {"xsph_colorgrad": "transpose", "surface": "transpose",
                  "density_alpha_colorgrad": "transpose",
                  "density_visc": "transpose", "density_alpha": "transpose",
                  "pressure_force": "transpose", "xsph": "transpose",
                  "density": "transpose", "viscosity": "transpose"}

# pass name -> its id in pack_records_launch and record_pass_launch
# (csrc/column_pass.cu): the passes the cell-packed record kernel serves.
# Two lost to their particle-list kernel through the records (CUDA-graph
# ms, pack included, against the particle-list kernel's best, both ladder
# passes; PERF.md section 6): density_alpha_colorgrad, whose functor reads
# only the mass, 0.0512 against 0.0485 on DFSPH's 300-frame state and
# 1.268 against 1.235 at 1M; the surface-off density_visc 0.0489 /
# 0.0490 against 0.0457 / 0.0455 at W 8 transposed on WCSPH's: its walk
# alone tied (0.0456), and the pack added 0.0042
RECORD_IDS = {"surface_pressure": 2, "stiffness_accel": 5, "viscosity": 6,
              "surface": 7, "density_alpha": 8, "pressure_force": 10,
              "pbd_lambda": 11, "xsph_colorgrad": 12}

# the record passes whose walk is counted (csrc/column_pass.cu
# counted_pass_kernel): their records are one position pack, {x, y, z, m}
# of each real slot and each cell's count of real slots, with no j side,
# the same for every such pass, so that one pack serves every pass on the
# same positions (ops/passes.py SharedPack); stiffness_accel reads its s,
# pressure_force its rho and p from the operand's own planes
COUNTED = ("pbd_lambda", "stiffness_accel", "pressure_force",
           "density_alpha")

# floats of a record pass's j side, P::J in csrc/column_pass.cu: |cg|^2;
# |cg|^2 and p / max(eps, rho^2); vel3 and m / rho0; vel3 and 0; none in
# the position pack of COUNTED
SIDE_WIDTH = {"surface": 1, "surface_pressure": 2, "xsph_colorgrad": 4,
              "viscosity": 4, **{name: 0 for name in COUNTED}}

# what pack_records_plain puts in a record that no walk reads, and the pack
# kernel does not write
UNWRITTEN = float("nan")

# slots a batch of the record kernel's walk loads before it tests the
# first for padding (batches of 4 lost to both on every dam state: PERF.md
# section 6)
UNROLLS = (1, 2)

# slots a batch of the counted walk loads before any arithmetic: it knows
# each cell's count, so a batch loads no slot past it and tests none
COUNTED_UNROLLS = (1, 2, 4)

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
# transposed). Unroll 4 lost to both unrolls on every state. With the pack
# writing only what a walk reads (the same card and timing, both ladder
# passes): surface 0.0411 / 0.0409 at W 8 transposed, U 1, on DFSPH's
# state at K 22 (best W 16 transposed, 0.0406 / 0.0404) and 0.0466 / 0.0468
# on PBD's (the best), surface_pressure 0.0531 / 0.0530 (the best), and
# xsph_colorgrad (PBD's, K 18) 0.0522 / 0.0524 at W 8 transposed, U 1
# (butterfly 0.0520 / 0.0528, W 16 0.0558-0.0568, U 2 0.0581-0.0628)
# against the particle-list kernel's best, 0.0557 / 0.0560 at W 8
# transposed. viscosity (DFSPH's, K 16) 0.0376 / 0.0377 at W 8 transposed,
# U 1 (butterfly 0.0384 / 0.0384, U 2 0.0386-0.0390, W 16 0.0400-0.0418)
# against the particle-list kernel's best, 0.0420 / 0.0416 at W 8
# transposed. The counted walk alone (chip_smoke.py's ladder on the
# 300-frame states, both passes): pbd_lambda (PBD, K 18) 0.0444 / 0.0447 at
# W 8 butterfly, U 2 (transposed 0.0446 / 0.0445, U 4 0.0459 / 0.0466, W
# 16 transposed U 2 0.0468 / 0.0471) against the particle-list kernel's
# best, 0.0497 / 0.0504 at W 8 butterfly; stiffness_accel at W 8
# butterfly, U 2, 0.0391 / 0.0386 on PBD's state (U 4 0.0382 / 0.0388)
# and 0.0407 / 0.0405 on DFSPH's (K 16; U 4 0.0423 / 0.0405) against
# 0.0434 / 0.0443 (W 8 butterfly) and 0.0471 / 0.0475 (W 32 transposed);
# the shared position pack 0.0032-0.0034 a call. The surface-off passes
# (one call, both ladder passes): pressure_force (WCSPH's state, K 22) 0.0467
# / 0.0463 at W 8 butterfly, U 2 (best U 4 0.0461 / 0.0462, which spills
# 36 B; transposed U 2 0.0464 / 0.0472), its own pack 0.0034, against the
# particle-list kernel's best, 0.0508 / 0.0506 at W 8 transposed;
# density_alpha (DFSPH's, K 16) 0.0425 / 0.0408 at W 8 transposed, U 2
# (butterfly 0.0425 / 0.0417, U 4 0.0420 / 0.0434, W 16 0.0426-0.0443)
# against 0.0490 / 0.0490 at W 32 transposed.
RECORD_DEFAULTS = {"surface": (8, "transpose", 1),
                   "surface_pressure": (8, "butterfly", 2),
                   "xsph_colorgrad": (8, "transpose", 1),
                   "viscosity": (8, "transpose", 1),
                   "pbd_lambda": (8, "butterfly", 2),
                   "stiffness_accel": (8, "butterfly", 2),
                   "pressure_force": (8, "butterfly", 2),
                   "density_alpha": (8, "transpose", 2)}

# launches per pass instance, per particle-list instance (particle_<name>),
# per record instance's pack and walk (pack_key(name), record_<name>) and
# per fluid-only instance of the prototype's bodies (flat_<body>: the
# tiled kernel; untiled_<body>: column_pass_kernel); bumped once per
# successful launch
LAUNCHES = {name: 0 for name in PASS_IDS}
LAUNCHES.update({f"particle_{name}": 0 for name in PARTICLE_PASSES})
LAUNCHES.update({f"record_{name}": 0 for name in RECORD_IDS})
LAUNCHES.update({f"pack_{name}": 0 for name in RECORD_IDS
                 if name not in COUNTED})
LAUNCHES["pack_positions"] = 0
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


def unrolls(name: str) -> tuple:
    """The unrolls the record walk of pass ``name`` takes."""
    return COUNTED_UNROLLS if name in COUNTED else UNROLLS


def pack_key(name: str) -> str:
    """The launch counter of the pack record pass ``name`` walks: the
    shared position pack of COUNTED, or the pass's own."""
    return "pack_positions" if name in COUNTED else f"pack_{name}"


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
    fn.argtypes = [ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp,
                   ci, ci, vp]
    fn.restype = ci
    fn = lib.record_pass_launch
    fn.argtypes = [ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                   ci, ci, ci, ci, vp, ci, ci, vp]
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
    none where it takes one, is refused.
    Returns (n_out, K, G), zeroed by one memset before the launch (it
    counts in the kernel's time): the kernel writes only the listed slots.
    Counted as ``particle_<name>``."""
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
    row c*K + s (boundary c*Kb + s). Only the records a walk reads hold
    values (``walked``); the pack kernel leaves the others unwritten. The
    position pack of COUNTED has no j side and counts each cell's real
    slots."""
    geo: torch.Tensor             # (G*K, 4) [x, y, z, m]
    side: Optional[torch.Tensor]  # (G*K,) or (G*K, SIDE_WIDTH[pass]): its J
    bgeo: Optional[torch.Tensor]  # (G*Kb, 4) the boundary's, or None
    count: Optional[torch.Tensor] = None   # (G,) int32: real slots (COUNTED)
    bcount: Optional[torch.Tensor] = None  # (G,) int32: the boundary's


def _side_plain(name: str, fl: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """The slots' j side (the kernel's P::J) as the plain pass bodies form
    it (ops/passes.py): (SIDE_WIDTH[name], K, G). surface: |cg|^2;
    surface_pressure: |cg|^2 and p / max(eps, rho^2); xsph_colorgrad: vel3
    and m / rho0; viscosity: vel3 and 0. m / rho0 divides by a 0-dim
    tensor on fl's device, a correctly rounded division on every device,
    as the kernel's __fdiv_rn: torch on a card multiplies by the
    reciprocal of a Python scalar divisor instead, which rounds otherwise
    at a rho0 such as 1.3 (the CPU divides either way)."""
    if name == "viscosity":
        return torch.stack([fl[4], fl[5], fl[6], torch.zeros_like(fl[4])])
    if name == "xsph_colorgrad":
        rho0 = torch.tensor(cfg.rho0, dtype=fl.dtype, device=fl.device)
        return torch.stack([fl[4], fl[5], fl[6], fl[3] / rho0])
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


def walked(x0: torch.Tensor):
    """The records a walk reads of a grid whose row 0 is ``x0`` (K, G) ->
    (real, first padding), (G*K,) bool in record order: every slot that
    holds a particle, and each cell's first padding slot (slot 0 or the
    slot after a real one), where every walk of the cell stops (ranks fill
    a cell from slot 0). A cell full to K has no padding slot. The counted
    walk reads the real slots alone."""
    real = x0 < POS_PAD / 2
    before = torch.cat([torch.ones_like(real[:1]), real[:-1]])
    return (real.T.reshape(-1).contiguous(),
            (before & ~real).T.reshape(-1).contiguous())


def counts_plain(x0: torch.Tensor) -> torch.Tensor:
    """Each cell's count of the grid whose row 0 is ``x0`` (K, G) -> (G,)
    int32: its first padding slot, or K where it has none, as the pack
    kernel finds it; the cell's real slots, since ranks fill a cell from
    slot 0."""
    real = (x0 < POS_PAD / 2).to(torch.int32)
    return torch.cumprod(real, 0).sum(0, dtype=torch.int32)


def _records_plain(x: torch.Tensor, side: Optional[torch.Tensor],
                   probe: bool = True):
    """The records the pack kernel writes of grid x (rows, K, G): [x, y,
    z, m] and the j side ``side`` (width, K, G) at a real slot, [x, 0, 0,
    0] at a cell's first padding slot where ``probe`` (the counted pack
    writes none); every other record UNWRITTEN -> (geo, side or None)."""
    real, first = walked(x[0])
    geo = torch.full((real.shape[0], 4), UNWRITTEN, dtype=x.dtype,
                     device=x.device)
    rows = _cell_major(x[:4])
    geo[real] = rows[real]
    if probe:
        geo[first, 0] = rows[first, 0]
        geo[first, 1:] = 0.0
    if side is None:
        return geo, None
    j = _cell_major(side)
    j[~real] = UNWRITTEN
    return geo, (j[:, 0].contiguous() if j.shape[1] == 1 else j)


def pack_records_plain(name: str, fl: torch.Tensor,
                       bd: Optional[torch.Tensor], cfg: SimConfig) -> Records:
    """The records of pass ``name`` (one of RECORD_IDS) in torch ops: on the
    records ``walked`` names, what the pack kernel writes, bitwise on a card
    (|cg|^2 rounded as here, never contracted; m / rho0 as
    ``_side_plain`` forms it); UNWRITTEN in every other record, which the
    kernel does not write. For COUNTED the position pack: the real slots'
    records alone and each cell's count (``counts_plain``), the
    boundary's likewise."""
    if name in COUNTED:
        return Records(_records_plain(fl, None, False)[0], None,
                       _records_plain(bd, None, False)[0], counts_plain(fl[0]),
                       counts_plain(bd[0]))
    geo, side = _records_plain(fl, _side_plain(name, fl, cfg))
    return Records(geo, side, None if bd is None else _records_plain(bd,
                                                                     None)[0])


def read_records(recs: Records, fl: torch.Tensor,
                 bd: Optional[torch.Tensor]) -> tuple:
    """What a walk reads of ``recs``, packed from ``fl`` and ``bd``: geo at
    the real slots and (but for the counted pack) each cell's first padding
    slot, the j side at the real slots, the boundary's geo likewise, and
    the counts -> a tuple of tensors, to compare two packs by."""
    real, first = walked(fl[0])
    counted = recs.count is not None
    out = (recs.geo[real if counted else real | first],)
    if recs.side is not None:
        out += (recs.side[real],)
    if bd is not None:
        breal, bfirst = walked(bd[0])
        out += (recs.bgeo[breal if counted else breal | bfirst],)
    if counted:
        out += (recs.count, recs.bcount)
    return out


def pack_records(name: str, fl: torch.Tensor, bd: Optional[torch.Tensor],
                 dims: DenseDims, dims_b: Optional[DenseDims],
                 cfg: SimConfig) -> Records:
    """The cell-packed records of pass ``name`` (one of RECORD_IDS) from its
    operand ``fl`` (Fi, K, G) and, for a pass with a boundary term, the
    boundary window ``bd`` (4, Kb, G), the records of the ghosted grid that
    a walk reads (``walked``): on the CPU ``pack_records_plain``; on a card
    the pack kernel, one launch on the current stream into buffers from
    ``torch.empty`` (no sync, so a CUDA graph can hold it), the records no
    walk reads left unwritten, counted as ``pack_key(name)``. For COUNTED
    it is the position pack of rows 0-3 of ``fl`` and ``bd``, the same for
    every counted pass."""
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
    counted = name in COUNTED

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=fl.device)
    geo = empty((n, 4))
    side = None if counted else empty(_side_shape(name, n))
    bgeo = None if bd_ptr is None else empty((dims.g * kb, 4))
    count = bcount = None
    if counted:
        count = empty((dims.g,), torch.int32)
        # no thread of an empty window's boundary writes its counts
        bcount = (empty((dims.g,), torch.int32) if kb else torch.zeros(
            (dims.g,), dtype=torch.int32, device=fl.device))
    err = _library().pack_records_launch(
        RECORD_IDS[name], fl.data_ptr(), bd_ptr, geo.data_ptr(),
        _ptr(side), _ptr(bgeo), _ptr(count), _ptr(bcount), dims.k, kb,
        dims.gx, dims.gy, dims.gz, consts, len(consts), fl.device.index,
        stream)
    if err != 0:
        raise RuntimeError(f"pack_records: packing {name} failed with CUDA "
                           f"error {err}")
    LAUNCHES[pack_key(name)] += 1
    return Records(geo, side, bgeo, count, bcount)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _side_shape(name: str, n: int):
    """The shape of pass ``name``'s j-side records for n slots (None: the
    position pack has none)."""
    width = SIDE_WIDTH[name]
    if width == 0:
        return None
    return (n,) if width == 1 else (n, width)


def _check_records(fn: str, name: str, recs: Records, fl: torch.Tensor,
                   dims: DenseDims, dims_b: Optional[DenseDims]) -> None:
    """Check records handed to the walk against pass ``name``'s grids: the
    walk indexes them by the grids' K, Kb and G, so a pack of another pass,
    K or window would send it out of bounds."""
    n = dims.g * dims.k
    counted = name in COUNTED
    want = {"geo": (n, 4), "side": _side_shape(name, n), "bgeo": None,
            "count": (dims.g,) if counted else None,
            "bcount": (dims.g,) if counted else None}
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
        dtype = torch.int32 if what in ("count", "bcount") else torch.float32
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{fn}: records.{what} is not contiguous "
                             f"{str(dtype).split('.')[-1]}")
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
    kernel, or for COUNTED the counted walk, on the current stream of
    ``fl``'s device: ``pack_records`` of ``fl`` and ``bd`` (unless
    ``records``, checked against the grids, hands them in: for COUNTED a
    position pack of any operand with the same positions, masses and
    boundary window), then the walk, a group of ``lanes`` lanes per
    particle of ``islots`` reduced by ``reduction`` as
    ``particle_pass_cuda`` takes them, loading ``unroll`` (one of
    ``unrolls(name)``; default the pass's in RECORD_DEFAULTS) slots'
    records a batch. The counted walk reads its i side's and its pairs'
    other values (stiffness_accel's s, pressure_force's rho and p) from
    ``fl`` itself, and tells by ``fl``'s row 0, as the particle-list kernel
    does, whether a listed slot holds a particle. Every entry of ``islots``
    of a pass with its own pack must be a slot that holds a particle or the
    trash slot K*G, as the steps' lists are (``BoxIndex.slots`` and
    ``.work``, ``halo.slab_slots``): that walk takes its i side from the
    listed slot's record, and the pack leaves the records of padding slots
    unwritten. The counted walk indexes in 32 bits: it refuses an operand
    of rows x K x G floats, a Kb*G or ``lanes`` threads per listed
    particle that reach 2^31. Returns (n_out, K, G), zeroed by one memset
    before the walk, which writes only the listed slots; the walk is
    counted as ``record_<name>``."""
    fn = "record_pass_cuda"
    if name not in RECORD_IDS:
        raise ValueError(f"{fn}: pass {name!r} has no record kernel; one of "
                         f"{tuple(RECORD_IDS)}")
    lanes, reduction = _group(fn, name, lanes, reduction, islots,
                              RECORD_DEFAULTS[name])
    unroll = RECORD_DEFAULTS[name][2] if unroll is None else unroll
    if unroll not in unrolls(name):
        raise ValueError(f"{fn}: unroll {unroll} is not one of "
                         f"{unrolls(name)}")
    floats = PASSES[name].fi * dims.k * dims.g
    if name in COUNTED and max(floats, islots.shape[0] * lanes,
                               (dims_b.k if dims_b else 0) * dims.g) >= 2**31:
        raise ValueError(f"{fn}: the counted walk indexes in 32 bits: the "
                         f"operand's {floats} floats (rows x K x G), Kb*G "
                         f"and its {lanes} lanes for each of "
                         f"{islots.shape[0]} particles must stay under 2^31")
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
        records.geo.data_ptr(), _ptr(records.side), _ptr(records.bgeo),
        _ptr(records.count), _ptr(records.bcount),
        fl.data_ptr() if name in COUNTED else None, islots.data_ptr(),
        out.data_ptr(), n, dims.k, kb, dims.gx, dims.gy, dims.gz, consts,
        len(consts), fl.device.index, stream)
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
