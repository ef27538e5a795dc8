"""Binding of the hand-written CUDA neighbor-pass kernel (csrc/column_pass.cu).

The kernel replaces the JAX package's Pallas ``column_pass``
(cpp_fluid_particles_tpu/ops/pallas_passes.py:107). Its source is compiled
by ``nvcc`` for sm_90a into a shared library with a plain C interface, on
first use, into ``_build/`` under this package (ignored by git), keyed by a
hash of the source and the flags, and loaded with ctypes. A missing
``nvcc`` or a failed build raises: there is no fallback.

``column_pass_cuda`` has the executor signature of
``ops.passes.column_pass_plain`` and takes CUDA tensors only. ``LAUNCHES``
counts the launches of each pass instance.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..config import PI, SimConfig
from . import kernels as kn
from .dense import DenseDims
from .grid import POS_PAD
from .passes import BOUNDARY_ROWS, PASSES

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "column_pass.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# pass name -> template instance in column_pass_launch (csrc/column_pass.cu)
PASS_IDS = {"density": 0, "density_colorgrad_visc": 1, "surface_pressure": 2}

# launches per pass instance; bumped once per successful launch
LAUNCHES = {name: 0 for name in PASS_IDS}


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
    return lib


def _consts(cfg: SimConfig):
    """Kernel constants in the order of csrc/column_pass.cu:Consts,
    computed in double as the Python passes compute them."""
    h, rho0sq = cfg.radius, cfg.rho0 * cfg.rho0
    vals = [h, kn.EPS, cfg.epsilon, PI, 0.25 / (PI * h * h * h), h ** 5,
            PI * h ** 6, PI * h ** 9, 0.0156 * h ** 6, cfg.rho0,
            cfg.rho_boundary, 0.25 / rho0sq * cfg.surface_tension,
            cfg.air_pressure / rho0sq, POS_PAD / 2.0]
    return (ctypes.c_float * len(vals))(*vals)


def _check(t: torch.Tensor, what: str, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"column_pass_cuda: {what} is on {t.device}, "
                         "not a CUDA device")
    if t.dtype != torch.float32:
        raise ValueError(f"column_pass_cuda: {what} is {t.dtype}, "
                         "not float32")
    if not t.is_contiguous():
        raise ValueError(f"column_pass_cuda: {what} is not contiguous")
    if tuple(t.shape) != shape:
        raise ValueError(f"column_pass_cuda: {what} has shape "
                         f"{tuple(t.shape)}, expected {shape}")


def column_pass_cuda(name: str, fl: torch.Tensor, bd: torch.Tensor,
                     dims: DenseDims, dims_b: DenseDims,
                     cfg: SimConfig) -> torch.Tensor:
    """Launch pass ``name`` on ``fl`` (Fi, K, G) and ``bd`` (4, Kb, G) on
    the current stream of their device; returns (n_out, K, G)."""
    spec = PASSES[name]
    if dims_b[:3] != dims[:3]:
        raise ValueError("column_pass_cuda: fluid and boundary grids must "
                         "share the ghosted cell geometry")
    _check(fl, "fl", (spec.fi, dims.k, dims.g))
    _check(bd, "bd", (BOUNDARY_ROWS, dims_b.k, dims.g))
    if bd.device != fl.device:
        raise ValueError("column_pass_cuda: fl and bd on different devices")
    out = torch.empty((spec.n_out, dims.k, dims.g), dtype=torch.float32,
                      device=fl.device)
    consts = _consts(cfg)
    stream = torch.cuda.current_stream(fl.device).cuda_stream
    err = _library().column_pass_launch(
        PASS_IDS[name], fl.data_ptr(), bd.data_ptr(), out.data_ptr(),
        dims.k, dims_b.k, dims.gx, dims.gy, dims.gz, consts, len(consts),
        fl.device.index, stream)
    if err != 0:
        raise RuntimeError(f"column_pass_cuda: launching {name} failed "
                           f"with CUDA error {err}")
    LAUNCHES[name] += 1
    return out
