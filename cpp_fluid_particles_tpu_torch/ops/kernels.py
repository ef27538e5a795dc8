"""SPH smoothing kernels as torch functions.

Port of ``cpp_fluid_particles_tpu/ops/kernels.py`` (reference
src/CUDAFunctions.cuh:23-98). Shape-polymorphic over leading axes, float32,
and exactly 0 outside the support, including at r == 0 (the reference's
``q < EPSILON`` early-out, so self-contributions vanish).

Integer powers of tensors are written as the products JAX's
``integer_pow`` lowers to (``x**3 = x * (x*x)``), so the CPU results match
the JAX package's bit for bit where the operation order allows.
"""

from __future__ import annotations

import math

import torch

from ..config import PI

EPS = 1e-6  # src/global.h:21


def _cube(x: torch.Tensor) -> torch.Tensor:
    return x * (x * x)


def w_cubic(r: torch.Tensor, h: float) -> torch.Tensor:
    """Cubic-spline kernel W(r, h) (src/CUDAFunctions.cuh:23-35).

    q = 2r/h; support q in [EPS, 2]; normalisation 1/(4 pi h^3)."""
    q = 2.0 * torch.abs(r) / h
    a = 0.25 / (PI * h * h * h)
    near = (3.0 * q - 6.0) * q * q + 4.0          # q <= 1: 3q^3 - 6q^2 + 4
    t = 2.0 - q
    far = _cube(t)                                # 1 < q <= 2: (2-q)^3
    val = a * torch.where(q > 1.0, far, near)
    return torch.where((q >= EPS) & (q <= 2.0), val, 0.0)


def grad_w_cubic_coef(r: torch.Tensor, h: float) -> torch.Tensor:
    """Scalar multiplier c(r) with grad W = c(r) * rvec
    (src/CUDAFunctions.cuh:37-50)."""
    q = 2.0 * r / h
    f = torch.where(q > 1.0, (12.0 - 3.0 * q) * q - 12.0,
                    (9.0 * q - 12.0) * q)
    return torch.where(q <= 2.0, f / (PI * (q + EPS) * h ** 5), 0.0)


def norm(rvec: torch.Tensor) -> torch.Tensor:
    """|rvec| over the last axis, float32, correctly rounded on every host.
    torch's float32 sqrt on the CPU goes through MKL, whose code path
    follows the CPU it finds: of 5000 test inputs it misrounds 0 (AVX2
    path), 30 (AVX-512) or 923 (SSE4.2) by one ulp. A float64 sqrt
    rounded once to float32 is the correctly rounded float32 sqrt
    (53 >= 2*24 + 2 bits), whichever path computed it."""
    s = torch.sum(rvec * rvec, dim=-1)
    return torch.sqrt(s.double()).to(s.dtype)


def grad_w_cubic(rvec: torch.Tensor, h: float) -> torch.Tensor:
    """Cubic-spline kernel gradient dW/dx; rvec (..., 3) -> (..., 3)."""
    r = norm(rvec)
    return grad_w_cubic_coef(r, h)[..., None] * rvec


def w_visc_laplacian(r: torch.Tensor, h: float) -> torch.Tensor:
    """Mueller viscosity kernel Laplacian (src/CUDAFunctions.cuh:52-54):
    45 (h - r) / (pi h^6) for r <= h, else 0."""
    return torch.where(r <= h, 45.0 * (h - r) / (PI * h ** 6), 0.0)


def grad_w_surface_coef(r: torch.Tensor, h: float) -> torch.Tensor:
    """Scalar multiplier of the Akinci-2013 surface-tension kernel gradient
    (src/CUDAFunctions.cuh:80-98). Support r in [EPS, h]; piecewise
      2r <= h : 2 (h-r)^3 r^3 - 0.0156 h^6
      r  <= h : (h-r)^3 r^3
    scaled by -136.0241 / (pi h^9 r)."""
    hx = h - r
    piece = torch.where(
        2.0 * r <= h,
        2.0 * _cube(hx) * _cube(r) - 0.0156 * h ** 6,
        _cube(hx) * _cube(r),
    )
    denom = PI * h ** 9 * torch.clamp(r, min=EPS)
    return torch.where((r >= EPS) & (r <= h), -136.0241 * piece / denom, 0.0)


def grad_w_surface_tension(rvec: torch.Tensor, h: float) -> torch.Tensor:
    """Akinci surface-tension kernel gradient; rvec (..., 3) -> (..., 3)."""
    x = norm(rvec)
    return grad_w_surface_coef(x, h)[..., None] * rvec


def w_cubic_max(h: float) -> float:
    """Peak value the cubic spline would take at q=0 if self-contribution
    were not excluded; handy for tests."""
    return 4.0 * 0.25 / (math.pi * h ** 3)
