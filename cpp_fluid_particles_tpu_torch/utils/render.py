"""Point-splat renderer as torch ops.

Port of ``cpp_fluid_particles_tpu/utils/render.py``. Replaces the
reference's CUDA-GL interop render path (src/vbo.cu +
src/particles.vert/.frag + the GL camera setup in src/main.cpp:308-352)
with a rasteriser in plain tensor ops: ``render(pos, density, camera) ->
(H, W, 3)`` float32 image on the particles' device, fetched only when the
caller asks.

Faithfully reproduced pieces:
  * density -> RGB colormap (src/vbo.cu:32-43): navy below 0.75, lerp to
    white up to 1.0, white -> magenta by (rho^2 - 1) above;
  * camera: gluPerspective(fov=30, aspect 1) + gluLookAt(0,0,1/zoom) with
    x/y rotations and the model translate(-0.5) (src/main.cpp:313-345);
  * sprite sizing pointRadius * pointScale / dist with
    pointScale = H / tan(fov/2) (src/main.cpp:337-338, particles.vert:33-37);
  * sphere-imposter shading exp(-mag^2) * color with circle discard
    (src/particles.frag:29-42), nearest-depth-wins compositing (the GL
    depth test: a scatter-min of the depths, then the winners' colors).

Deliberate differences, as in the JAX package: sprites are clamped to a
MAX_SPRITE patch; equal-depth ties resolve arbitrarily; the wireframe cube
outline is drawn by ``draw_cube_edges``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.kernels import norm

NAVY = (0.34, 0.46, 0.70)
WHITE = (0.9, 0.9, 0.9)
MAGENTA = (1.0, 0.4, 0.7)
BACKGROUND = (0.9, 0.9, 0.92)   # glClearColor (src/main.cpp:313)

MAX_SPRITE = 16  # sprite patch side in pixels


class Camera(NamedTuple):
    """Mirrors the reference's view state (src/main.cpp:44-47,313-345)."""

    rot_x: float = 0.0         # degrees, mouse-drag pitch
    rot_y: float = 0.0         # degrees, mouse-drag yaw
    zoom: float = 0.3
    width: int = 700           # m_window_h
    height: int = 700
    fov: float = 30.0          # m_fov
    point_radius: float = 0.01  # particle_radius


def density_colormap(density: torch.Tensor) -> torch.Tensor:
    """(N,) density -> (N, 3) RGB (src/vbo.cu:32-43)."""
    f32 = dict(dtype=torch.float32, device=density.device)
    navy = torch.tensor(NAVY, **f32)
    white = torch.tensor(WHITE, **f32)
    magenta = torch.tensor(MAGENTA, **f32)
    w_mid = (density - 0.75) * 4.0
    mid = w_mid[:, None] * white + (1.0 - w_mid[:, None]) * navy
    w_hi = torch.clamp((density * density - 1.0) * 4.0, max=1.0)
    hi = (1.0 - w_hi[:, None]) * white + w_hi[:, None] * magenta
    out = torch.where(density[:, None] < 0.75, navy,
                      torch.where(density[:, None] < 1.0, mid, hi))
    return out.to(torch.float32)


def _cos_sin(deg: float, device) -> tuple:
    """cos and sin of a float32 angle in degrees, each correctly rounded to
    float32: the angle is converted in float32 (deg * float32(pi / 180)),
    as the JAX package's deg2rad does, and the trigonometry runs in
    float64 rounded once (torch's float32 cos on the CPU is not always
    correctly rounded)."""
    rad = (torch.tensor(deg, dtype=torch.float32, device=device)
           * torch.tensor(math.pi / 180.0, dtype=torch.float32,
                          device=device))
    rad = rad.double()
    return torch.cos(rad).float(), torch.sin(rad).float()


def _rotation(rot_x_deg, rot_y_deg, device="cpu") -> torch.Tensor:
    cx, sx = _cos_sin(rot_x_deg, device)
    cy, sy = _cos_sin(rot_y_deg, device)
    one = torch.ones((), dtype=torch.float32, device=device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    rx = torch.stack([one, zero, zero, zero, cx, -sx,
                      zero, sx, cx]).reshape(3, 3)
    ry = torch.stack([cy, zero, sy, zero, one, zero,
                      -sy, zero, cy]).reshape(3, 3)
    return rx @ ry


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product is exact in
    float64)."""
    return (a.double() * b.double() + c.double()).float()


def _rotate(q: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """q @ rot.T for (N, 3) points, rounded as XLA:CPU computes the JAX
    package's dot: x and y as the three rounded products summed left to
    right, z as a fused multiply-add chain. One ulp of a screen coordinate
    moves a sprite's edge pixels by about 1e-5 at 96 px, so the port's
    CPU render matches the JAX package's only when these agree; on the
    card any order would do."""
    x, y = ((q[:, 0] * rot[i, 0] + q[:, 1] * rot[i, 1]) + q[:, 2] * rot[i, 2]
            for i in (0, 1))
    z = _fma(q[:, 2], rot[2, 2], _fma(q[:, 1], rot[2, 1],
                                      q[:, 0] * rot[2, 0]))
    return torch.stack([x, y, z], -1)


def render(
    pos: torch.Tensor,
    density: torch.Tensor,
    camera: Camera = Camera(),
    extra_points: torch.Tensor | None = None,
    extra_colors: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rasterise particles to an (H, W, 3) float32 image in [0, 1] on
    ``pos.device``.

    extra_points/extra_colors: optional decoration points (e.g. the cube
    edges from draw_cube_edges), splatted as 2 px dots; moved to
    ``pos.device``.
    """
    dev = pos.device
    H, W = camera.height, camera.width
    fov_rad = camera.fov * math.pi / 180.0
    focal = 1.0 / math.tan(0.5 * fov_rad)
    point_scale = H / math.tan(0.5 * fov_rad)
    eye_dist = 1.0 / camera.zoom

    colors = density_colormap(density)
    dec = torch.zeros((pos.shape[0],), dtype=torch.bool, device=dev)
    if extra_points is not None:
        extra_points = extra_points.to(dev)
        pos = torch.cat([pos, extra_points], 0)
        colors = torch.cat([colors, extra_colors.to(dev)], 0)
        dec = torch.cat([dec, torch.ones((extra_points.shape[0],),
                                         dtype=torch.bool, device=dev)])

    rot = _rotation(camera.rot_x, camera.rot_y, dev)
    p = _rotate(pos - 0.5, rot)                  # model: translate + rotate
    eye = p - torch.tensor([0.0, 0.0, eye_dist], dtype=torch.float32,
                           device=dev)           # view: camera at +z
    dist = norm(eye)
    z = eye[:, 2]
    behind = z >= -1e-6                          # behind the camera plane

    ndc_x = focal * eye[:, 0] / -z
    ndc_y = focal * eye[:, 1] / -z
    sx = (ndc_x + 1.0) * 0.5 * W
    sy = (1.0 - ndc_y) * 0.5 * H
    size_px = torch.where(
        dec, 2.0,
        torch.clamp(camera.point_radius * point_scale / dist, 1.0,
                    MAX_SPRITE),
    )

    # splat patches
    half = size_px * 0.5
    du = (torch.arange(MAX_SPRITE, dtype=torch.float32, device=dev)
          - (MAX_SPRITE - 1) / 2.0)
    px = torch.floor(sx[:, None] + du[None, :])            # (N, S)
    py = torch.floor(sy[:, None] + du[None, :])            # (N, S)
    r = torch.clamp(half, min=0.5)[:, None]
    u = (px + 0.5 - sx[:, None]) / r
    v = (py + 0.5 - sy[:, None]) / r
    mag = u[:, :, None] * u[:, :, None] + v[:, None, :] * v[:, None, :]
    inside = (mag <= 1.0) & ~behind[:, None, None]         # (N, S, S)

    pix_x = torch.clamp(px, 0, W - 1).to(torch.int64)
    pix_y = torch.clamp(py, 0, H - 1).to(torch.int64)
    on_x = (px >= 0) & (px < W)
    on_y = (py >= 0) & (py < H)
    valid = inside & on_x[:, :, None] & on_y[:, None, :]
    flat = pix_y[:, None, :] * W + pix_x[:, :, None]       # (N, S, S)
    flat = torch.where(valid, flat, H * W).reshape(-1)     # trash pixel

    depth = dist[:, None, None].expand(mag.shape).reshape(-1)
    depth_min = torch.full((H * W + 1,), math.inf, dtype=torch.float32,
                           device=dev)
    depth_min.scatter_reduce_(0, flat, depth, "amin", include_self=True)
    win = depth <= depth_min[flat]
    target = torch.where(win, flat, H * W)

    falloff = torch.exp(-mag * mag)                        # frag shader
    rgb = colors[:, None, None, :] * torch.where(
        dec[:, None, None, None], 1.0, falloff[..., None])
    img = torch.zeros((H * W + 1, 3), dtype=torch.float32, device=dev)
    img[target] = rgb.reshape(-1, 3)
    covered = depth_min[: H * W] < math.inf
    bg = torch.tensor(BACKGROUND, dtype=torch.float32, device=dev)
    out = torch.where(covered[:, None], img[: H * W], bg)
    return out.reshape(H, W, 3)


def draw_cube_edges(samples_per_edge: int = 200, device="cpu"):
    """The wireframe unit-cube outline (glutSolidCube in line mode,
    src/main.cpp:331-334) as a point set + grey colors on ``device``."""
    t = np.linspace(0.0, 1.0, samples_per_edge, dtype=np.float32)
    pts = []
    for a in (0.0, 1.0):
        for b in (0.0, 1.0):
            pts.append(np.stack([t, np.full_like(t, a), np.full_like(t, b)], -1))
            pts.append(np.stack([np.full_like(t, a), t, np.full_like(t, b)], -1))
            pts.append(np.stack([np.full_like(t, a), np.full_like(t, b), t], -1))
    pts = np.concatenate(pts, 0)
    colors = np.full((pts.shape[0], 3), 0.7, np.float32)  # glColor4f 0.7 grey
    return (torch.as_tensor(pts, device=device),
            torch.as_tensor(colors, device=device))


def renderer_palette() -> np.ndarray:
    """A 256-color GIF palette derived from this renderer's actual output
    gamut: the density colormap ramp x the sphere-imposter Gaussian shading
    levels, plus the background/cube colors — far less banding than a
    generic RGB cube for simulator frames."""
    dens = np.concatenate([
        np.linspace(0.3, 0.99, 22), np.linspace(1.0, 1.25, 19),
    ])
    ramp = density_colormap(
        torch.as_tensor(dens, dtype=torch.float32)).numpy()
    falloff = np.exp(-np.linspace(0.0, 1.0, 6) ** 2)
    shaded = (falloff[:, None, None] * ramp[None]).reshape(-1, 3)  # 246
    extras = np.array([
        BACKGROUND, (0.7, 0.7, 0.7), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
        (0.85, 0.85, 0.87), (0.5, 0.5, 0.52), (0.95, 0.95, 0.96),
        (0.2, 0.27, 0.41), (0.6, 0.24, 0.42), (0.45, 0.45, 0.46),
    ])
    pal = np.concatenate([extras, shaded])[:256]
    return np.clip(pal * 255.0 + 0.5, 0, 255).astype(np.uint8)
