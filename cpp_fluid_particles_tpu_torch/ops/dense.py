"""Dense ghosted cell grid in the lane-major flat layout.

Port of ``cpp_fluid_particles_tpu/ops/dense.py:40-154``. Layout:
``(F, K, G)`` with ``G = (CX+2)*(CY+2)*(CZ+2)`` the flattened ghosted cell
axis (x-major) and the per-cell slot axis K leading. A one-cell ghost ring
on every side makes a stencil offset (dx, dy, dz) one fixed displacement
``(dx*GY + dy)*GZ + dz`` of the flat axis. Slot k of cell c holds the
particle of rank k in that cell; ranks fill slots contiguously from 0, and
empty slots hold POS_PAD positions and zero for every other field.

In the port this full-domain grid holds the static boundary (built once
per scene); the fluid runs over the sliding box of ops/box.py, which uses
the same layout. The JAX index's ``col_count`` table fed the Pallas
kernel's column skipping and is not ported: the CUDA kernel skips by slot
occupancy.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..config import SimConfig
from .grid import cell_coords

F32 = torch.float32


class DenseDims(NamedTuple):
    cx: int
    cy: int
    cz: int
    k: int

    @property
    def gx(self) -> int:          # ghosted extents
        return self.cx + 2

    @property
    def gy(self) -> int:
        return self.cy + 2

    @property
    def gz(self) -> int:
        return self.cz + 2

    @property
    def zk(self) -> int:
        return self.gz * self.k

    @property
    def g(self) -> int:           # flattened ghosted cell count
        return self.gx * self.gy * self.gz

    @property
    def flat_p(self) -> int:      # max |flat stencil displacement|
        return self.gy * self.gz + self.gz + 1

    @property
    def total(self) -> int:
        return self.gx * self.gy * self.zk


def dims_for(cfg: SimConfig, k: int | None = None) -> DenseDims:
    cx, cy, cz = cfg.cell_size
    return DenseDims(cx, cy, cz, cfg.max_per_cell if k is None else k)


class DenseIndex(NamedTuple):
    """Per-step particle -> dense-slot assignment."""

    slots: torch.Tensor       # (N,) int64 into the flat ghosted array; trash = total
    valid: torch.Tensor       # (N,) bool
    overflow: torch.Tensor    # () int32
    max_occupancy: torch.Tensor  # () int32 fullest cell this step


def clamp_coords(c: torch.Tensor, full: DenseDims):
    """-> (in-grid mask, coordinates clamped into the grid)."""
    ext = (full.cx, full.cy, full.cz)
    inb = torch.ones(c.shape[:1], dtype=torch.bool, device=c.device)
    for a in range(3):
        inb = inb & (c[:, a] >= 0) & (c[:, a] < ext[a])
    cc = torch.stack([c[:, a].clamp(0, ext[a] - 1) for a in range(3)], 1)
    return inb, cc


def cell_order(key: torch.Tensor):
    """-> (rank of each particle within its key run, the particles sorted
    by key, ties in index order): stable argsort + run-length scan, the
    same permutation contract as the reference's counting sort
    (src/SPHSystem.cu:114-127) and the JAX package's index builders."""
    n = key.shape[0]
    order = torch.argsort(key, stable=True)
    sk = key[order]
    iota = torch.arange(n, dtype=torch.int32, device=key.device)
    newrun = torch.ones((n,), dtype=torch.bool, device=key.device)
    newrun[1:] = sk[1:] != sk[:-1]
    run_start = torch.cummax(torch.where(newrun, iota, 0), 0).values
    rank = torch.empty_like(iota)
    rank[order] = iota - run_start
    return rank, order


def build_dense_index(pos: torch.Tensor, cfg: SimConfig,
                      dims: DenseDims) -> DenseIndex:
    """cell ids -> within-cell ranks -> ghosted slot indices. Replaces the
    reference's counting sort without reordering the state."""
    inb, cc = clamp_coords(cell_coords(pos, cfg), dims)
    cell = (cc[:, 0] * dims.cy + cc[:, 1]) * dims.cz + cc[:, 2]
    rank, _ = cell_order(torch.where(inb, cell,
                                     dims.cx * dims.cy * dims.cz))

    valid = inb & (rank < dims.k)
    gcell = (((cc[:, 0] + 1) * dims.gy + (cc[:, 1] + 1)) * dims.gz
             + (cc[:, 2] + 1))
    gslot = rank * dims.g + gcell          # lane-major: slot axis leads
    slots = torch.where(valid, gslot, dims.total).long()
    overflow = (inb & ~valid).sum().to(torch.int32)
    max_occ = (torch.where(inb, rank, -1).max() + 1).to(torch.int32)
    return DenseIndex(slots=slots, valid=valid, overflow=overflow,
                      max_occupancy=max_occ)


def fill_dense(idx, fields: Sequence[torch.Tensor],
               fills: Sequence[float], dims: DenseDims) -> torch.Tensor:
    """Stack (N,) fields -> (F, K, G) lane-major dense arrays in ONE scatter.

    fills: per-field empty-slot value (POS_PAD for position components so
    padded slots never interact; 0 otherwise). Invalid particles all write
    the trash slot ``total``, which is sliced off."""
    vals = torch.stack([x.to(F32) for x in fields], 0)           # (F, N)
    dense = torch.empty((len(fields), dims.total + 1), dtype=F32,
                        device=vals.device)
    for row, v in zip(dense, fills):
        row.fill_(v)
    dense[:, idx.slots] = vals
    # slicing off the trash column leaves a strided view: copy it to the
    # contiguous layout the pass kernel takes
    return dense[:, : dims.total].reshape(
        len(fields), dims.k, dims.g).contiguous()


def read_dense(idx, dense: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """(F, K, G) -> (F, N) per-particle values in ONE gather."""
    flat = dense.reshape(dense.shape[0], -1)
    out = flat[:, idx.slots.clamp(max=flat.shape[1] - 1)]
    return torch.where(idx.valid[None, :], out, fill)
