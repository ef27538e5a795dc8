"""Sliding-box compaction — the fluid grid of the main path.

Port of ``cpp_fluid_particles_tpu/ops/box.py:49-218``, single device. The
neighbor passes run over a box-shaped sub-grid whose SIZE (BX, BY, BZ) is
fixed between capacity changes (fitted and refitted by Simulation, like the
per-cell slot count K) and whose POSITION follows the fluid each step as a
device-side origin:

  * the fluid scatters directly into the ghosted box (one scatter),
  * the static full-domain boundary grid contributes the box's window,
    cut by one device-side gather at the box origin (no host sync),
  * every neighbor pass is an ordinary flat pass with
    ``DenseDims(BX, BY, BZ, K)``.

The index also lists the slots in cell-major order (``BoxIndex.work``,
from the same stable sort that ranks the particles), the list the
particle-list passes take but surface_pressure (faster on ``slots``): the
particles a block of the kernel serves then share their neighbour cells,
so the kernel finds their rows in L1. The passes' outputs do not depend on
the list's order.

Fluid outside the box (possible only when the true bounding box exceeds
the box size) follows the ballistic fallback and is counted in
``box_overflow``; Simulation then refits the box to the measured extents
and re-runs the frame from the pre-frame state (the no-drop contract).

Under a mesh each rank runs the passes on its block of the box
(parallel/halo.py): ``slab_window`` gives the rank's window, its slot
lists and its boundary window; the fill and the read then run on the window
(the JAX package's mesh branches, box.py:143-205, in the form of
parallel/halo.py).

Not ported: the gather/auto fill modes and their TPU bandwidth model, and
the occupancy-split signal ``hi_ext``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig
from ..parallel import halo
from .dense import (DenseDims, cell_order, clamp_coords, fill_dense,
                    read_dense)
from .grid import cell_coords


class BoxIndex(NamedTuple):
    """Per-step particle -> box-slot assignment."""

    slots: torch.Tensor       # (N,) int64 into the flat ghosted box; trash=total
    # the same slots in cell-major order (cells ascending, ranks ascending in
    # each): the particle-list passes' slot list, so that the particles a
    # block of the kernel takes share their neighbour cells in its L1
    work: torch.Tensor
    valid: torch.Tensor       # (N,) bool
    origin: torch.Tensor      # (3,) int32 box core origin in cell coords
    ext: torch.Tensor         # (3,) int32 measured fluid cell extents
    overflow: torch.Tensor    # () int32 dropped by the per-cell bound K
    box_overflow: torch.Tensor  # () int32 in-domain fluid outside the box
    max_occupancy: torch.Tensor  # () int32 fullest cell this step


def build_box_index(pos: torch.Tensor, cfg: SimConfig, full: DenseDims,
                    box: DenseDims) -> BoxIndex:
    """Cell ids -> within-cell ranks -> slots of the ghosted (BX, BY, BZ)
    box positioned at the fluid's minimum corner (clamped so the box stays
    inside the domain)."""
    inb, cc = clamp_coords(cell_coords(pos, cfg), full)
    # within-cell ranks on FULL-domain cell ids
    cell = (cc[:, 0] * full.cy + cc[:, 1]) * full.cz + cc[:, 2]
    rank, order = cell_order(torch.where(inb, cell,
                                         full.cx * full.cy * full.cz))

    # fluid bounding box -> box origin (device-side; the box SIZE is fixed)
    big = 1 << 20
    cmin = torch.where(inb[:, None], cc, big).amin(0)
    cmax = torch.where(inb[:, None], cc, -1).amax(0)
    ext = (cmax - cmin + 1).clamp(min=0)
    bsz = (box.cx, box.cy, box.cz)
    hi = (full.cx - box.cx, full.cy - box.cy, full.cz - box.cz)
    origin = torch.stack([cmin[a].clamp(0, hi[a]) for a in range(3)])

    rel = cc - origin[None, :]
    inbox = inb.clone()
    for a in range(3):
        inbox &= (rel[:, a] >= 0) & (rel[:, a] < bsz[a])
    valid = inbox & (rank < box.k)
    gb = box.g
    gcell = (((rel[:, 0] + 1) * box.gy + (rel[:, 1] + 1)) * box.gz
             + (rel[:, 2] + 1))
    slots = torch.where(valid, rank * gb + gcell, box.k * gb).long()

    box_overflow = (inb & ~inbox).sum().to(torch.int32)
    overflow = (inbox & (rank >= box.k)).sum().to(torch.int32)
    max_occ = (torch.where(inb, rank, -1).max() + 1).to(torch.int32)
    return BoxIndex(slots=slots, work=slots[order], valid=valid,
                    origin=origin, ext=ext,
                    overflow=overflow, box_overflow=box_overflow,
                    max_occupancy=max_occ)


# The box is a smaller ghosted grid of the same layout, so its scatter and
# gather are exactly the dense grid's (the JAX package's "scatter" mode).
fill_box = fill_dense
read_box = read_dense


def slice_boundary_box(bd: torch.Tensor, full: DenseDims, box: DenseDims,
                       origin: torch.Tensor, x0: int = 0,
                       z0: int = 0) -> torch.Tensor:
    """The full-domain flat boundary tensor (Fb, Kb, G) -> the box's
    ghosted window (Fb, Kb, GB). The box ghost ring at cell origin o starts
    at full-ghosted coordinate o (core cell x maps to ghosted x+1), so the
    window starts at the origin; ``x0`` and ``z0`` shift it by that many
    x- and z-planes (a block's window). One index_select over the flat
    cell axis, with indices built on the device: no host sync."""
    dev = bd.device
    ax = origin[0] + x0 + torch.arange(box.gx, device=dev)
    ay = origin[1] + torch.arange(box.gy, device=dev)
    az = origin[2] + z0 + torch.arange(box.gz, device=dev)
    flat = ((ax[:, None, None] * full.gy + ay[None, :, None]) * full.gz
            + az[None, None, :])
    return bd.index_select(2, flat.reshape(-1))


def slab_window(idx: BoxIndex, bd: torch.Tensor, full: DenseDims,
                box: DenseDims, box_b: DenseDims, slab: "halo.Slab"):
    """A rank's block of the box whose index is ``idx`` -> (its slot list
    (N,), the same in cell-major order (``BoxIndex.work``), its window
    dims, its boundary window dims, its boundary window (Fb, Kb, G_l) cut
    from the full-domain ``bd``)."""
    dims_b = slab.dims(box_b)
    return (halo.slab_slots(idx.slots, box, slab),
            halo.slab_slots(idx.work, box, slab), slab.dims(box), dims_b,
            slice_boundary_box(bd, full, dims_b, idx.origin, slab.x0,
                               slab.z0))
