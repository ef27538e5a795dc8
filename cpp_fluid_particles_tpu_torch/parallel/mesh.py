"""The rank mesh and the x-slab split of the box.

Port of ``cpp_fluid_particles_tpu/parallel/mesh.py``. The JAX package
shards the box's flat cell axis over an in-process device mesh and lets
GSPMD (or its shard_map halo engine) partition the passes. The port runs
one process per rank instead: a ``Mesh`` names the process group, this
rank, the rank count and the rank's device, and the box's core x-planes are
split into contiguous slabs, one per rank (``plane_split``). Each rank runs
the same solver code on its own slab (parallel/halo.py).

Activated via the ``spatial_sharding(mesh)`` context, or by handing the
mesh to ``Simulation(mesh=...)``; solver code is unchanged.

Not ported: the (gx, gz) 2-D mesh (``make_mesh2d`` raises), and the GSPMD
sharding annotations ``constrain_cells``, ``constrain_axis``,
``replicate`` and ``shard_particles``, whose work the explicit slab layout
does (ROADMAP.md).
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from . import distributed

AXIS = "cells"

# the communication strategies of cfg.halo_comm: "auto" and "shard_map"
# select the port's slab engine (one ghost-plane exchange per pass,
# N-sized traffic at the particle <-> grid boundary); "gspmd" has no
# counterpart, since PyTorch has no GSPMD
HALO_MODES = ("auto", "shard_map", "gspmd")


class Mesh(NamedTuple):
    """A 1-D mesh of ranks along the box's x axis."""

    group: Optional[object]   # the process group; None: one process, none
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]


_ACTIVE_MESH: ContextVar[Optional[Mesh]] = ContextVar("sph_mesh",
                                                      default=None)
_HALO_MODE: ContextVar[str] = ContextVar("sph_halo_mode", default="auto")


def check_halo_mode(halo: str) -> None:
    if halo == "gspmd":
        raise NotImplementedError(
            "halo_comm='gspmd' lets GSPMD infer the collectives, and "
            "PyTorch has no GSPMD; the port runs its slab engine "
            "('auto'/'shard_map', ROADMAP.md 'Not ported')")
    if halo not in HALO_MODES:
        raise ValueError(f"unknown halo_comm {halo!r}; one of {HALO_MODES}")


def make_mesh(n_devices: Optional[int] = None, *,
              backend: Optional[str] = None,
              device=None) -> Mesh:
    """The mesh of every rank of this job: initializes the process group
    from the environment contract where there is one
    (``distributed.ensure_initialized``); in a single process without one,
    a mesh of one rank that runs no collective. ``n_devices``, if given,
    must be the rank count. ``device``: this rank's device (default
    ``distributed.rank_device``: ``cuda:LOCAL_RANK`` under NCCL, else the
    CPU; "cuda" with no index is ``cuda:LOCAL_RANK``)."""
    live = distributed.ensure_initialized(backend=backend)
    if live:
        group, rank = dist.group.WORLD, dist.get_rank()
        size, backend = dist.get_world_size(), dist.get_backend()
    else:
        group, rank, size, backend = None, 0, 1, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): this job has {size} "
                         "rank(s), one per process; a mesh takes them all")
    dev = (torch.device(device) if device is not None
           else distributed.rank_device(backend))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", distributed.local_rank())
    return Mesh(group, rank, size, dev, backend)


def make_mesh2d(shape=(4, 2), devices=None):
    raise NotImplementedError(
        "the (gx, gz) 2-D mesh and its 5-D executor are not ported yet; "
        "the port runs the 1-D x-slab mesh (make_mesh, ROADMAP.md)")


def mesh_is_2d(mesh) -> bool:
    raise NotImplementedError(
        "the port has no 2-D mesh; every port Mesh is a 1-D x-slab mesh "
        "(ROADMAP.md)")


@contextlib.contextmanager
def spatial_sharding(mesh: Mesh, halo: str = "auto"):
    """While active, the solver steps run on this rank's x-slab of the box
    with one ghost-plane exchange before every pass; ``halo`` is
    cfg.halo_comm's value ("gspmd" raises)."""
    check_halo_mode(halo)
    token = _ACTIVE_MESH.set(mesh)
    htoken = _HALO_MODE.set(halo)
    try:
        yield
    finally:
        _HALO_MODE.reset(htoken)
        _ACTIVE_MESH.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _ACTIVE_MESH.get()


def current_halo_mode() -> str:
    return _HALO_MODE.get()


def mesh_devices(mesh: Mesh) -> int:
    return mesh.size


def plane_split(bx: int, size: int) -> List[Tuple[int, int]]:
    """The box's core x-planes [0, bx) cut into ``size`` contiguous slabs
    [x0, x1), one per rank, with ``distributed.tile``'s tiling: with fewer
    planes than ranks every rank but the last owns none."""
    return [(s.start, s.stop) for s in
            (distributed.tile(bx, size, r) for r in range(size))]
