"""The rank mesh and the split of the box into blocks, one per rank.

Port of ``cpp_fluid_particles_tpu/parallel/mesh.py``. The JAX package
shards the box's cell axes over an in-process device mesh and lets GSPMD
(or its shard_map halo engine) partition the passes. The port runs one
process per rank instead: a ``Mesh`` names the process group, this rank,
the rank count, the rank's device and the mesh's axes. Each rank runs the
same solver code on its own block of the box (parallel/halo.py):

* ``make_mesh``: the 1-D mesh, axis ``"cells"``. The box's core x-planes
  are split into contiguous slabs, one per rank (``plane_split``).
* ``make_mesh2d((nx, nz))``: the (gx, gz) 2-D mesh, axes ``AXES_2D``.
  ``plane_split`` cuts the core x-planes into nx pieces and the core
  z-planes into nz; rank r owns x-piece r // nz and z-piece r % nz (the
  JAX package's ``reshape(nx, nz)``), and all of y.

Activated via the ``spatial_sharding(mesh)`` context, or by handing the
mesh to ``Simulation(mesh=...)``; solver code is unchanged.

Not ported: the GSPMD sharding annotations ``constrain_cells``,
``constrain_axis``, ``replicate`` and ``shard_particles``, whose work the
explicit block layout does, and the 5-D executor of the JAX package's 2-D
mesh, whose work the block's window does with the unchanged pass kernel
(ROADMAP.md).
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from . import distributed

AXIS = "cells"
# the 2-D mesh's axes: ranks along the box's x and z axes
AXES_2D = ("gx", "gz")

# the communication strategies of cfg.halo_comm: "auto" and "shard_map"
# select the port's block engine (one ghost exchange per pass, N-sized
# traffic at the particle <-> grid boundary); "gspmd" has no counterpart,
# since PyTorch has no GSPMD
HALO_MODES = ("auto", "shard_map", "gspmd")


class Mesh(NamedTuple):
    """A mesh of ranks: 1-D along the box's x axis (axes ``(AXIS,)``), or
    2-D along its x and z axes (``AXES_2D``, ``shape`` (nx, nz))."""

    group: Optional[object]   # the process group; None: one process, none
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]
    axes: Tuple[str, ...] = (AXIS,)
    shape: Tuple[int, ...] = ()   # ranks per axis; () stands for (size,)

    @property
    def blocks(self) -> Tuple[int, int]:
        """Ranks along the box's x and z axes: (size, 1) on a 1-D mesh."""
        return (tuple(self.shape) if len(self.axes) == 2
                else (self.size, 1))

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """The (x, z) place of ``rank`` (default this one) in ``blocks``."""
        return divmod(self.rank if rank is None else rank, self.blocks[1])


_ACTIVE_MESH: ContextVar[Optional[Mesh]] = ContextVar("sph_mesh",
                                                      default=None)
_HALO_MODE: ContextVar[str] = ContextVar("sph_halo_mode", default="auto")


def check_halo_mode(halo: str) -> None:
    if halo == "gspmd":
        raise NotImplementedError(
            "halo_comm='gspmd' lets GSPMD infer the collectives, and "
            "PyTorch has no GSPMD; the port runs its block engine "
            "('auto'/'shard_map', ROADMAP.md 'Not ported')")
    if halo not in HALO_MODES:
        raise ValueError(f"unknown halo_comm {halo!r}; one of {HALO_MODES}")


def _job(backend: Optional[str], device):
    """This rank's (group, rank, size, device, backend): the process group
    from the environment contract where there is one; in a single process
    without one, no group. ``device`` defaults to ``cuda:LOCAL_RANK``
    ("cuda" with no index is that card too), whatever the backend; the
    backend defaults to the device's (``distributed.default_backend``)."""
    dev = (torch.device(device) if device is not None
           else distributed.rank_device())
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", distributed.local_rank())
    live = distributed.ensure_initialized(
        backend=backend or distributed.default_backend(dev))
    if live:
        return (dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                dev, dist.get_backend())
    return None, 0, 1, dev, None


def make_mesh(n_devices: Optional[int] = None, *,
              backend: Optional[str] = None,
              device=None) -> Mesh:
    """The 1-D mesh of every rank of this job (``_job``: the process
    group, this rank's device and the backend). ``n_devices``, if given,
    must be the rank count."""
    group, rank, size, dev, backend = _job(backend, device)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): this job has {size} "
                         "rank(s), one per process; a mesh takes them all")
    return Mesh(group, rank, size, dev, backend, (AXIS,), (size,))


def make_mesh2d(shape=(4, 2), *, backend: Optional[str] = None,
                device=None) -> Mesh:
    """The (gx, gz) 2-D mesh of every rank of this job: ``shape`` (nx, nz)
    ranks along the box's x and z axes, rank r at (r // nz, r % nz).
    nx * nz must be the rank count. Process group, device and backend as
    ``make_mesh``."""
    nx, nz = (int(a) for a in shape)
    group, rank, size, dev, backend = _job(backend, device)
    if nx < 1 or nz < 1 or nx * nz != size:
        raise ValueError(f"make_mesh2d({(nx, nz)}): this job has {size} "
                         "rank(s), one per process; a mesh takes them all")
    return Mesh(group, rank, size, dev, backend, AXES_2D, (nx, nz))


def mesh_is_2d(mesh: Optional[Mesh]) -> bool:
    """True for a mesh of ``make_mesh2d``; False for a 1-D mesh or None."""
    return mesh is not None and len(mesh.axes) == 2


@contextlib.contextmanager
def spatial_sharding(mesh: Mesh, halo: str = "auto"):
    """While active, the solver steps run on this rank's block of the box
    with one ghost exchange before every pass; ``halo`` is
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
    """The box's core planes [0, bx) along one axis cut into ``size``
    contiguous pieces [x0, x1), one per rank along that axis, with
    ``distributed.tile``'s tiling: with fewer planes than ranks every rank
    but the last owns none."""
    return [(s.start, s.stop) for s in
            (distributed.tile(bx, size, r) for r in range(size))]
