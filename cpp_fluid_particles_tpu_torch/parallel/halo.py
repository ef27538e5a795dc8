"""The block engine: each rank's window of the box, the ghost exchange
before every pass, and N-sized traffic at the particle <-> grid boundary.

Port of ``cpp_fluid_particles_tpu/parallel/halo.py``, of the halo executor
``column_pass_halo_sym`` (ops/pallas_passes.py:407-521) and, for the 2-D
mesh, of the (x, z)-slab executor ``column_pass_xla_sym_5d`` (:524-590),
for one process per rank:

* The particle state stays replicated, so every rank builds the same box
  index from the same state with no collective, and every capacity
  decision comes out the same on every rank.
* Rank r owns a block of the box: the core x-planes [x0, x1) and core
  z-planes [z0, z1) that ``mesh.plane_split`` gives its place on each axis
  of the mesh (a 1-D mesh is the (n, 1) mesh: every rank owns all of z),
  and all of y. Its window is an ordinary ghosted box,
  ``DenseDims(x1 - x0, BY, z1 - z0, K)``: the box's ghosted planes
  [x0, x1 + 2) and [z0, z1 + 2). Its slot list (``slab_slots``) names only
  its own particles; the fill scatters them, the passes run on them, and
  the rank reads them back.
* ``exchange``: before every pass the ghost cells of the pass's operand
  stack that a neighbour owns are refreshed, in two phases: the x phase
  sends each x-neighbour the window's edge x-plane (every z of it), then
  the z phase sends each z-neighbour the edge z-plane of the x-refreshed
  window, so the diagonal (±1, ·, ±1) cells arrive through the z-neighbour
  from the diagonal rank. At the box's ends the window keeps the box's own
  ghost planes. An operand computed in grid space is stale in the ghost
  cells otherwise. The pass then reads, for each own slot, bitwise the
  bytes the single-device pass reads, so its outputs on the own cells are
  bitwise the same.
* ``read_sharded``: each rank reads its own particles; an all-reduce SUM
  over the int32 bit patterns, with zero words for the particles a rank
  does not own, gives every rank the (F, N) result. Exactly one rank owns
  each valid slot, so a stored -0.0 survives.
* The host's decisions read values that are bitwise those of the
  single-device run: ``whole`` gathers the own cells (and the box's outer
  ghost planes) into the whole box's layout, for a float sum whose order
  must not change; ``reduce_any``, ``reduce_max`` and ``reduce_sum`` are
  exact all-reduces (MAX, or SUM of integers) over the same cells.

Collectives: NCCL for CUDA tensors, gloo for CPU ones. Gloo takes
``all_reduce`` on CUDA tensors but not ``all_gather`` or point-to-point;
for those the gloo branch stages through host memory (``STAGED`` names
what it staged). ``COUNTS`` counts the exchanges (one per pass that moved
anything), the bytes each rank sent in them, in all and per axis
(``exchange_bytes_x``, ``exchange_bytes_z``), and the other collectives.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from contextvars import ContextVar
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.dense import DenseDims
from .mesh import Mesh, plane_split

COUNTS: Counter = Counter()
STAGED: set = set()


def reset_counts() -> None:
    COUNTS.clear()


class Slab(NamedTuple):
    """Rank ``mesh.rank``'s block of a box of ``bx`` core x-planes and
    (where given) ``bz`` core z-planes: an x-slab on a 1-D mesh."""

    mesh: Mesh
    split: Tuple[Tuple[int, int], ...]   # [x0, x1) of each x place
    left: Optional[int]    # the rank owning core plane x0 - 1, if any
    right: Optional[int]   # the rank owning core plane x1, if any
    zsplit: Optional[Tuple[Tuple[int, int], ...]] = None  # [z0, z1) of
    # each z place; None: only the x split is known (make_slab without bz)
    front: Optional[int] = None   # the rank owning core z-plane z0 - 1
    back: Optional[int] = None    # the rank owning core z-plane z1

    @property
    def x0(self) -> int:
        return self.split[self.mesh.coords()[0]][0]

    @property
    def x1(self) -> int:
        return self.split[self.mesh.coords()[0]][1]

    @property
    def z0(self) -> int:
        return self.zsplit[self.mesh.coords()[1]][0]

    @property
    def z1(self) -> int:
        return self.zsplit[self.mesh.coords()[1]][1]

    @property
    def empty(self) -> bool:
        return self.x1 == self.x0 or (self.zsplit is not None
                                      and self.z1 == self.z0)

    @property
    def gx(self) -> int:
        """Ghosted x-planes of the window."""
        return self.x1 - self.x0 + 2

    @property
    def gz(self) -> int:
        """Ghosted z-planes of the window."""
        return self.z1 - self.z0 + 2

    def keep(self, place: Optional[int] = None,
             axis: str = "x") -> Tuple[int, int]:
        """The window planes [lo, hi) along ``axis`` ("x" or "z") that the
        blocks at ``place`` on that axis (default this rank's; on a 1-D
        mesh the place is the rank) contribute to a whole-box tensor: their
        own planes, and the box's outer ghost plane at either end (the
        first and the last place)."""
        a = "xz".index(axis)
        i = self.mesh.coords()[a] if place is None else place
        split = (self.split, self.zsplit)[a]
        lo, hi = split[i]
        return (0 if i == 0 else 1,
                hi - lo + (2 if i == len(split) - 1 else 1))

    def dims(self, box: DenseDims) -> DenseDims:
        """The window's dims in a box of dims ``box``."""
        return DenseDims(self.x1 - self.x0, box.cy, self.z1 - self.z0,
                         box.k)


def make_slab(mesh: Mesh, bx: int, bz: Optional[int] = None) -> Slab:
    """Rank ``mesh.rank``'s block of a box of ``bx`` core x-planes and
    ``bz`` core z-planes (``plane_split`` on each axis of the mesh; a 1-D
    mesh does not split z). Without ``bz`` only the x split is known,
    which is all a 1-D mesh's split needs; the window's dims need it. A
    block that owns no cell has no neighbour."""
    nx, nz = mesh.blocks
    ix, iz = mesh.coords()
    split = tuple(plane_split(bx, nx))
    if bz is None and nz != 1:
        raise ValueError("a 2-D mesh's block needs the box's core z-planes "
                         "(bz)")
    zsplit = None if bz is None else tuple(plane_split(bz, nz))
    own = split[ix][1] > split[ix][0] and (
        zsplit is None or zsplit[iz][1] > zsplit[iz][0])

    def peers(split, i, n, rank_of):
        """The ranks owning the planes just below and just above place
        ``i``'s own along one axis."""
        lo, hi = split[i]

        def owner(plane):
            return rank_of(next(j for j, (a, b) in enumerate(split)
                                if a <= plane < b))

        return (owner(lo - 1) if own and lo > 0 else None,
                owner(hi) if own and hi < n else None)

    left, right = peers(split, ix, bx, lambda j: j * nz + iz)
    if zsplit is None:
        return Slab(mesh, split, left, right)
    front, back = peers(zsplit, iz, bz, lambda j: ix * nz + j)
    return Slab(mesh, split, left, right, zsplit, front, back)


_SLAB: ContextVar[Optional[Slab]] = ContextVar("sph_slab", default=None)


@contextlib.contextmanager
def slab_context(slab: Slab):
    """While active, ops/passes.column_pass takes its operands as this
    block's window and refreshes their ghost cells before every pass."""
    token = _SLAB.set(slab)
    try:
        yield slab
    finally:
        _SLAB.reset(token)


def current_slab() -> Optional[Slab]:
    return _SLAB.get()


def slab_slots(slots: torch.Tensor, box: DenseDims,
               slab: Slab) -> torch.Tensor:
    """Slots into the whole ghosted box (K, G) -> slots into the block's
    window (K, G_l) for the particles in the cells the block contributes
    to the whole box (``kept``: its own cells; a particle sits in a core
    cell, so exactly one block holds it); every other particle takes the
    window's trash slot K*G_l."""
    gl = slab.gx * box.gy * slab.gz
    kk = slots // box.g
    cell = slots - kk * box.g
    xy, z = cell // box.gz, cell % box.gz
    x, y = xy // box.gy, xy % box.gy
    (xlo, xhi), (zlo, zhi) = slab.keep(), slab.keep(axis="z")
    x, z = x - slab.x0, z - slab.z0
    own = ((slots < box.k * box.g) & (x >= xlo) & (x < xhi) & (z >= zlo)
           & (z < zhi))
    return torch.where(own, kk * gl + (x * box.gy + y) * slab.gz + z,
                       box.k * gl)


def _cells(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """(..., G_l) -> the (..., gx, GY, gz) cell view."""
    return x.reshape(*x.shape[:-1], slab.gx, -1, slab.gz)


def kept(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """The cells of ``x`` (..., G_l) this rank contributes to the whole
    box: (..., x-planes, GY, z-planes)."""
    (xlo, xhi), (zlo, zhi) = slab.keep(), slab.keep(axis="z")
    return _cells(x, slab)[..., xlo:xhi, :, zlo:zhi]


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------

def _staged(mesh: Mesh, t: torch.Tensor, what: str) -> bool:
    """Gloo runs ``what`` on CPU tensors only: stage CUDA ones."""
    if mesh.backend == "gloo" and t.is_cuda:
        STAGED.add(what)
        return True
    return False


def all_reduce(t: torch.Tensor, op, mesh: Mesh) -> torch.Tensor:
    """In-place all-reduce of ``t`` over the mesh (none for a mesh without
    a process group)."""
    if mesh.group is not None:
        dist.all_reduce(t, op=op, group=mesh.group)
        COUNTS["all_reduce"] += 1
        COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()
    return t


def all_gather(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape on every rank), in rank order."""
    if mesh.group is None:
        return [t]
    dev = t.device
    if _staged(mesh, t, "all_gather"):
        t = t.cpu()
    out = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(out, t.contiguous(), group=mesh.group)
    COUNTS["all_gather"] += 1
    COUNTS["all_gather_bytes"] += t.numel() * t.element_size() * mesh.size
    return [o.to(dev) for o in out]


def _send_recv(mesh: Mesh, sends, recv_from, like: torch.Tensor):
    """Point-to-point: send each (tensor, peer) of ``sends`` and receive one
    tensor shaped like ``like`` from each peer of ``recv_from``."""
    dev = like.device
    if _staged(mesh, like, "send/recv"):
        sends = [(t.cpu(), p) for t, p in sends]
        like = like.cpu()
    recvs = [torch.empty_like(like) for _ in recv_from]
    if mesh.backend == "nccl":
        ops = ([dist.P2POp(dist.isend, t, p, mesh.group) for t, p in sends]
               + [dist.P2POp(dist.irecv, r, p, mesh.group)
                  for r, p in zip(recvs, recv_from)])
        works = dist.batch_isend_irecv(ops)
    else:
        works = ([dist.isend(t, p, group=mesh.group) for t, p in sends]
                 + [dist.irecv(r, p, group=mesh.group)
                    for r, p in zip(recvs, recv_from)])
    for w in works:
        w.wait()
    return [r.to(dev) for r in recvs]


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------

def _phase(v: torch.Tensor, slab: Slab, lo: Optional[int],
           hi: Optional[int], axis: str) -> int:
    """One phase of ``exchange`` along ``axis`` of the cell view ``v``
    (..., gx, GY, gz), in place: ghost plane 0 from the ``lo`` peer's
    last own plane, the last ghost plane from the ``hi`` peer's first.
    Returns the bytes sent."""
    peers = [p for p in (lo, hi) if p is not None]
    if not peers:
        return 0
    dim = -3 if axis == "x" else -1
    n = v.shape[dim]
    ends = {lo: (1, 0), hi: (n - 2, n - 1)}
    sends = [(v.select(dim, ends[p][0]).contiguous(), p) for p in peers]
    got = _send_recv(slab.mesh, sends, peers, sends[0][0])
    for p, plane in zip(peers, got):
        v.select(dim, ends[p][1]).copy_(plane)
    sent = sum(t.numel() * t.element_size() for t, _ in sends)
    COUNTS[f"exchanges_{axis}"] += 1
    COUNTS[f"exchange_bytes_{axis}"] += sent
    return sent


def exchange(fl: torch.Tensor, slab: Slab) -> torch.Tensor:
    """Refresh the ghost cells a neighbour owns of the window operand
    ``fl`` (F, K, G_l), in place: the x phase (ghost x-planes from the
    x-neighbours' edge x-planes), then the z phase over the x-refreshed
    window (ghost z-planes, their x-ghost cells included, from the
    z-neighbours' edge z-planes). A plane with no neighbour (the box's own
    ghost plane) is left as it is."""
    v = _cells(fl, slab)
    sent = (_phase(v, slab, slab.left, slab.right, "x")
            + _phase(v, slab, slab.front, slab.back, "z"))
    if sent:
        COUNTS["exchanges"] += 1
        COUNTS["exchange_bytes"] += sent
    return fl


def read_sharded(dense: torch.Tensor, slots: torch.Tensor,
                 mesh: Mesh) -> torch.Tensor:
    """(F, K, G_l) window grid -> (F, N) per-particle values on every
    rank, N-sized traffic only: each rank takes its own slots (``slots``
    from ``slab_slots``; others contribute zero words) and an all-reduce
    SUM over the int32 bit patterns combines them. Particles no rank owns
    read 0.0; the caller applies its valid mask as after the single-device
    gather."""
    flat = dense.reshape(dense.shape[0], -1)
    own = slots < flat.shape[1]
    taken = flat[:, slots.clamp(max=flat.shape[1] - 1)]
    bits = torch.where(own[None, :], taken.view(torch.int32), 0)
    return all_reduce(bits, dist.ReduceOp.SUM, mesh).view(torch.float32)


def whole(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """A window tensor (..., G_l) -> the whole box's (..., G): every rank's
    own cells and the box's outer ghost planes, in the layout of the
    single-device tensor, on every rank."""
    mesh = slab.mesh
    nx, nz = mesh.blocks
    mine = kept(x, slab)
    sx = [hi - lo for lo, hi in (slab.keep(i) for i in range(nx))]
    sz = [hi - lo for lo, hi in (slab.keep(j, "z") for j in range(nz))]
    pad = mine.new_zeros(mine.shape[:-3] + (max(sx), mine.shape[-2],
                                            max(sz)))
    pad[..., :mine.shape[-3], :, :mine.shape[-1]] = mine
    parts = all_gather(pad, mesh)
    rows = [torch.cat([parts[i * nz + j][..., :sx[i], :, :sz[j]]
                       for j in range(nz)], -1) for i in range(nx)]
    return torch.cat(rows, -3).reshape(x.shape[:-1] + (-1,))


def reduce_any(mask: torch.Tensor, slab: Slab) -> torch.Tensor:
    """``torch.any`` of the whole box's ``mask``, on every rank (0-d)."""
    m = kept(mask, slab).any().to(torch.int32)
    return all_reduce(m, dist.ReduceOp.MAX, slab.mesh) > 0


def reduce_max(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """``torch.max`` of the whole box's ``x``, on every rank (0-d): a MAX
    all-reduce is exact."""
    k = kept(x, slab)
    m = (k.amax() if k.numel()
         else torch.full((), float("-inf"), dtype=x.dtype, device=x.device))
    return all_reduce(m, dist.ReduceOp.MAX, slab.mesh)


def reduce_sum(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """The sum of the whole box's integer (or bool) ``x``, on every rank:
    exact in any order."""
    s = kept(x, slab).sum()
    return all_reduce(s, dist.ReduceOp.SUM, slab.mesh)


def check_eligible(mesh, device: torch.device) -> torch.device:
    """The engine takes a port ``Mesh`` whose device is ``device`` ("cuda"
    with no index stands for any card), and NCCL only on CUDA; anything
    else raises, for there is no single-device fallback. Returns the
    mesh's device."""
    if not isinstance(mesh, Mesh):
        raise ValueError(f"mesh must be a parallel.Mesh (make_mesh), got "
                         f"{type(mesh).__name__}")
    if (device.type != mesh.device.type
            or device.index not in (None, mesh.device.index)):
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.device}")
    if mesh.backend == "nccl" and mesh.device.type != "cuda":
        raise ValueError(f"an NCCL mesh needs a CUDA device, not "
                         f"{mesh.device}")
    return mesh.device
