"""The x-slab engine: each rank's window of the box, the ghost-plane
exchange before every pass, and N-sized traffic at the particle <-> grid
boundary.

Port of ``cpp_fluid_particles_tpu/parallel/halo.py`` and of the halo
executor ``column_pass_halo_sym`` (ops/pallas_passes.py:407-521), for one
process per rank:

* The particle state stays replicated, so every rank builds the same box
  index from the same state with no collective, and every capacity
  decision comes out the same on every rank.
* Rank r owns the box's core x-planes [x0, x1) (``mesh.plane_split``). Its
  window is an ordinary ghosted box, ``DenseDims(x1 - x0, BY, BZ, K)``:
  the box's ghosted planes [x0, x1 + 2). Its slot list (``slab_slots``)
  names only its own particles; the fill scatters them, the passes run on
  them, and the rank reads them back.
* ``exchange``: before every pass the two ghost x-planes of the pass's
  operand stack are refreshed from the neighbours' edge planes (at either
  end of the box they keep the box's own ghost plane). An operand computed
  in grid space is stale in the ghost planes otherwise. The pass then
  reads, for each own slot, bitwise the bytes the single-device pass
  reads, so its outputs on the own planes are bitwise the same.
* ``read_sharded``: each rank reads its own particles; an all-reduce SUM
  over the int32 bit patterns, with zero words for the particles a rank
  does not own, gives every rank the (F, N) result. Exactly one rank owns
  each valid slot, so a stored -0.0 survives.
* The host's decisions read values that are bitwise those of the
  single-device run: ``whole`` gathers the own planes (and the box's two
  outer ghost planes) into the whole box's layout, for a float sum whose
  order must not change; ``reduce_any``, ``reduce_max`` and ``reduce_sum``
  are exact all-reduces (MAX, or SUM of integers) over the same planes.

Collectives: NCCL for CUDA tensors, gloo for CPU ones. Gloo takes
``all_reduce`` on CUDA tensors but not ``all_gather`` or point-to-point;
for those the gloo branch stages through host memory (``STAGED`` names
what it staged). ``COUNTS`` counts the exchanges, the bytes each rank sent
in them, and the other collectives.
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
    """Rank ``mesh.rank``'s x-slab of a box of ``bx`` core x-planes."""

    mesh: Mesh
    split: Tuple[Tuple[int, int], ...]   # every rank's [x0, x1)
    left: Optional[int]    # the rank owning core plane x0 - 1, if any
    right: Optional[int]   # the rank owning core plane x1, if any

    @property
    def x0(self) -> int:
        return self.split[self.mesh.rank][0]

    @property
    def x1(self) -> int:
        return self.split[self.mesh.rank][1]

    @property
    def empty(self) -> bool:
        return self.x1 == self.x0

    @property
    def gx(self) -> int:
        """Ghosted x-planes of the window."""
        return self.x1 - self.x0 + 2

    def keep(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """The window planes [lo, hi) that ``rank`` contributes to a
        whole-box tensor: its own planes, and the box's outer ghost plane
        at either end (rank 0 and the last rank)."""
        r = self.mesh.rank if rank is None else rank
        x0, x1 = self.split[r]
        return (0 if r == 0 else 1,
                x1 - x0 + (2 if r == self.mesh.size - 1 else 1))

    def dims(self, box: DenseDims) -> DenseDims:
        """The window's dims in a box of dims ``box``."""
        return DenseDims(self.x1 - self.x0, box.cy, box.cz, box.k)


def make_slab(mesh: Mesh, bx: int) -> Slab:
    split = tuple(plane_split(bx, mesh.size))
    x0, x1 = split[mesh.rank]

    def owner(plane):
        return next(r for r, (a, b) in enumerate(split) if a <= plane < b)

    own = x1 > x0
    return Slab(mesh, split,
                owner(x0 - 1) if own and x0 > 0 else None,
                owner(x1) if own and x1 < bx else None)


_SLAB: ContextVar[Optional[Slab]] = ContextVar("sph_slab", default=None)


@contextlib.contextmanager
def slab_context(slab: Slab):
    """While active, ops/passes.column_pass takes its operands as this
    slab's window and refreshes their ghost planes before every pass."""
    token = _SLAB.set(slab)
    try:
        yield slab
    finally:
        _SLAB.reset(token)


def current_slab() -> Optional[Slab]:
    return _SLAB.get()


def slab_slots(slots: torch.Tensor, box: DenseDims,
               slab: Slab) -> torch.Tensor:
    """Slots into the whole ghosted box (K, G) -> slots into the slab's
    window (K, G_l) for the particles on the slab's own planes; every other
    particle takes the window's trash slot K*G_l."""
    gyz = box.gy * box.gz
    gl = slab.gx * gyz
    kk = slots // box.g
    cell = slots - kk * box.g
    x = cell // gyz
    own = (slots < box.k * box.g) & (x > slab.x0) & (x <= slab.x1)
    return torch.where(own, kk * gl + cell - slab.x0 * gyz, box.k * gl)


def _planes(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """(..., G_l) -> the (..., gx, GY*GZ) plane view."""
    return x.reshape(*x.shape[:-1], slab.gx, -1)


def kept(x: torch.Tensor, slab: Slab) -> torch.Tensor:
    """The planes of ``x`` (..., G_l) this rank contributes to the whole
    box: (..., planes, GY*GZ)."""
    lo, hi = slab.keep()
    return _planes(x, slab)[..., lo:hi, :]


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

def exchange(fl: torch.Tensor, slab: Slab) -> torch.Tensor:
    """Refresh the two ghost x-planes of the window operand ``fl``
    (F, K, G_l), in place: plane 0 from the left neighbour's last own
    plane, plane gx-1 from the right neighbour's first. A plane with no
    neighbour (the box's own ghost plane) is left as it is."""
    peers = [p for p in (slab.left, slab.right) if p is not None]
    if not peers:
        return fl
    v = _planes(fl, slab)
    ends = {slab.left: (1, 0), slab.right: (slab.gx - 2, slab.gx - 1)}
    sends = [(v[..., ends[p][0], :].contiguous(), p) for p in peers]
    got = _send_recv(slab.mesh, sends, peers, sends[0][0])
    for p, plane in zip(peers, got):
        v[..., ends[p][1], :] = plane
    COUNTS["exchanges"] += 1
    COUNTS["exchange_bytes"] += sum(t.numel() * t.element_size()
                                    for t, _ in sends)
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
    own planes and the box's two outer ghost planes, in the layout of the
    single-device tensor, on every rank."""
    mine = kept(x, slab)
    sizes = [hi - lo for lo, hi in map(slab.keep, range(slab.mesh.size))]
    pad = mine.new_zeros(mine.shape[:-2] + (max(sizes), mine.shape[-1]))
    pad[..., :mine.shape[-2], :] = mine
    parts = all_gather(pad, slab.mesh)
    return torch.cat([p[..., :n, :] for p, n in zip(parts, sizes)],
                     -2).reshape(x.shape[:-1] + (-1,))


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
