"""Multi-process plumbing over ``torch.distributed``.

Port of ``cpp_fluid_particles_tpu/parallel/distributed.py``. The JAX
package runs one controller over many devices and bootstraps the JAX
multi-controller runtime for pod slices; PyTorch has no single-controller
mesh, so the port runs one process per rank (SPMD), each on its own block
of the box (parallel/halo.py), with explicit collectives.

This module is the bootstrap. It is a no-op in single-process runs, so it
is safe to call unconditionally at program start:

    from cpp_fluid_particles_tpu_torch.parallel import distributed
    distributed.ensure_initialized()     # no-op unless multi-process env
    mesh = parallel.make_mesh()          # one rank per process

Environment contract (the one ``torchrun`` sets): ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``. Explicit
arguments win over it. A rank's device is ``cuda:LOCAL_RANK`` unless
the caller asks for the CPU; the backend follows the device, ``nccl`` on a
card and ``gloo`` on the CPU, unless the caller names one.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def is_multiprocess_env() -> bool:
    """True when this process is part of a declared multi-process job."""
    return os.environ.get("WORLD_SIZE", "1") not in ("", "1")


def default_backend(device=None) -> str:
    """``nccl`` for a CUDA ``device``, ``gloo`` for the CPU; with no
    device, ``nccl`` where this process sees a card, else ``gloo``."""
    if device is not None:
        return "nccl" if torch.device(device).type == "cuda" else "gloo"
    return "nccl" if torch.cuda.is_available() else "gloo"


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0") or 0)


def ensure_initialized(backend: Optional[str] = None,
                       init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> bool:
    """Initialize the default process group if (and only if) this is a
    multi-process job, or the caller names the group. Returns True when a
    process group is live; idempotent.

    With no ``init_method``, ``world_size`` or ``rank`` given and
    ``WORLD_SIZE`` unset or 1, this is a no-op returning False. Otherwise
    each missing argument comes from the environment contract
    (``init_method`` "env://", which reads ``MASTER_ADDR`` and
    ``MASTER_PORT``)."""
    if dist.is_initialized():
        return True
    explicit = (init_method is not None or world_size is not None
                or rank is not None)
    if not explicit and not is_multiprocess_env():
        return False
    backend = backend or default_backend()
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def tile(n: int, count: int, index: int) -> slice:
    """Piece ``index`` of [0, n) cut into ``count`` contiguous pieces: each
    takes n // count, the last also the remainder (the JAX package's
    ``local_device_slice`` tiling)."""
    per = n // count
    lo = index * per
    return slice(lo, n if index == count - 1 else lo + per)


def local_device_slice(n: int) -> slice:
    """The contiguous range of [0, n) owned by this process — handy for
    scene construction that only materialises the local shard of a very
    large particle set."""
    return tile(n, process_count(), process_index())


def rank_device() -> torch.device:
    """This process's default device, ``cuda:LOCAL_RANK``, whatever the
    backend: a rank runs on the CPU only when its caller asks for it."""
    return torch.device("cuda", local_rank())
