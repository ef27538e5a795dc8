"""One rank of the port's ghost exchange check, on the CPU over gloo.

Launched once per rank by ``tests/test_torch_parallel.py`` (the 1-D mesh)
and ``tests/test_torch_parallel2d.py`` (the 2-D mesh) under the
environment contract (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK) with the output path as its argument, and for the 2-D mesh its
shape NXxNZ as the second. Every rank records, on
one device, the operands that the steps give each of the fourteen
particle-list passes on a jittered block resting on the floor with random
velocities (after one frame, so the operands that come from grid space are
real: DFSPH's Jacobi iterates, PBD's projected positions and lambda), and
each pass's single-device output. Then, under a mesh of every rank, each
rank cuts its block's window out of those operands, overwrites the ghost
cells that a neighbour owns with NaN (stale values: faces, and on the 2-D
mesh edges and corners), runs the pass through ``passes.column_pass``
under the block, and compares its own cells with the single-device output
bitwise. It also holds ``read_sharded`` (-0.0 included), ``whole`` and the
exact reductions against their single-device counterparts, also on boxes
of one x-plane or one z-plane, where a rank owns none. Writes a JSON
record to the output path.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cpp_fluid_particles_tpu_torch import parallel  # noqa: E402
from cpp_fluid_particles_tpu_torch.exp import mesh_run  # noqa: E402
from cpp_fluid_particles_tpu_torch.models import dense_step as ds  # noqa: E402
from cpp_fluid_particles_tpu_torch.ops import dense, passes as pp  # noqa: E402
from cpp_fluid_particles_tpu_torch.parallel import halo  # noqa: E402
from cpp_fluid_particles_tpu_torch.simulation import Simulation  # noqa: E402
from cpp_fluid_particles_tpu_torch.state import boundary_positions  # noqa: E402


class _Done(Exception):
    pass


class Recorder:
    """An executor that keeps the first call of every pass and runs the
    plain executor; it stops the step once ``stop`` has been called."""

    def __init__(self, calls, stop=None):
        self.calls, self.stop = calls, stop

    def __call__(self, name, fl, bd, dims, dims_b, cfg, islots=None):
        self.calls.setdefault(name, (fl, bd, dims, dims_b, islots, cfg))
        out = pp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)
        if name == self.stop:
            raise _Done
        return out


def _record(calls, step, sim, cfg, stop=None):
    dims, dims_b = sim._dims()
    try:
        step(sim.state, sim.carry, sim.scene, cfg, cfg.dt, dims, dims_b,
             sim.box, executor=Recorder(calls, stop))
    except _Done:
        pass


def record():
    """pass name -> (fl, bd, dims, dims_b, islots, cfg) of its first call
    on a path, on one device."""
    calls = {}
    for solver in ("wcsph", "dfsph", "pbd"):
        cfg, pos, vel = mesh_run.scene("floor", "parity", seed=0)
        if solver == "pbd":
            # two projection iterations are enough for every operand
            cfg = cfg.replace(pbd_max_iter=2)
        sim = Simulation(solver=solver, cfg=cfg, fluid_pos=pos, device="cpu")
        sim.state = sim.state._replace(vel=torch.as_tensor(vel))
        sim.step()
        off = cfg.replace(surface_tension=0.0, air_pressure=0.0)
        if solver == "wcsph":
            ds.build_dense_scene(cfg, boundary_positions(cfg), sim._kb,
                                 "cpu", executor=Recorder(calls))
            for c in (cfg, off):
                _record(calls, ds.wcsph_step, sim, c)
        elif solver == "dfsph":
            _record(calls, ds.dfsph_step, sim, cfg, stop="surface")
            _record(calls, ds.dfsph_step, sim, off, stop="viscosity")
        else:
            # PBD's stiffness_accel (on lambda) under its own name
            pbd_calls = {}
            for c in (cfg, off):
                _record(pbd_calls, ds.pbd_step, sim, c)
            calls["pbd_stiffness_accel"] = pbd_calls.pop("stiffness_accel")
            for name, call in pbd_calls.items():
                calls.setdefault(name, call)
    return calls


def window(x, slab, dims):
    """The block's window cells of a whole-grid tensor (F, K, G)."""
    v = x.reshape(x.shape[0], x.shape[1], dims.gx, dims.gy, dims.gz)
    return v[:, :, slab.x0:slab.x1 + 2, :, slab.z0:slab.z1 + 2].reshape(
        x.shape[0], x.shape[1], -1).contiguous()


def own(x, slab, dims, x0=0, z0=0):
    """The own cells [x0 + 1, x0 + 1 + planes) x [z0 + 1, ...) of a grid
    tensor (F, K, G) of ``dims``."""
    v = x.reshape(x.shape[0], x.shape[1], dims.gx, dims.gy, dims.gz)
    return v[:, :, x0 + 1:x0 + 1 + slab.x1 - slab.x0, :,
             z0 + 1:z0 + 1 + slab.z1 - slab.z0]


def bits(x):
    return x.contiguous().view(torch.int32)


def check_pass(name, call, mesh):
    fl, bd, dims, dims_b, islots, cfg = call
    pname = "stiffness_accel" if name == "pbd_stiffness_accel" else name
    want = pp.column_pass(pname, fl, bd, dims, dims_b, cfg, islots=islots)
    slab = halo.make_slab(mesh, dims.cx, dims.cz)
    fl_l = window(fl, slab, dims)
    ldims = slab.dims(dims)
    v = fl_l.view(fl.shape[0], fl.shape[1], ldims.gx, ldims.gy, ldims.gz)
    if slab.left is not None:
        v[:, :, 0] = float("nan")
    if slab.right is not None:
        v[:, :, -1] = float("nan")
    if slab.front is not None:
        v[..., 0] = float("nan")
    if slab.back is not None:
        v[..., -1] = float("nan")
    bd_l = window(bd, slab, dims) if bd is not None else None
    ldims_b = slab.dims(dims_b) if dims_b is not None else None
    islots_l = halo.slab_slots(islots, dims, slab)
    before = halo.COUNTS["exchanges"]
    with halo.slab_context(slab):
        got = pp.column_pass(pname, fl_l, bd_l, ldims, ldims_b, cfg,
                             islots=islots_l)
    mine = own(got, slab, ldims)
    ref = own(want, slab, dims, slab.x0, slab.z0)
    return {"bitwise": bool(torch.equal(bits(mine), bits(ref))),
            "max_abs": float((mine - ref).abs().nan_to_num(np.inf).max()),
            "exchanges": halo.COUNTS["exchanges"] - before,
            "planes": [slab.x0, slab.x1], "zplanes": [slab.z0, slab.z1],
            "peers": [slab.left, slab.right, slab.front, slab.back],
            "nonzero": int((ref != 0).sum())}


def check_boundary(mesh, cx, cz=5):
    """read_sharded keeps -0.0; whole and the reductions equal their
    single-device counterparts, on a box of ``cx`` core x-planes and
    ``cz`` core z-planes (with fewer planes than ranks on an axis, a rank
    owns none)."""
    rng = np.random.default_rng(3)
    dims = dense.DenseDims(cx, 4, cz, 3)
    x = torch.as_tensor(rng.normal(size=(2, dims.k, dims.g)).astype(
        np.float32))
    x[x.abs() < 0.3] = -0.0
    # particles sit in the core planes; every 7th is invalid
    slots = torch.as_tensor(rng.choice(dims.k * dims.g, 150, replace=False))
    plane = slots % dims.g // (dims.gy * dims.gz)
    slots = slots[(plane > 0) & (plane < dims.gx - 1)]
    slots[::7] = dims.k * dims.g
    idx = dense.DenseIndex(slots=slots, valid=slots < dims.k * dims.g,
                           overflow=None, max_occupancy=None)
    slab = halo.make_slab(mesh, dims.cx, dims.cz)
    lslots = halo.slab_slots(slots, dims, slab)
    got = torch.where(idx.valid[None, :],
                      halo.read_sharded(window(x, slab, dims), lslots, mesh),
                      0.0)
    want = dense.read_dense(idx, x)
    xl = window(x, slab, dims)
    return {
        "read_sharded": bool(torch.equal(bits(got), bits(want))),
        "negative_zeros": int((torch.signbit(want) & (want == 0)).sum()),
        "whole": bool(torch.equal(bits(halo.whole(xl, slab)), bits(x))),
        "any": bool(halo.reduce_any(xl > 2.5, slab)) == bool(
            torch.any(x > 2.5)),
        "max": bool(halo.reduce_max(xl, slab) == torch.max(x)),
        "sum": int(halo.reduce_sum(xl > 0, slab)) == int((x > 0).sum()),
        "empty": slab.empty}


def main():
    torch.set_num_threads(1)
    assert parallel.distributed.is_multiprocess_env()
    assert parallel.distributed.ensure_initialized() is True
    assert parallel.distributed.ensure_initialized() is True   # idempotent
    if len(sys.argv) > 2:
        shape = tuple(int(a) for a in sys.argv[2].split("x"))
        mesh = parallel.make_mesh2d(shape, device="cpu")
        boxes = {f"{cx}x{cz}": (cx, cz)
                 for cx, cz in ((6, 5), (6, 1), (1, 5), (1, 1))}
    else:
        mesh = parallel.make_mesh(device="cpu")
        boxes = {str(cx): (cx, 5) for cx in (6, 1)}
    assert mesh.size == int(os.environ["WORLD_SIZE"])
    assert mesh.rank == parallel.distributed.process_index()
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "axes": list(mesh.axes), "coords": list(mesh.coords()),
           "slice": [parallel.distributed.local_device_slice(101).start,
                     parallel.distributed.local_device_slice(101).stop]}
    calls = record()
    out["passes"] = {name: check_pass(name, call, mesh)
                     for name, call in sorted(calls.items())}
    out["boundary"] = {key: check_boundary(mesh, *box)
                       for key, box in boxes.items()}
    torch.distributed.destroy_process_group()
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
