"""One rank of a mesh run, or the single-device run it is held to.

    python -m cpp_fluid_particles_tpu_torch.exp.mesh_run --out OUT.npz \\
        [--device cpu|cuda|cuda:N] [--backend gloo|nccl] [--single] \\
        [--mesh2d NXxNZ] CASE [CASE ...]

A CASE is ``solver:scene:frames``: solver ``wcsph``, ``dfsph`` or ``pbd``,
with ``-fast`` for the config's fast mode (parity otherwise) and ``-off``
for surface tension and air pressure 0, so that the steps take their
surface-off passes (``dfsph-fast-off``); scene
``block`` (the 6x6x6 block of the JAX package's mesh tests in a 13-cell
domain), ``splash`` (that block stretched upwards, its top layer at 28 m/s, so the
box refits within a few frames), ``floor`` (a jittered 7x7x7 block
resting on the floor with random velocities: real work for the solvers'
loops), ``tank`` (the 6x6x6 block of the JAX package's 2-D mesh test,
tests/test_parallel.py, in the dam's domain), ``dam`` (the 20,736-particle
dam) or
``scaled<N>`` (``scaled_dam_scene(N)``, the README's multi-GPU recipe at
N = 1000000). Each case runs ``Simulation(solver, cfg, fluid_pos,
device, mesh)`` frame by frame at the config's dt.

Without ``--single`` the process is one rank under the environment
contract of ``parallel.distributed`` (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; ``torchrun`` sets them), and a
process group is made even for one rank; the mesh is the 1-D x-slab mesh,
or with ``--mesh2d NXxNZ`` the (gx, gz) 2-D mesh of NX x NZ ranks;
``--single`` runs without a mesh.
Each rank writes its own ``OUT.npz``: per case the final ``pos``, ``vel``
and ``density``, and a JSON record (``meta``) of every frame's metrics,
the retries, K and box, ms per frame (CUDA events on a card), the
kernels' launch counts, the mesh's shape, and the
exchanges, their bytes (per axis too) and the other collectives of
``parallel.halo``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..config import dam_break_config
from ..ops import column_pass_cuda as cc
from ..parallel import distributed, halo
from ..parallel.mesh import make_mesh, make_mesh2d
from ..simulation import Simulation
from ..state import block_positions, dam_break_positions, scaled_dam_scene

SOLVERS = ("wcsph", "dfsph", "pbd")
SPLASH_SPEED = 28.0      # m/s upwards at the block's top


def scene(name: str, mode: str, seed: int = 0):
    """-> (cfg, fluid positions, initial velocities or None)."""
    if name == "tank":
        cfg = dam_break_config(mode=mode, max_active_cells=512,
                               max_per_cell=16)
        s = cfg.spacing
        return cfg, np.array([(0.3 + s * i, 0.2 + s * j, 0.3 + s * k)
                              for i in range(6) for j in range(6)
                              for k in range(6)], np.float32), None
    if name in ("block", "splash", "floor"):
        cfg = dam_break_config(mode=mode, space_size=(0.52, 0.52, 0.52),
                               max_active_cells=1024, max_per_cell=16)
        rng = np.random.default_rng(seed)
        if name == "floor":
            pos = block_positions((0.16, 0.006, 0.16), (7, 7, 7),
                                  cfg.spacing)
            pos = pos + rng.uniform(-0.002, 0.002, pos.shape)
            return (cfg, pos.astype(np.float32),
                    rng.normal(0.0, 0.3, pos.shape).astype(np.float32))
        pos = block_positions((0.16, 0.10, 0.16), (6, 6, 6), cfg.spacing)
        if name == "block":
            return cfg, pos, None
        y = pos[:, 1]
        vel = rng.normal(0.0, 0.2, pos.shape)
        vel[:, 1] += SPLASH_SPEED * (y - y.min()) / (y.max() - y.min())
        return cfg, pos, vel.astype(np.float32)
    if name == "dam":
        cfg = dam_break_config(mode=mode)
        return cfg, dam_break_positions(cfg), None
    if name.startswith("scaled"):
        cfg, pos = scaled_dam_scene(int(name[len("scaled"):]), mode=mode)
        return cfg, pos, None
    raise ValueError(f"unknown scene {name!r}")


def parse_case(case: str):
    """'solver[-fast][-off]:scene:frames' -> (solver, mode, surface on,
    scene, frames)."""
    head, name, frames = case.split(":")
    solver, *flags = head.split("-")
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r} in case {case!r}")
    if not set(flags) <= {"fast", "off"} or len(set(flags)) != len(flags):
        raise ValueError(f"unknown or repeated flags {flags} in case "
                         f"{case!r}; a solver takes -fast and -off")
    return (solver, "fast" if "fast" in flags else "parity",
            "off" not in flags, name, int(frames))


def run_case(case: str, device, mesh=None, seed: int = 0) -> dict:
    """Run one case -> {"pos", "vel", "density": numpy arrays, "meta": a
    JSON-able record}."""
    solver, mode, surface, name, frames = parse_case(case)
    cfg, pos, vel = scene(name, mode, seed)
    if not surface:
        cfg = cfg.replace(surface_tension=0.0, air_pressure=0.0)
    cc.reset_launch_counts()
    halo.reset_counts()
    t0 = time.perf_counter()
    sim = Simulation(solver=solver, cfg=cfg, fluid_pos=pos, device=device,
                     mesh=mesh)
    if vel is not None:
        v = torch.as_tensor(vel, device=sim.device)
        sim.state = sim.state._replace(vel=v)
        if solver == "pbd":
            # PBD's velocity is the last frame's position delta
            sim.carry = sim.carry._replace(pos_last=sim.state.pos - cfg.dt * v)
    metrics, ms, caps = [], [], []
    for _ in range(frames):
        ms.append(sim.step())
        metrics.append({k: v.tolist() for k, v in sim.metrics.items()})
        caps.append([sim.max_per_cell, list(sim.box)])
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    meta = {
        "case": case, "rank": mesh.rank if mesh else 0,
        "ranks": mesh.size if mesh else 1,
        "mesh": list(mesh.blocks) if mesh else None,
        "backend": mesh.backend if mesh else None, "device": str(sim.device),
        "fluid": sim.fluid_size, "boundary": sim.boundary_size,
        "frames": frames, "retries": sim.retries,
        "dropped_frames": sim.dropped_frames, "capacity": caps,
        "metrics": metrics, "ms": ms, "wall_s": time.perf_counter() - t0,
        "launches": dict(cc.LAUNCHES),
        "halo": dict(halo.COUNTS), "staged": sorted(halo.STAGED)}
    st = sim.state
    return {"pos": st.pos.cpu().numpy(), "vel": st.vel.cpu().numpy(),
            "density": st.density.cpu().numpy(), "meta": meta}


def save(path: str, results) -> None:
    arrays = {}
    for i, r in enumerate(results):
        for key in ("pos", "vel", "density"):
            arrays[f"c{i}_{key}"] = r[key]
    arrays["meta"] = np.asarray(json.dumps([r["meta"] for r in results]))
    np.savez(path, **arrays)


def load(path: str):
    """-> the list of results that ``save`` wrote."""
    with np.load(path) as z:
        metas = json.loads(str(z["meta"]))
        return [dict(meta=m, **{key: z[f"c{i}_{key}"]
                                for key in ("pos", "vel", "density")})
                for i, m in enumerate(metas)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="+")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl on a card, else gloo)")
    ap.add_argument("--single", action="store_true",
                    help="run on one device without a mesh")
    ap.add_argument("--mesh2d", default=None, metavar="NXxNZ",
                    help="the (gx, gz) 2-D mesh of NX x NZ ranks (default: "
                    "the 1-D x-slab mesh)")
    args = ap.parse_args(argv)
    mesh = None
    if not args.single:
        distributed.ensure_initialized(
            backend=args.backend or distributed.default_backend(args.device),
            world_size=int(os.environ["WORLD_SIZE"]),
            rank=int(os.environ["RANK"]))
        mesh = (make_mesh2d(tuple(int(a) for a in args.mesh2d.split("x")),
                            device=args.device) if args.mesh2d
                else make_mesh(device=args.device))
    try:
        results = [run_case(c, mesh.device if mesh else args.device, mesh)
                   for c in args.cases]
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    save(args.out, results)
    for r in results:
        m = r["meta"]
        print(f"[mesh_run] {m['case']} rank {m['rank']}/{m['ranks']} "
              f"mesh {m['mesh']} "
              f"{m['backend'] or 'single'} on {m['device']}: "
              f"{m['frames']} frames, retries {m['retries']}, "
              f"{sum(m['ms']) / max(m['frames'], 1):.3f} ms/frame, "
              f"halo {m['halo']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
