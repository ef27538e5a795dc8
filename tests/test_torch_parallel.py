"""The port's x-slab mesh (cpp_fluid_particles_tpu_torch/parallel/) on the
CPU, over gloo, with the plain executor.

Ranks are OS processes launched under the environment contract (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), as tests/test_parallel.py
launches the JAX package's. They run:

* ``tests/_torch_halo_worker.py`` on 2 ranks: each of the fourteen
  particle-list passes on its slab, with the ghost planes a neighbour owns
  made stale, against the single-device pass, bitwise; ``read_sharded``
  (-0.0 included), ``whole`` and the exact reductions;
* ``exp/mesh_run.py`` on 2 and 4 ranks: ``Simulation(mesh=...)`` for 5
  frames of a block stretched upwards until the box refits, for WCSPH,
  DFSPH, PBD parity and PBD fast, held bitwise to the same cases run here
  on one device, with equal metrics on every rank; and on 2 ranks a frame
  of DFSPH on a jittered block on the floor, held to the JAX package's
  single-device Simulation at the step bar (pos atol 2e-6, vel atol 2e-3,
  density rtol 1e-4 as tests/test_torch_dfsph.py; equal iterations).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu.parallel import distributed as jdist

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch import parallel
from cpp_fluid_particles_tpu_torch.exp import mesh_run
from cpp_fluid_particles_tpu_torch.parallel import distributed, halo
from cpp_fluid_particles_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SLICE = ("wcsph:splash:5", "dfsph:splash:5", "pbd:splash:5",
         "pbd-fast:splash:5")
VS_JAX = "dfsph:floor:1"
PASSES = ("density", "density_colorgrad_visc", "surface_pressure",
          "density_visc", "pressure_force", "density_alpha_colorgrad",
          "divergence", "stiffness_accel", "viscosity", "surface",
          "density_alpha", "pbd_lambda", "pbd_stiffness_accel",
          "xsph_colorgrad", "xsph")
TIMEOUT = 400


def _launch(argv, ranks, port):
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(ranks), PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable] + argv(r),
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ranks)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(procs):
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch every multi-rank run at once, run the single-device cases
    here meanwhile, then collect: {"ref": {case: result}, 2: [rank
    results], 4: [...], "halo": [rank records]}."""
    tmp = tmp_path_factory.mktemp("mesh")
    mod = "cpp_fluid_particles_tpu_torch.exp.mesh_run"
    jobs = {
        2: _launch(lambda r: ["-m", mod, "--device", "cpu", "--out",
                              str(tmp / f"r2_{r}.npz"), *SLICE, VS_JAX],
                   2, _free_port()),
        4: _launch(lambda r: ["-m", mod, "--device", "cpu", "--out",
                              str(tmp / f"r4_{r}.npz"), *SLICE], 4,
                   _free_port()),
        "halo": _launch(lambda r: [str(ROOT / "tests/_torch_halo_worker.py"),
                                   str(tmp / f"halo_{r}.json")], 2,
                        _free_port())}
    try:
        ref = {c: mesh_run.run_case(c, "cpu") for c in SLICE + (VS_JAX,)}
    finally:
        for procs in jobs.values():
            _wait(procs)
    out = {"ref": ref}
    for n in (2, 4):
        out[n] = [mesh_run.load(str(tmp / f"r{n}_{r}.npz"))
                  for r in range(n)]
    out["halo"] = [json.loads((tmp / f"halo_{r}.json").read_text())
                   for r in range(2)]
    return out


# ----------------------------------------------------------------------
# bootstrap and split (one process)
# ----------------------------------------------------------------------

def test_bootstrap_single_process():
    assert distributed.is_multiprocess_env() is False
    assert distributed.ensure_initialized() is False
    assert distributed.process_index() == 0
    sl = distributed.local_device_slice(1000)
    assert (sl.start, sl.stop) == (0, 1000)
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert parallel.mesh_devices(mesh) == 1


@pytest.mark.parametrize("count", range(1, 9))
def test_tile_matches_jax(monkeypatch, count):
    """The port's tiling of [0, n) is the JAX package's
    local_device_slice, process by process."""
    monkeypatch.setattr(jax, "process_count", lambda: count)
    for n in (3, 8, 101):
        got = []
        for p in range(count):
            monkeypatch.setattr(jax, "process_index", lambda p=p: p)
            want = jdist.local_device_slice(n)
            got.append(distributed.tile(n, count, p))
            assert (got[-1].start, got[-1].stop) == (want.start, want.stop)
        assert got[0].start == 0 and got[-1].stop == n
        assert all(a.stop == b.start for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("size", range(1, 9))
def test_plane_split_covers_the_box(size):
    """Every rank count 1-8 splits the box's planes contiguously, empty
    ranks included; neighbours name each other; the planes the ranks
    contribute to a whole-box tensor tile the ghosted box once."""
    for bx in (1, 3, 4, 8, 13, 60):
        split = tmesh.plane_split(bx, size)
        assert split[0][0] == 0 and split[-1][1] == bx
        assert all(a[1] == b[0] for a, b in zip(split, split[1:]))
        slabs = [halo.make_slab(tmesh.Mesh(None, r, size,
                                           torch.device("cpu"), None), bx)
                 for r in range(size)]
        for r, s in enumerate(slabs):
            assert (s.x0, s.x1) == split[r]
            if s.left is not None:
                assert slabs[s.left].right == r
                assert slabs[s.left].x1 == s.x0
            if s.right is not None:
                assert slabs[s.right].left == r
            assert (s.left is None) == (s.empty or s.x0 == 0)
            assert (s.right is None) == (s.empty or s.x1 == bx)
        spans = [s.keep() for s in slabs]
        assert sum(hi - lo for lo, hi in spans) == bx + 2
        assert all(0 <= lo <= hi <= s.gx for (lo, hi), s in zip(spans, slabs))


def test_no_fallback_and_not_ported():
    """An ineligible mesh raises; nothing continues on one device."""
    cfg = T.dam_break_config(mode="parity", space_size=(0.52,) * 3)
    pos = T.block_positions((0.16, 0.10, 0.16), (3, 3, 3), cfg.spacing)
    cpu = parallel.make_mesh(device="cpu")
    card = tmesh.Mesh(None, 0, 1, torch.device("cuda", 0), "nccl")
    with pytest.raises(ValueError, match="mesh's device"):
        T.Simulation(solver="wcsph", cfg=cfg, fluid_pos=pos, device="cpu",
                     mesh=card)
    with pytest.raises(ValueError, match="NCCL mesh needs a CUDA"):
        T.Simulation(solver="wcsph", cfg=cfg, fluid_pos=pos, device="cpu",
                     mesh=cpu._replace(backend="nccl"))
    with pytest.raises(ValueError, match="parallel.Mesh"):
        T.Simulation(solver="wcsph", cfg=cfg, fluid_pos=pos, device="cpu",
                     mesh=object())
    with pytest.raises(NotImplementedError, match="GSPMD"):
        T.Simulation(solver="wcsph", cfg=cfg.replace(halo_comm="gspmd"),
                     fluid_pos=pos, device="cpu", mesh=cpu)
    with pytest.raises(ValueError, match="rank"):
        parallel.make_mesh(2)
    with pytest.raises(ValueError, match="halo_comm"):
        with parallel.spatial_sharding(cpu, halo="ppermute"):
            pass


@pytest.mark.parametrize("solver", ["wcsph", "dfsph", "pbd"])
def test_one_rank_mesh_is_the_single_device_run(solver):
    """A mesh of one rank (no process group), given or ambient, runs the
    slab path (window, read, whole-box sums, reductions) bitwise as one
    device does."""
    cfg = T.dam_break_config(mode="parity", space_size=(0.52,) * 3)
    pos = T.block_positions((0.16, 0.10, 0.16), (4, 4, 4), cfg.spacing)
    mesh = parallel.make_mesh(device="cpu")
    one = T.Simulation(solver=solver, cfg=cfg, fluid_pos=pos, device="cpu")
    with parallel.spatial_sharding(mesh):
        ambient = T.Simulation(solver=solver, cfg=cfg, fluid_pos=pos,
                               device="cpu")
    assert ambient.mesh is mesh
    for sim in (one, ambient):
        sim.run(1)
    for name in T.FluidState._fields:
        a, b = getattr(one.state, name), getattr(ambient.state, name)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    assert {k: v.tolist() for k, v in one.metrics.items()} == {
        k: v.tolist() for k, v in ambient.metrics.items()}


@pytest.mark.parametrize("case, want", [
    ("wcsph:dam:100", ("wcsph", "parity", True, "dam", 100)),
    ("dfsph-fast:scaled1000000:3",
     ("dfsph", "fast", True, "scaled1000000", 3)),
    ("dfsph-off:dam:20", ("dfsph", "parity", False, "dam", 20)),
    ("pbd-fast-off:floor:2", ("pbd", "fast", False, "floor", 2)),
    ("pbd-off-fast:floor:2", ("pbd", "fast", False, "floor", 2))])
def test_mesh_run_case_takes_the_mode_and_surface_flags(case, want):
    """A case's solver takes -fast (the config's fast mode) and -off
    (surface tension and air pressure 0) in either order; an unknown or
    repeated flag is refused."""
    assert mesh_run.parse_case(case) == want
    with pytest.raises(ValueError, match="flags"):
        mesh_run.parse_case(case.replace(":", "-fast-fast:", 1))
    with pytest.raises(ValueError, match="flags"):
        mesh_run.parse_case(case.replace(":", "-slow:", 1))


def test_mesh_run_surface_off_case_runs_the_surface_off_config():
    """An -off case runs Simulation with the scene's config at surface
    tension and air pressure 0: bitwise a Simulation built so by hand."""
    got = mesh_run.run_case("wcsph-off:block:2", "cpu")
    cfg, pos, _ = mesh_run.scene("block", "parity")
    sim = T.Simulation(solver="wcsph", cfg=cfg.replace(
        surface_tension=0.0, air_pressure=0.0), fluid_pos=pos, device="cpu")
    for _ in range(2):
        sim.step()
    assert np.array_equal(_bits(got["pos"]), _bits(sim.state.pos.numpy()))
    on = mesh_run.run_case("wcsph:block:2", "cpu")
    assert not np.array_equal(on["pos"], got["pos"])


# ----------------------------------------------------------------------
# the ghost-plane exchange, pass by pass (2 ranks)
# ----------------------------------------------------------------------

def test_halo_ranks_bootstrap(runs):
    recs = runs["halo"]
    assert [r["rank"] for r in recs] == [0, 1]
    assert all(r["size"] == 2 and r["backend"] == "gloo" for r in recs)
    assert [r["slice"] for r in recs] == [[0, 50], [50, 101]]
    assert sorted(recs[0]["passes"]) == sorted(PASSES)


@pytest.mark.parametrize("name", PASSES)
def test_pass_under_mesh_is_bitwise(runs, name):
    """Each rank's own planes of the pass, run on its window whose
    neighbour-owned ghost planes were stale (NaN), equal the single-device
    pass bitwise, after exactly one exchange."""
    for rec in runs["halo"]:
        r = rec["passes"][name]
        assert r["bitwise"], (rec["rank"], r)
        assert r["exchanges"] == 1
    assert sum(rec["passes"][name]["nonzero"] for rec in runs["halo"]) > 0


@pytest.mark.parametrize("planes", ["6", "1"])
def test_read_sharded_keeps_negative_zero(runs, planes):
    """On 6 planes, and on 1, where rank 0 owns none."""
    for rec in runs["halo"]:
        b = rec["boundary"][planes]
        assert b["read_sharded"] and b["negative_zeros"] > 0


@pytest.mark.parametrize("planes", ["6", "1"])
def test_whole_and_reductions(runs, planes):
    for rec in runs["halo"]:
        b = rec["boundary"][planes]
        assert b["whole"] and b["any"] and b["max"] and b["sum"]


# ----------------------------------------------------------------------
# the slice: Simulation(mesh=...) on 2 and 4 ranks
# ----------------------------------------------------------------------

def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("ranks,case", [(n, c) for n in (2, 4)
                                        for c in SLICE] + [(2, VS_JAX)])
def test_mesh_run_is_the_single_device_run(runs, ranks, case):
    """Positions, velocities and density bitwise; every frame's metrics
    (iterations, host syncs, error sums, capacity) and the retries equal
    to the single-device run's, on every rank."""
    ref = runs["ref"][case]
    i = (SLICE + (VS_JAX,)).index(case)
    for rank, results in enumerate(runs[ranks]):
        got = results[i]
        m = got["meta"]
        assert (m["case"], m["rank"], m["ranks"]) == (case, rank, ranks)
        for key in ("pos", "vel", "density"):
            np.testing.assert_array_equal(_bits(got[key]), _bits(ref[key]),
                                          err_msg=f"rank {rank} {key}")
        for key in ("metrics", "retries", "capacity", "dropped_frames"):
            assert m[key] == ref["meta"][key], (rank, key)
        assert m["halo"]["exchanges"] > 0 and m["staged"] == []
    if case in SLICE:
        assert ref["meta"]["retries"] >= 1     # the box refit inside
        assert ref["meta"]["dropped_frames"] == 0


def test_mesh_run_against_jax(runs):
    """The 2-rank port run against the JAX package's single-device
    Simulation, frame by frame, at the step bar with equal iterations."""
    cfg, pos, vel = mesh_run.scene("floor", "parity", seed=0)
    jcfg = J.dam_break_config(**{f: getattr(cfg, f)
                                 for f in cfg.__dataclass_fields__})
    jsim = J.Simulation(solver="dfsph", cfg=jcfg, fluid_pos=pos)
    jsim.state = jsim.state._replace(vel=jnp.asarray(vel))
    got = runs[2][0][(SLICE + (VS_JAX,)).index(VS_JAX)]
    for frame in range(1):
        jsim.step()
        for key in ("divergence_iters", "density_iters"):
            assert got["meta"]["metrics"][frame][key] == int(
                jsim.metrics[key]), (frame, key)
    assert got["meta"]["capacity"][-1] == [jsim.config_key[1],
                                           list(jsim.config_key[2])]
    np.testing.assert_allclose(got["pos"], np.asarray(jsim.state.pos),
                               atol=2e-6)
    np.testing.assert_allclose(got["vel"], np.asarray(jsim.state.vel),
                               atol=2e-3)
    np.testing.assert_allclose(got["density"], np.asarray(jsim.state.density),
                               rtol=1e-4, atol=1e-6)
