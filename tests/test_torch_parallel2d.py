"""The port's (gx, gz) 2-D mesh (``parallel.make_mesh2d``) on the CPU, over
gloo, with the plain executor.

Ranks are OS processes launched under the environment contract
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), once for every
case of this file. They run:

* ``tests/_torch_halo_worker.py`` on a 2x2 mesh: each of the fourteen
  particle-list passes on its x-z block, with every ghost cell a neighbour
  owns made stale (faces, edges and corners), against the single-device
  pass, bitwise; ``read_sharded`` (-0.0 included), ``whole`` and the exact
  reductions, also on boxes where some rank owns no x- or z-plane;
* ``exp/mesh_run.py --mesh2d`` on 2x2 and on 1x2 (z only):
  ``Simulation(mesh=...)`` for 5 frames of a block stretched upwards until
  the box refits, for WCSPH, DFSPH, PBD parity and PBD fast, held bitwise
  to the same cases run here on one device, with equal metrics on every
  rank; and on 2x2 the JAX package's 2-D mesh test block (2 frames, held
  to the JAX package's ``make_mesh2d((4, 2))`` run of it) and a frame of
  DFSPH on a jittered block on the floor (held to the JAX package's
  single-device Simulation with equal iterations).
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
from cpp_fluid_particles_tpu.parallel import mesh as jmesh

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch import parallel
from cpp_fluid_particles_tpu_torch.exp import mesh_run
from cpp_fluid_particles_tpu_torch.ops.dense import DenseDims
from cpp_fluid_particles_tpu_torch.parallel import distributed, halo
from cpp_fluid_particles_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SLICE = ("wcsph:splash:5", "dfsph:splash:5", "pbd:splash:5",
         "pbd-fast:splash:5")
VS_JAX = "dfsph:floor:1"
TANK = "wcsph:tank:2"
CASES = {(2, 2): SLICE + (VS_JAX, TANK), (1, 2): SLICE}
PASSES = ("density", "density_colorgrad_visc", "surface_pressure",
          "density_visc", "pressure_force", "density_alpha_colorgrad",
          "divergence", "stiffness_accel", "viscosity", "surface",
          "density_alpha", "pbd_lambda", "pbd_stiffness_accel",
          "xsph_colorgrad", "xsph")
BOXES = ("6x5", "6x1", "1x5", "1x1")
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


def _jax_cfg(cfg):
    return J.dam_break_config(**{f: getattr(cfg, f)
                                 for f in cfg.__dataclass_fields__})


def _jax_tank():
    """The JAX package's 2-D mesh run of the tank case: its
    ``make_mesh2d((4, 2))`` over 8 host devices."""
    _, _, frames = TANK.split(":")
    cfg, pos, _ = mesh_run.scene("tank", "parity")
    sim = J.Simulation(solver="wcsph", cfg=_jax_cfg(cfg), fluid_pos=pos,
                       mesh=J.parallel.make_mesh2d((4, 2)))
    for _ in range(int(frames)):
        sim.step()
    return {"pos": np.asarray(sim.state.pos), "vel": np.asarray(sim.state.vel)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch every multi-rank run at once, run the single-device cases and
    the JAX package's 2-D run here meanwhile, then collect: {"ref": {case:
    result}, "jax_tank": {...}, (2, 2): [rank results], (1, 2): [...],
    "halo": [rank records]}."""
    tmp = tmp_path_factory.mktemp("mesh2d")
    mod = "cpp_fluid_particles_tpu_torch.exp.mesh_run"
    jobs = {
        shape: _launch(lambda r, s=shape, c=cases: [
            "-m", mod, "--device", "cpu", "--mesh2d", f"{s[0]}x{s[1]}",
            "--out", str(tmp / f"m{s[0]}x{s[1]}_{r}.npz"), *c],
            shape[0] * shape[1], _free_port())
        for shape, cases in CASES.items()}
    jobs["halo"] = _launch(lambda r: [str(ROOT / "tests/_torch_halo_worker.py"),
                                      str(tmp / f"halo_{r}.json"), "2x2"],
                           4, _free_port())
    try:
        ref = {c: mesh_run.run_case(c, "cpu") for c in CASES[(2, 2)]}
        jax_tank = _jax_tank()
    finally:
        for procs in jobs.values():
            _wait(procs)
    out = {"ref": ref, "jax_tank": jax_tank}
    for s in CASES:
        out[s] = [mesh_run.load(str(tmp / f"m{s[0]}x{s[1]}_{r}.npz"))
                  for r in range(s[0] * s[1])]
    out["halo"] = [json.loads((tmp / f"halo_{r}.json").read_text())
                   for r in range(4)]
    return out


# ----------------------------------------------------------------------
# the API and the block split (one process)
# ----------------------------------------------------------------------

def test_axes_match_jax():
    assert parallel.AXES_2D == jmesh.AXES_2D == ("gx", "gz")


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2),
                                   (2, 4), (8, 1), (1, 8)])
def test_rank_layout_matches_jax(shape):
    """Rank r sits where the JAX package's make_mesh2d puts device r."""
    nx, nz = shape
    devs = np.asarray(jmesh.make_mesh2d(shape).devices)
    ids = [d.id for d in jax.devices()]
    assert devs.shape == shape
    for r in range(nx * nz):
        m = tmesh.Mesh(None, r, nx * nz, torch.device("cpu"), None,
                       tmesh.AXES_2D, shape)
        assert m.blocks == shape
        ix, iz = m.coords()
        assert ids.index(devs[ix, iz].id) == r


def test_make_mesh2d_takes_every_rank():
    """A shape whose product is not the rank count raises, as make_mesh(n)
    does; (1, 1) in a single process is a 2-D mesh of one rank."""
    for shape in ((4, 2), (2, 1), (1, 2), (0, 1)):
        with pytest.raises(ValueError, match="rank"):
            parallel.make_mesh2d(shape, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        parallel.make_mesh2d(device="cpu")
    m = parallel.make_mesh2d((1, 1), device="cpu")
    assert (m.group, m.rank, m.size, m.axes, m.blocks) == (
        None, 0, 1, ("gx", "gz"), (1, 1))


def test_mesh_is_2d_answers():
    """True or False, never raising; a 1-D mesh is the (n, 1) block."""
    one = parallel.make_mesh(device="cpu")
    two = parallel.make_mesh2d((1, 1), device="cpu")
    assert parallel.mesh_is_2d(two) is True
    assert parallel.mesh_is_2d(one) is False
    assert parallel.mesh_is_2d(None) is False
    assert one.blocks == (1, 1) and one.axes == ("cells",)
    assert jmesh.mesh_is_2d(jmesh.make_mesh2d((4, 2))) is True


def test_default_device_is_the_card(monkeypatch):
    """Without device="cpu" a mesh takes cuda:LOCAL_RANK whatever the
    backend, with or without a card; the default backend follows the
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mesh in (parallel.make_mesh(), parallel.make_mesh(backend="gloo"),
                 parallel.make_mesh2d((1, 1)),
                 parallel.make_mesh2d((1, 1), backend="gloo"),
                 parallel.make_mesh(device="cuda")):
        assert mesh.device == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert parallel.make_mesh().device == torch.device("cuda", 3)
    assert parallel.make_mesh(device="cpu").device == torch.device("cpu")
    assert parallel.make_mesh2d((1, 1), device="cpu").device.type == "cpu"
    assert distributed.default_backend("cpu") == "gloo"
    assert distributed.default_backend(torch.device("cuda", 1)) == "nccl"
    assert distributed.rank_device() == torch.device("cuda", 3)


@pytest.mark.parametrize("nx", range(1, 5))
@pytest.mark.parametrize("nz", range(1, 5))
def test_block_split_covers_the_box(nx, nz):
    """Every shape 1x1-4x4 splits small boxes into blocks, empty ones
    included: the cells the blocks contribute to a whole-box tensor tile
    the ghosted box once, each particle slot has exactly one owner,
    neighbours name each other, and the windows sit where the splits
    say."""
    size = nx * nz
    meshes = [tmesh.Mesh(None, r, size, torch.device("cpu"), None,
                         tmesh.AXES_2D, (nx, nz)) for r in range(size)]
    for bx, bz in ((1, 1), (1, 4), (3, 2), (5, 7), (8, 8)):
        box = DenseDims(bx, 3, bz, 2)
        blocks = [halo.make_slab(m, bx, bz) for m in meshes]
        cover = torch.zeros((box.gx, box.gy, box.gz), dtype=torch.int32)
        slots = torch.arange(box.k * box.g + 1)
        owners = torch.zeros_like(slots)
        for r, b in enumerate(blocks):
            ix, iz = divmod(r, nz)
            assert (b.x0, b.x1) == tmesh.plane_split(bx, nx)[ix]
            assert (b.z0, b.z1) == tmesh.plane_split(bz, nz)[iz]
            assert b.empty == (b.x0 == b.x1 or b.z0 == b.z1)
            (xl, xh), (zl, zh) = b.keep(), b.keep(axis="z")
            cover[b.x0 + xl:b.x0 + xh, :, b.z0 + zl:b.z0 + zh] += 1
            lslots = halo.slab_slots(slots, box, b)
            owners += (lslots < box.k * b.gx * box.gy * b.gz).long()
            for peer, back, near in ((b.left, "right", b.x0),
                                     (b.right, "left", b.x1),
                                     (b.front, "back", b.z0),
                                     (b.back, "front", b.z1)):
                if peer is not None:
                    assert getattr(blocks[peer], back) == r
            assert (b.left is None) == (b.empty or b.x0 == 0)
            assert (b.right is None) == (b.empty or b.x1 == bx)
            assert (b.front is None) == (b.empty or b.z0 == 0)
            assert (b.back is None) == (b.empty or b.z1 == bz)
            if b.left is not None:
                assert blocks[b.left].x1 == b.x0
                assert (blocks[b.left].z0, blocks[b.left].z1) == (b.z0, b.z1)
            if b.front is not None:
                assert blocks[b.front].z1 == b.z0
                assert (blocks[b.front].x0, blocks[b.front].x1) == (b.x0,
                                                                    b.x1)
        assert bool((cover == 1).all())
        assert torch.equal(owners[:-1], torch.ones_like(owners[:-1]))
        assert int(owners[-1]) == 0        # the trash slot: no owner
        assert any(b.empty for b in blocks) == (bx < nx or bz < nz)


# ----------------------------------------------------------------------
# the two-phase exchange, pass by pass (2x2)
# ----------------------------------------------------------------------

def test_halo2d_ranks_bootstrap(runs):
    recs = runs["halo"]
    devs = np.asarray(jmesh.make_mesh2d((2, 2)).devices)
    ids = [d.id for d in jax.devices()]
    assert [r["rank"] for r in recs] == [0, 1, 2, 3]
    assert all(r["size"] == 4 and r["backend"] == "gloo"
               and r["axes"] == ["gx", "gz"] for r in recs)
    for r in recs:
        ix, iz = r["coords"]
        assert ids.index(devs[ix, iz].id) == r["rank"]
    assert sorted(recs[0]["passes"]) == sorted(PASSES)


@pytest.mark.parametrize("name", PASSES)
def test_pass_under_mesh2d_is_bitwise(runs, name):
    """Each rank's own cells of the pass, run on its block's window whose
    neighbour-owned ghost cells (faces, edges, the corner) were stale
    (NaN), equal the single-device pass bitwise, after exactly one
    exchange; every rank has an x- and a z-neighbour."""
    for rec in runs["halo"]:
        r = rec["passes"][name]
        assert r["bitwise"], (rec["rank"], r)
        assert r["exchanges"] == 1
        left, right, front, back = r["peers"]
        assert (left is None) != (right is None), r
        assert (front is None) != (back is None), r
    assert sum(rec["passes"][name]["nonzero"] for rec in runs["halo"]) > 0


@pytest.mark.parametrize("box", BOXES)
def test_read_sharded2d_keeps_negative_zero(runs, box):
    """On 6x5 planes, and on boxes of one x- or z-plane, where some rank
    owns none."""
    recs = runs["halo"]
    for rec in recs:
        b = rec["boundary"][box]
        assert b["read_sharded"] and b["negative_zeros"] > 0
    assert any(r["boundary"][box]["empty"] for r in recs) == (box != "6x5")


@pytest.mark.parametrize("box", BOXES)
def test_whole_and_reductions2d(runs, box):
    for rec in runs["halo"]:
        b = rec["boundary"][box]
        assert b["whole"] and b["any"] and b["max"] and b["sum"]


# ----------------------------------------------------------------------
# the slice: Simulation(mesh=make_mesh2d(...)) on 2x2 and 1x2
# ----------------------------------------------------------------------

def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.parametrize("shape,case", [(s, c) for s, cs in CASES.items()
                                        for c in cs])
def test_mesh2d_run_is_the_single_device_run(runs, shape, case):
    """Positions, velocities and density bitwise; every frame's metrics
    (iterations, host syncs, error sums, capacity) and the retries equal
    to the single-device run's, on every rank."""
    ref = runs["ref"][case]
    i = CASES[shape].index(case)
    ranks = runs[shape]
    assert len(ranks) == shape[0] * shape[1]
    for rank, results in enumerate(ranks):
        got = results[i]
        m = got["meta"]
        assert (m["case"], m["rank"], m["mesh"]) == (case, rank, list(shape))
        for key in ("pos", "vel", "density"):
            np.testing.assert_array_equal(_bits(got[key]), _bits(ref[key]),
                                          err_msg=f"rank {rank} {key}")
        for key in ("metrics", "retries", "capacity", "dropped_frames"):
            assert m[key] == ref["meta"][key], (rank, key)
        h = m["halo"]
        assert h["exchanges"] > 0 and m["staged"] == []
        # the x phase runs only with x-neighbours, the z phase always here
        assert h["exchanges_z"] == h["exchanges"]
        assert h.get("exchanges_x", 0) == (h["exchanges"] if shape[0] > 1
                                           else 0)
        assert h["exchange_bytes"] == (h.get("exchange_bytes_x", 0)
                                       + h["exchange_bytes_z"])
    if case in SLICE:
        assert ref["meta"]["retries"] >= 1     # the box refit inside
        assert ref["meta"]["dropped_frames"] == 0


def test_mesh2d_run_against_jax_mesh2d(runs):
    """The port's 2x2 run of the JAX package's 2-D mesh test block against
    the JAX package's make_mesh2d((4, 2)) run of it (whose own velocities
    sit an ulp off its single device)."""
    got = runs[(2, 2)][0][CASES[(2, 2)].index(TANK)]
    want = runs["jax_tank"]
    assert np.isfinite(got["pos"]).all()
    np.testing.assert_allclose(got["pos"], want["pos"], atol=2e-6)
    np.testing.assert_allclose(got["vel"], want["vel"], atol=2e-3)


def test_mesh2d_dfsph_against_jax(runs):
    """A DFSPH frame of the 2x2 port run against the JAX package's
    single-device Simulation, at the step bar with equal iterations."""
    cfg, pos, vel = mesh_run.scene("floor", "parity", seed=0)
    jsim = J.Simulation(solver="dfsph", cfg=_jax_cfg(cfg), fluid_pos=pos)
    jsim.state = jsim.state._replace(vel=jnp.asarray(vel))
    got = runs[(2, 2)][3][CASES[(2, 2)].index(VS_JAX)]
    jsim.step()
    for key in ("divergence_iters", "density_iters"):
        assert got["meta"]["metrics"][0][key] == int(jsim.metrics[key]), key
    assert got["meta"]["capacity"][-1] == [jsim.config_key[1],
                                           list(jsim.config_key[2])]
    np.testing.assert_allclose(got["pos"], np.asarray(jsim.state.pos),
                               atol=2e-6)
    np.testing.assert_allclose(got["vel"], np.asarray(jsim.state.vel),
                               atol=2e-3)
    np.testing.assert_allclose(got["density"], np.asarray(jsim.state.density),
                               rtol=1e-4, atol=1e-6)


def test_one_rank_mesh2d_is_the_single_device_run():
    """A 2-D mesh of one rank (no process group) runs the block path
    bitwise as one device does."""
    cfg = T.dam_break_config(mode="parity", space_size=(0.52,) * 3)
    pos = T.block_positions((0.16, 0.10, 0.16), (4, 4, 4), cfg.spacing)
    one = T.Simulation(solver="dfsph", cfg=cfg, fluid_pos=pos, device="cpu")
    two = T.Simulation(solver="dfsph", cfg=cfg, fluid_pos=pos, device="cpu",
                       mesh=parallel.make_mesh2d((1, 1), device="cpu"))
    for sim in (one, two):
        sim.run(1)
    for name in T.FluidState._fields:
        a, b = getattr(one.state, name), getattr(two.state, name)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    assert {k: v.tolist() for k, v in one.metrics.items()} == {
        k: v.tolist() for k, v in two.metrics.items()}
