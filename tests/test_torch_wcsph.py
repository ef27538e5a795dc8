"""The PyTorch port's WCSPH slice on the CPU: the scene build, one step and
the Simulation against the JAX package and the float64 all-pairs oracle.

Bars: one step as tests/test_pallas_engine.py:149-152 and
tests/test_dense_engine.py:57-62 (pos atol 2e-6, vel atol 2e-3, density
rtol 1e-4); five frames against the oracle as tests/test_solvers.py:39-44.
"""

import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu.models import dense_step as jds
from cpp_fluid_particles_tpu.ops import dense as jdense
from cpp_fluid_particles_tpu.utils import io as jio

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch.models import dense_step as tds
from cpp_fluid_particles_tpu_torch.ops import dense as tdense
from cpp_fluid_particles_tpu_torch.utils import io as tio

import reference_impl as ref
from helpers import SMALL_CFG as JCFG, small_block

torch.set_num_threads(2)

TCFG = T.dam_break_config(**{f: getattr(JCFG, f)
                             for f in JCFG.__dataclass_fields__})
BOX = (8, 8, 8)


def _assert_step_close(pos, vel, rho, pos_want, vel_want, rho_want):
    np.testing.assert_allclose(pos, pos_want, atol=2e-6)
    np.testing.assert_allclose(vel, vel_want, atol=2e-3)
    if rho is not None:
        np.testing.assert_allclose(rho, rho_want, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def scenes():
    bpos = J.boundary_positions(JCFG)
    kb = jds.boundary_k(bpos, JCFG)
    assert kb == tds.boundary_k(bpos, TCFG)
    return dict(bpos=bpos, kb=kb,
                jax=jds.build_dense_scene(JCFG, bpos, kb, engine="xlab"),
                port=tds.build_dense_scene(TCFG, bpos, kb, "cpu"))


def test_boundary_mass_matches_jax(scenes):
    a = np.asarray(scenes["jax"].bd)
    b = scenes["port"].bd.numpy()
    np.testing.assert_array_equal(b[:3], a[:3])
    np.testing.assert_allclose(b[3], a[3], rtol=1e-5)


def _states():
    """A free-falling block away from the walls, and a jittered block
    resting on the floor with random velocities (boundary terms on)."""
    rng = np.random.default_rng(5)
    pos = small_block(n_side=7, origin=(0.16, 0.006, 0.16))
    pos = pos + rng.uniform(-0.002, 0.002, pos.shape).astype(np.float32)
    vel = rng.normal(0, 0.3, pos.shape).astype(np.float32)
    return {"falling": (small_block(), None), "floor": (pos, vel)}


@pytest.mark.parametrize("which", ["falling", "floor"])
def test_one_step_matches_jax(scenes, which):
    pos, vel = _states()[which]
    js = J.make_fluid_state(pos, JCFG)
    if vel is not None:
        js = js._replace(vel=js.vel + vel)
    ts = T.make_fluid_state(pos, TCFG, "cpu")._replace(
        vel=torch.as_tensor(np.array(js.vel)))
    k = 16
    dims, dims_b = jdense.dims_for(JCFG, k), jdense.dims_for(JCFG,
                                                             scenes["kb"])
    j1, _, jm = jds.wcsph_step(js, (), scenes["jax"], JCFG,
                               np.float32(JCFG.dt), dims, dims_b,
                               engine="xlab", box=BOX)
    t1, _, tm = tds.wcsph_step(ts, (), scenes["port"], TCFG, JCFG.dt,
                               tdense.dims_for(TCFG, k),
                               tdense.dims_for(TCFG, scenes["kb"]), BOX)
    _assert_step_close(t1.pos.numpy(), t1.vel.numpy(), t1.density.numpy(),
                       np.asarray(j1.pos), np.asarray(j1.vel),
                       np.asarray(j1.density))
    np.testing.assert_allclose(t1.pressure.numpy(), np.asarray(j1.pressure),
                               rtol=1e-3, atol=1e-3)
    # the capacity scalars up to bd_touch are exact; the occupancy-split
    # window fields are not ported and stay zero
    cap_j, cap_t = np.asarray(jm["capacity"]), tm["capacity"].numpy()
    np.testing.assert_array_equal(cap_t[:7], cap_j[:7])
    assert not cap_t[7:].any()
    if which == "floor":
        assert cap_t[6] > 0       # the boundary window is not empty


def test_surface_off_step_not_ported(scenes):
    cfg = TCFG.replace(surface_tension=0.0, air_pressure=0.0)
    ts = T.make_fluid_state(small_block(), cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tds.wcsph_step(ts, (), scenes["port"], cfg, cfg.dt,
                       tdense.dims_for(cfg), tdense.dims_for(
                           cfg, scenes["kb"]), BOX)


def test_five_frames_vs_float64_oracle():
    """5 full WCSPH frames of the port's Simulation must track the
    all-pairs float64 reference (tests/test_solvers.py:25-44)."""
    pos0 = small_block()
    sim = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=pos0,
                       warmup=False, device="cpu")
    bpos = T.boundary_positions(TCFG).astype(np.float64)
    bmass = ref.boundary_mass(bpos, TCFG.radius, TCFG.rho_boundary)
    mass = np.full((pos0.shape[0],), TCFG.m0, np.float64)
    rpos, rvel = pos0.astype(np.float64), np.zeros_like(pos0, np.float64)
    for _ in range(5):
        sim.step()
        rpos, rvel, rrho, _ = ref.wcsph_step(rpos, rvel, mass, bpos, bmass,
                                             TCFG, TCFG.dt)
    np.testing.assert_allclose(sim.state.pos.numpy(), rpos, rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(sim.state.vel.numpy(), rvel, rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(sim.state.density.numpy(), rrho, rtol=2e-4,
                               atol=1e-6)
    assert sim.frame == 5 and sim.dropped_frames == 0


def test_jax_checkpoint_carries_over(tmp_path):
    """A JAX Simulation's checkpoint loads into the port unchanged; both
    then take 3 steps and agree at the step bars, at the same capacity."""
    jsim = J.Simulation(solver="wcsph", cfg=JCFG, fluid_pos=small_block(),
                        warmup=True)
    jsim.run(2)
    path = str(tmp_path / "jax.npz")
    jio.save_checkpoint(path, jsim)
    tsim = tio.load_checkpoint(path, device="cpu")
    assert tsim.solver_name == "wcsph" and tsim.frame == jsim.frame
    assert tsim.cfg == TCFG
    for name in T.FluidState._fields:
        np.testing.assert_array_equal(getattr(tsim.state, name).numpy(),
                                      np.asarray(getattr(jsim.state, name)))
    for _ in range(3):
        jsim.step()
        tsim.step()
    assert tsim.config_key == jsim.config_key[:3]
    _assert_step_close(tsim.state.pos.numpy(), tsim.state.vel.numpy(),
                       tsim.state.density.numpy(), np.asarray(jsim.state.pos),
                       np.asarray(jsim.state.vel),
                       np.asarray(jsim.state.density))


def test_port_checkpoint_roundtrip_and_jax_load(tmp_path):
    sim = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=small_block(),
                       device="cpu")
    sim.run(2)
    path = str(tmp_path / "port.npz")
    tio.save_checkpoint(path, sim)
    back = tio.load_checkpoint(path, device="cpu")
    assert back.frame == sim.frame == 2
    jsim = jio.load_checkpoint(path)
    for name in T.FluidState._fields:
        a = getattr(sim.state, name).numpy()
        np.testing.assert_array_equal(getattr(back.state, name).numpy(), a)
        np.testing.assert_array_equal(np.asarray(getattr(jsim.state, name)),
                                      a)
    # deterministic resume
    sim.step()
    back.step()
    assert torch.equal(sim.state.pos, back.state.pos)


@pytest.mark.parametrize("chunked", [False, True])
def test_k_retry_matches_run_at_higher_k(chunked):
    """A frame (or chunk) whose grid build overflows the per-cell bound is
    re-run from the pre-frame state at a fitted K, and equals a run that
    started at that K (the JAX contract, PARITY.md #6)."""
    pos = small_block()
    sim = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=pos,
                       warmup=False, device="cpu")
    sim.max_per_cell = 4
    if chunked:
        sim.run_scan(3)
    else:
        sim.step()
    assert sim.max_per_cell > 4 and sim.retries == 1
    assert int(sim.metrics["grid_overflow"]) == 0
    sim2 = T.Simulation(
        solver="wcsph", cfg=TCFG.replace(max_per_cell=sim.max_per_cell),
        fluid_pos=pos, warmup=False, auto_capacity=False, device="cpu")
    for _ in range(3 if chunked else 1):
        sim2.step()
    assert sim2.max_per_cell == sim.max_per_cell and sim2.box == sim.box
    assert torch.equal(sim.state.pos, sim2.state.pos)
    assert torch.equal(sim.state.vel, sim2.state.vel)


def test_box_retry_refits_box():
    sim = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=small_block(),
                       warmup=False, device="cpu")
    sim.box = (4, 2, 4)        # small_block spans 4x4x4 cells
    sim.step()
    assert sim.box[1] >= 4 and sim.retries == 1
    assert int(sim.metrics["box_overflow"]) == 0
    assert int(sim.metrics["grid_overflow"]) == 0


def test_capacity_exhaustion_warns_and_counts():
    sim = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=small_block(),
                       device="cpu")
    sim.max_per_cell = 4
    sim.K_MAX = 4
    with pytest.warns(RuntimeWarning, match="capacity exhausted"):
        sim.step()
    assert sim.dropped_frames == 1


def test_run_scan_equals_stepwise_and_run_summary():
    a = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=small_block(),
                     device="cpu")
    b = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=small_block(),
                     device="cpu")
    stats = a.run(4)
    ms = b.run_scan(4)
    assert torch.equal(a.state.pos, b.state.pos)
    assert torch.equal(a.state.vel, b.state.vel)
    assert a.frame == b.frame == 4 and ms > 0
    assert stats["frames"] == 4 and stats["ms_per_frame"] > 0
    assert stats["last_metrics"]["grid_overflow"] == 0
    assert a.size == a.fluid_size + a.boundary_size
    assert a.fluid_size == 216 and a.boundary_size == len(
        T.boundary_positions(TCFG))


def test_nan_rollback_keeps_state():
    sim = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=small_block(),
                       nan_rollback=True, device="cpu")
    sim.step()
    good = sim.state.pos.clone()
    bad = good.clone()
    bad[0, 0] = float("nan")
    sim.state = sim.state._replace(pos=bad)
    with pytest.raises(FloatingPointError):
        sim.step()
    assert torch.equal(sim.state.pos[1:], good[1:])
    sim.state = sim.state._replace(pos=good)
    sim.step()
    assert sim.frame == 2


def test_restart_keeps_scene():
    sim = T.Simulation(solver="1", cfg=TCFG, fluid_pos=small_block(),
                       warmup=False, device="cpu")
    sim.run(2)
    sim.restart()
    assert sim.frame == 0 and sim.solver_name == "wcsph"
    np.testing.assert_array_equal(sim.state.pos.numpy(), small_block())


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=small_block())


@pytest.mark.parametrize("kwargs,exc", [
    (dict(solver="dfsph"), NotImplementedError),
    (dict(solver="pbd"), NotImplementedError),
    (dict(solver="nope"), ValueError),
    (dict(cfg=TCFG.replace(engine="xla")), NotImplementedError),
    (dict(cfg=TCFG.replace(engine="bogus")), ValueError),
    (dict(cfg=TCFG.replace(occupancy_split=True)), NotImplementedError),
])
def test_unported_options_raise(kwargs, exc):
    kw = dict(solver="wcsph", cfg=TCFG, fluid_pos=small_block(),
              warmup=False, device="cpu")
    kw.update(kwargs)
    with pytest.raises(exc):
        T.Simulation(**kw)
