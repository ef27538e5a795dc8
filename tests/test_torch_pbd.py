"""The PyTorch port's PBD solver on the CPU: one step against the JAX
package's sliding-box step, three frames against the float64 oracle, the
Simulation's default (PBD in fast mode), its restart, capacity retry and
option checks, and the resume of a JAX PBD checkpoint.

Bars: one step as tests/test_pallas_engine.py:149-152 (pos atol 2e-6, vel
atol 2e-3, density rtol 1e-4, equal iteration counts); the carry leaves at
rtol 1e-4, atol 1e-6 x the max of pos_last (dp_warm is pos_last minus the
step's start positions in both packages, so it carries pos_last's
rounding, a few ulps of a position); three frames against the oracle as
tests/test_solvers.py:110-117.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu.models import dense_step as jds
from cpp_fluid_particles_tpu.models import pbd as jpbd
from cpp_fluid_particles_tpu.ops import dense as jdense
from cpp_fluid_particles_tpu.utils import io as jio

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch.config import FAST_MODE_FLAGS
from cpp_fluid_particles_tpu_torch.models import dense_step as tds
from cpp_fluid_particles_tpu_torch.models import pbd as tpbd
from cpp_fluid_particles_tpu_torch.ops import dense as tdense
from cpp_fluid_particles_tpu_torch.utils import io as tio

import reference_impl as ref
from helpers import SMALL_CFG as JCFG, small_block

torch.set_num_threads(2)

TCFG = T.dam_break_config(**{f: getattr(JCFG, f)
                             for f in JCFG.__dataclass_fields__})
BOX = (8, 8, 8)
K = 12
FLOOR = (0.16, 0.006, 0.16)      # a block resting on the floor
FAST = dict(FAST_MODE_FLAGS)


def _assert_step_close(t, j):
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), atol=2e-6)
    np.testing.assert_allclose(t.vel.numpy(), np.asarray(j.vel), atol=2e-3)
    np.testing.assert_allclose(t.density.numpy(), np.asarray(j.density),
                               rtol=1e-4, atol=1e-6)


def _assert_carry_close(t, j):
    atol = 1e-6 * np.abs(np.asarray(j.pos_last)).max()
    for name in tpbd.PBDCarry._fields:
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-4,
                                   atol=atol)


def _assert_syncs(m, cfg):
    """One host read of ``alive`` per loop test after the first
    iteration, none at the cap."""
    assert int(m["host_syncs"]) == min(int(m["pbd_iters"]),
                                       cfg.pbd_max_iter - 1)


@pytest.fixture(scope="module")
def scenes():
    bpos = J.boundary_positions(JCFG)
    kb = jds.boundary_k(bpos, JCFG)
    return dict(kb=kb,
                jax=jds.build_dense_scene(JCFG, bpos, kb, engine="xlab"),
                port=tds.build_dense_scene(TCFG, bpos, kb, "cpu"))


def _state(which, cfg):
    """(pos, pos_last, dp_warm): a free-falling block away from the walls
    with pos_last = pos, or a jittered block resting on the floor whose
    pos_last trails it by a random velocity step, with a random carried
    projection shift."""
    if which == "falling":
        pos = small_block()
        return pos, pos.copy(), np.zeros_like(pos)
    rng = np.random.default_rng(5)
    pos = small_block(n_side=6, origin=FLOOR)
    pos = pos + rng.uniform(-0.002, 0.002, pos.shape).astype(np.float32)
    vel = rng.normal(0, 0.3, pos.shape).astype(np.float32)
    pos_last = (pos - vel * np.float32(cfg.dt)).astype(np.float32)
    dp_warm = rng.normal(0, 5e-4, pos.shape).astype(np.float32)
    return pos, pos_last, dp_warm


@pytest.mark.parametrize("which,variant", [
    ("falling", {}),
    ("floor", {}),
    ("floor", dict(FAST, chebyshev_start=2)),
    ("floor", dict(pbd_density_tolerance=0.01, pbd_warm_start=0.25)),
    ("floor", dict(FAST, surface_tension=0.0, air_pressure=0.0)),
])
def test_one_step_matches_jax(scenes, which, variant):
    jcfg, tcfg = JCFG.replace(**variant), TCFG.replace(**variant)
    pos, pos_last, dp_warm = _state(which, jcfg)
    js = J.make_fluid_state(pos, jcfg)
    jc = jpbd.PBDCarry(pos_last=jnp.asarray(pos_last),
                       dp_warm=jnp.asarray(dp_warm))
    ts = T.make_fluid_state(pos, tcfg, "cpu")
    tc = tpbd.PBDCarry(pos_last=torch.as_tensor(pos_last),
                       dp_warm=torch.as_tensor(dp_warm))
    dims, dims_b = jdense.dims_for(jcfg, K), jdense.dims_for(jcfg,
                                                             scenes["kb"])
    step = jax.jit(lambda st, ca, sc, dt: jds.pbd_step(
        st, ca, sc, jcfg, dt, dims, dims_b, engine="xlab", box=BOX))
    j1, jc1, jm = step(js, jc, scenes["jax"], jnp.float32(jcfg.dt))
    t1, tc1, tm = tds.pbd_step(ts, tc, scenes["port"], tcfg, tcfg.dt,
                               tdense.dims_for(tcfg, K),
                               tdense.dims_for(tcfg, scenes["kb"]), BOX)
    assert int(jm["capacity"][0]) == 0 and int(jm["capacity"][1]) == 0
    _assert_step_close(t1, j1)
    _assert_carry_close(tc1, jc1)
    it = int(tm["pbd_iters"])
    assert it == int(jm["pbd_iters"])
    assert tm["pbd_iters"].dtype == torch.int32
    _assert_syncs(tm, tcfg)
    if which == "falling":
        # every lambda is 0: one iteration, and the projection leaves the
        # positions exactly where they were
        assert it == 1
        assert torch.equal(tc1.pos_last, ts.pos)
    elif not variant:
        assert it == tcfg.pbd_max_iter          # parity: lambda stays live
    elif "chebyshev_start" in variant:
        assert it > variant["chebyshev_start"]  # the extrapolation engaged
    if "pbd_warm_start" in variant:
        assert np.abs(tc1.dp_warm.numpy()).max() > 0
        assert torch.equal(tc1.dp_warm, tc1.pos_last - ts.pos)


def test_three_frames_vs_float64_oracle():
    """Three parity PBD frames of the port's Simulation against the
    all-pairs float64 oracle (tests/test_solvers.py:86-117): pos_last =
    pos at carry creation. The oracle always runs the fixed 20
    iterations; the port stops at the first all-zero lambda field, which
    must leave the same result."""
    pos0 = small_block(n_side=5, origin=FLOOR)
    sim = T.Simulation(solver="pbd", cfg=TCFG, fluid_pos=pos0,
                       warmup=False, device="cpu")
    bpos = T.boundary_positions(TCFG).astype(np.float64)
    bmass = ref.boundary_mass(bpos, TCFG.radius, TCFG.rho_boundary)
    mass = np.full((pos0.shape[0],), TCFG.m0, np.float64)
    rpos = pos0.astype(np.float64)
    rvel = np.zeros_like(rpos)
    rlast = rpos.copy()
    for _ in range(3):
        sim.step()
        rpos, rvel, rrho, rlast, rit = ref.pbd_step(
            rpos, rvel, mass, bpos, bmass, TCFG, TCFG.dt, rlast)
        assert 1 <= int(sim.metrics["pbd_iters"]) <= rit
    np.testing.assert_allclose(sim.state.pos.numpy(), rpos, rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(sim.state.vel.numpy(), rvel, rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(sim.carry.pos_last.numpy(), rlast, rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(sim.state.density.numpy(), rrho, rtol=2e-4,
                               atol=1e-6)
    assert sim.frame == 3 and sim.dropped_frames == 0


def test_default_simulation_is_pbd_fast_mode():
    """Simulation() with no solver and no config runs the reference's
    default solver in fast mode (tolerance exit + Chebyshev)."""
    sim = T.Simulation(fluid_pos=small_block(), device="cpu")
    assert sim.solver_name == "pbd"
    assert sim.cfg == T.dam_break_config()
    assert sim.cfg.pbd_density_tolerance == 0.01
    assert sim.cfg.pbd_chebyshev_rho == 0.9
    stats = sim.run(2)
    m = sim.metrics
    assert 1 <= int(m["pbd_iters"]) <= sim.cfg.pbd_max_iter
    _assert_syncs(m, sim.cfg)
    assert stats["last_metrics"]["grid_overflow"] == 0
    assert bool(torch.isfinite(sim.state.pos).all())
    assert sim.state.pos[:, 1].mean() < float(small_block()[:, 1].mean())


def test_restart_rebuilds_pbd_carry():
    sim = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=small_block(),
                       warmup=False, device="cpu")
    sim.restart("3")
    assert sim.solver_name == "pbd" and sim.frame == 0
    assert isinstance(sim.carry, tpbd.PBDCarry)
    assert torch.equal(sim.carry.pos_last, sim.state.pos)
    assert sim.carry.pos_last.data_ptr() != sim.state.pos.data_ptr()
    assert not sim.carry.dp_warm.any()


def test_k_retry_restarts_from_committed_carry():
    """A frame whose grid build overflows K is re-run from the committed
    state AND carry at a fitted K: the result equals a run that took the
    same frames at those K from the start, carry included."""
    cfg = TCFG.replace(**FAST)
    pos = small_block(origin=(0.16, 0.02, 0.16))
    sim = T.Simulation(solver="pbd", cfg=cfg, fluid_pos=pos, warmup=False,
                       device="cpu")
    k0 = sim.max_per_cell
    sim.step()
    assert not torch.equal(sim.carry.pos_last, torch.as_tensor(pos))
    sim.max_per_cell = 4
    sim.step()
    assert sim.retries >= 1 and sim.max_per_cell > 4
    assert int(sim.metrics["grid_overflow"]) == 0
    sim2 = T.Simulation(solver="pbd", cfg=cfg.replace(max_per_cell=k0),
                        fluid_pos=pos, warmup=False, auto_capacity=False,
                        device="cpu")
    sim2.step()
    sim2.max_per_cell = sim.max_per_cell
    sim2.step()
    assert sim2.box == sim.box
    for a, b in [(sim.state.pos, sim2.state.pos),
                 (sim.state.vel, sim2.state.vel)] + list(
                     zip(sim.carry, sim2.carry)):
        assert torch.equal(a, b)


def test_pbd_option_checks():
    """The JAX constructor's two PBD checks raise ValueError; the warm
    start is accepted with a tolerance exit."""
    kw = dict(solver="pbd", fluid_pos=small_block(), warmup=False,
              device="cpu")
    with pytest.raises(ValueError, match="engine='reference'"):
        T.Simulation(cfg=TCFG.replace(pbd_rebin_moving=True), **kw)
    with pytest.raises(ValueError, match="pbd_density_tolerance > 0"):
        T.Simulation(cfg=TCFG.replace(pbd_warm_start=0.25), **kw)
    sim = T.Simulation(cfg=TCFG.replace(pbd_warm_start=0.25,
                                        pbd_density_tolerance=0.01), **kw)
    assert sim.cfg.pbd_warm_start == 0.25


def test_jax_checkpoint_resumes_with_carry(tmp_path):
    """A JAX PBD checkpoint saved after 2 frames, with the warm start on so
    that both carry leaves are non-zero, loads into the port with both
    leaves bitwise equal; both then take one more step and agree at the
    step bars."""
    cfg = dict(pbd_density_tolerance=0.01, pbd_warm_start=0.25)
    jsim = J.Simulation(solver="pbd", cfg=JCFG.replace(**cfg),
                        fluid_pos=small_block(origin=FLOOR), warmup=False)
    jsim.run(2)
    assert np.abs(np.asarray(jsim.carry.dp_warm)).max() > 0
    path = str(tmp_path / "jax_pbd.npz")
    jio.save_checkpoint(path, jsim)
    tsim = tio.load_checkpoint(path, device="cpu")
    assert tsim.solver_name == "pbd" and tsim.frame == jsim.frame
    for name in tpbd.PBDCarry._fields:
        np.testing.assert_array_equal(getattr(tsim.carry, name).numpy(),
                                      np.asarray(getattr(jsim.carry, name)))
    jsim.step()
    tsim.step()
    _assert_step_close(tsim.state, jsim.state)
    assert int(tsim.metrics["pbd_iters"]) == int(jsim.metrics["pbd_iters"])
