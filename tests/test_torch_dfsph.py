"""The PyTorch port's DFSPH solver on the CPU: one step against the JAX
package's sliding-box step, two frames against the float64 oracle, the
Simulation's iteration bounds, its capacity retry and checkpoint resume.

Bars: one step as tests/test_pallas_engine.py:149-152 and
tests/test_dense_engine.py:57-66 (pos atol 2e-6, vel atol 2e-3, density
rtol 1e-4, equal iteration counts); the carry leaves at rtol 1e-4, atol
1e-6 x their max; two frames against the oracle as
tests/test_solvers.py:48-80.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu.models import dense_step as jds
from cpp_fluid_particles_tpu.models import dfsph as jdf
from cpp_fluid_particles_tpu.ops import dense as jdense
from cpp_fluid_particles_tpu.utils import io as jio

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch.models import dense_step as tds
from cpp_fluid_particles_tpu_torch.models import dfsph as tdf
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


def _assert_step_close(t, j):
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), atol=2e-6)
    np.testing.assert_allclose(t.vel.numpy(), np.asarray(j.vel), atol=2e-3)
    np.testing.assert_allclose(t.density.numpy(), np.asarray(j.density),
                               rtol=1e-4, atol=1e-6)


def _assert_carry_close(t, j):
    for name in tdf.DFSPHCarry._fields:
        want = np.asarray(getattr(j, name))
        np.testing.assert_allclose(getattr(t, name).numpy(), want,
                                   rtol=1e-4, atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def scenes():
    bpos = J.boundary_positions(JCFG)
    kb = jds.boundary_k(bpos, JCFG)
    return dict(kb=kb,
                jax=jds.build_dense_scene(JCFG, bpos, kb, engine="xlab"),
                port=tds.build_dense_scene(TCFG, bpos, kb, "cpu"))


def _state(which):
    """A free-falling block away from the walls, or a jittered block
    resting on the floor with random velocities (boundary terms on, and
    real work for both solves)."""
    if which == "falling":
        pos = small_block()
        return pos, np.zeros_like(pos)
    rng = np.random.default_rng(5)
    pos = small_block(n_side=7, origin=FLOOR)
    pos = pos + rng.uniform(-0.002, 0.002, pos.shape).astype(np.float32)
    return pos, rng.normal(0, 0.3, pos.shape).astype(np.float32)


@pytest.mark.parametrize("which,variant", [
    ("falling", {}),
    ("floor", {}),
    ("floor", dict(dfsph_chebyshev_rho=0.9)),
    ("floor", dict(dfsph_chebyshev_rho=0.9, dfsph_cheb_density_only=True)),
    ("floor", dict(surface_tension=0.0, air_pressure=0.0)),
])
def test_one_step_matches_jax(scenes, which, variant):
    jcfg, tcfg = JCFG.replace(**variant), TCFG.replace(**variant)
    pos, vel = _state(which)
    js = J.make_fluid_state(pos, jcfg)
    js = js._replace(vel=js.vel + vel)
    ts = T.make_fluid_state(pos, tcfg, "cpu")._replace(
        vel=torch.as_tensor(np.array(js.vel)))
    dims, dims_b = jdense.dims_for(jcfg, K), jdense.dims_for(jcfg,
                                                             scenes["kb"])
    step = jax.jit(lambda st, ca, sc, dt: jds.dfsph_step(
        st, ca, sc, jcfg, dt, dims, dims_b, engine="xlab", box=BOX))
    j1, jc, jm = step(js, jdf.init_carry(js), scenes["jax"],
                      jnp.float32(jcfg.dt))
    t1, tc, tm = tds.dfsph_step(ts, tdf.init_carry(ts), scenes["port"],
                                tcfg, tcfg.dt, tdense.dims_for(tcfg, K),
                                tdense.dims_for(tcfg, scenes["kb"]), BOX)
    assert int(jm["capacity"][0]) == 0 and int(jm["capacity"][1]) == 0
    _assert_step_close(t1, j1)
    _assert_carry_close(tc, jc)
    for key in ("divergence_iters", "density_iters"):
        assert int(tm[key]) == int(jm[key]), key
    for key in ("divergence_error", "density_error"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-3)
    # one host read of the error sum per loop test past the minimum
    # iteration counts (1 and 2), none at the cap
    it_d, it_n = int(tm["divergence_iters"]), int(tm["density_iters"])
    cap = tcfg.dfsph_max_iter
    assert int(tm["host_syncs"]) == (min(it_d, cap - 1)
                                     + min(it_n, cap - 1) - 1)
    if which == "floor":
        assert np.abs(tc.warm_stiff.numpy()).max() > 0


def test_two_frames_vs_float64_oracle():
    """Two DFSPH frames of the port's Simulation against the all-pairs
    float64 oracle, with equal iteration counts, in the reference-exact
    mode (no divergence warm start) of tests/test_solvers.py:48-80. Frame
    2 applies the non-zero density warm start carried from frame 1."""
    pos0 = small_block(origin=FLOOR)
    cfg = TCFG.replace(dfsph_warm_divergence=0.0)
    sim = T.Simulation(solver="dfsph", cfg=cfg, fluid_pos=pos0,
                       warmup=False, device="cpu")
    bpos = T.boundary_positions(cfg).astype(np.float64)
    bmass = ref.boundary_mass(bpos, cfg.radius, cfg.rho_boundary)
    mass = np.full((pos0.shape[0],), cfg.m0, np.float64)
    rpos, rvel = pos0.astype(np.float64), np.zeros_like(pos0, np.float64)
    rwarm = np.zeros((pos0.shape[0],), np.float64)
    for frame in range(2):
        if frame == 1:
            assert np.abs(sim.carry.warm_stiff.numpy()).max() > 0.0
        sim.step()
        rpos, rvel, rrho, rwarm, rdiv_it, rden_it = ref.dfsph_step(
            rpos, rvel, mass, bpos, bmass, cfg, cfg.dt, rwarm)
        assert int(sim.metrics["divergence_iters"]) == rdiv_it
        assert int(sim.metrics["density_iters"]) == rden_it
    np.testing.assert_allclose(sim.state.pos.numpy(), rpos, rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(sim.state.vel.numpy(), rvel, rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(
        sim.carry.warm_stiff.numpy(), rwarm, rtol=5e-3,
        atol=np.abs(rwarm).max() * 1e-3 + 1e-12)
    assert sim.frame == 2 and sim.dropped_frames == 0


def test_iteration_bounds_and_errors():
    """tests/test_solvers.py:249-265 on the port: each solve stops either
    below its threshold or at the iteration cap."""
    sim = T.Simulation(solver="dfsph", cfg=TCFG, fluid_pos=small_block(),
                       device="cpu")
    n = sim.fluid_size
    for _ in range(8):
        sim.step()
        m = {k: float(v) for k, v in sim.metrics.items() if v.numel() == 1}
        assert 1 <= m["divergence_iters"] <= TCFG.dfsph_max_iter
        assert 2 <= m["density_iters"] <= TCFG.dfsph_max_iter
        if m["divergence_iters"] < TCFG.dfsph_max_iter:
            assert m["divergence_error"] <= (
                TCFG.dfsph_divergence_threshold * n * TCFG.rho0 * 1.001)
        if m["density_iters"] < TCFG.dfsph_max_iter:
            assert m["density_error"] <= (
                TCFG.dfsph_density_threshold * n * TCFG.rho0 * 1.001)


def test_k_retry_restarts_from_committed_carry():
    """A frame whose grid build overflows K is re-run from the committed
    state AND carry at a fitted K: the result equals a run that took the
    same frames at those K from the start, carry included."""
    pos = small_block(origin=(0.16, 0.02, 0.16))
    sim = T.Simulation(solver="dfsph", cfg=TCFG, fluid_pos=pos,
                       warmup=False, device="cpu")
    k0 = sim.max_per_cell
    sim.step()
    assert np.abs(sim.carry.warm_stiff.numpy()).max() > 0.0
    sim.max_per_cell = 4
    sim.step()
    assert sim.retries >= 1 and sim.max_per_cell > 4
    assert int(sim.metrics["grid_overflow"]) == 0
    sim2 = T.Simulation(solver="dfsph", cfg=TCFG.replace(max_per_cell=k0),
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


def test_restart_rebuilds_carry():
    sim = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=small_block(),
                       warmup=False, device="cpu")
    assert sim.carry == ()
    sim.restart("2")
    assert sim.solver_name == "dfsph" and sim.frame == 0
    assert isinstance(sim.carry, tdf.DFSPHCarry)
    sim.step()
    sim.restart()
    assert sim.frame == 0
    assert sim.carry.warm_stiff.data_ptr() != sim.carry.div_warm.data_ptr()
    assert not any(bool(c.any()) for c in sim.carry)


def test_jax_checkpoint_resumes_with_carry(tmp_path):
    """A JAX DFSPH checkpoint with a non-zero carry loads into the port
    with both carry leaves bitwise equal; both then take 2 more steps and
    agree at the step bars."""
    jsim = J.Simulation(solver="dfsph", cfg=JCFG,
                        fluid_pos=small_block(origin=FLOOR), warmup=False)
    jsim.run(2)
    assert np.abs(np.asarray(jsim.carry.warm_stiff)).max() > 0
    assert np.abs(np.asarray(jsim.carry.div_warm)).max() > 0
    path = str(tmp_path / "jax_dfsph.npz")
    jio.save_checkpoint(path, jsim)
    tsim = tio.load_checkpoint(path, device="cpu")
    assert tsim.solver_name == "dfsph" and tsim.frame == jsim.frame
    for name in tdf.DFSPHCarry._fields:
        np.testing.assert_array_equal(getattr(tsim.carry, name).numpy(),
                                      np.asarray(getattr(jsim.carry, name)))
    for _ in range(2):
        jsim.step()
        tsim.step()
    _assert_step_close(tsim.state, jsim.state)


def test_checkpoint_carry_padding_and_excess(tmp_path):
    """A checkpoint with fewer carry arrays than the solver's carry resumes
    with the missing leaves at zero (as the JAX package does); one with
    more raises."""
    sim = T.Simulation(solver="dfsph", cfg=TCFG, fluid_pos=small_block(),
                       device="cpu")
    sim.run(1)
    path = str(tmp_path / "port.npz")
    tio.save_checkpoint(path, sim)
    with np.load(path) as z:
        arrays = dict(z)
    short = str(tmp_path / "short.npz")
    np.savez(short, **{k: v for k, v in arrays.items() if k != "carry_1"})
    back = tio.load_checkpoint(short, device="cpu")
    assert torch.equal(back.carry.warm_stiff, sim.carry.warm_stiff)
    assert not back.carry.div_warm.any()
    extra = str(tmp_path / "extra.npz")
    np.savez(extra, carry_2=arrays["carry_0"], **arrays)
    with pytest.raises(ValueError, match="carries 3 arrays"):
        tio.load_checkpoint(extra, device="cpu")
