"""The PyTorch port's neighbor passes (plain executor) against the JAX
package's executors.

Setup as tests/test_pallas_engine.py:32-73: a 5^3 jittered block in the
7^3-cell TINY domain, with random velocities, densities, pressures and
colour gradients. The same operands, as numpy arrays, go through both
packages. The JAX side runs its plain 27-offset oracle (``xla27``), its
symmetric executor (``xla``, and over the sliding box as ``xlab`` does),
and, in the slow tier, the interpreted Pallas kernel itself. The bar is
the one the JAX package holds its Pallas kernel to
(tests/test_pallas_engine.py:125-126): rtol 2e-5, atol 2e-5 x max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu.models import dense_step as jds
from cpp_fluid_particles_tpu.ops import box as jbox
from cpp_fluid_particles_tpu.ops import dense as jdense
from cpp_fluid_particles_tpu.ops import pallas_passes as jpp

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch.ops import dense as tdense
from cpp_fluid_particles_tpu_torch.ops import passes as tpp

torch.set_num_threads(2)

TINY = dict(mode="parity", space_size=(0.28, 0.28, 0.28),
            max_active_cells=512, max_per_cell=16)
JCFG = J.dam_break_config(**TINY)
TCFG = T.dam_break_config(**TINY)
BOX = (5, 5, 5)

# rows of the stacked grid built in setup()
POS3, MASS, VEL3 = slice(0, 3), slice(3, 4), slice(4, 7)
RHO, P, CG3, STIFF = slice(7, 8), slice(8, 9), slice(9, 12), slice(12, 13)

# pass name -> (JAX pass function, rows)
PASSES = {
    "density": (jpp.density_pass, (POS3, MASS)),
    "density_colorgrad_visc": (jpp.density_colorgrad_visc_pass,
                               (POS3, MASS, VEL3)),
    "surface_pressure": (jpp.surface_pressure_pass,
                         (POS3, MASS, RHO, P, CG3)),
    "density_alpha_colorgrad": (jpp.density_alpha_colorgrad_pass,
                                (POS3, MASS)),
    "divergence": (jpp.divergence_pass, (POS3, MASS, VEL3)),
    "stiffness_accel": (jpp.stiffness_accel_pass, (POS3, MASS, STIFF)),
    "viscosity": (jpp.viscosity_pass, (POS3, MASS, VEL3)),
    "surface": (jpp.surface_pass, (POS3, MASS, CG3)),
    "density_alpha": (jpp.density_alpha_pass, (POS3, MASS)),
    "density_visc": (jpp.density_visc_pass, (POS3, MASS, VEL3)),
    "pressure_force": (jpp.pressure_force_pass, (POS3, MASS, RHO, P)),
    "pbd_lambda": (jpp.pbd_lambda_pass, (POS3, MASS)),
    "xsph_colorgrad": (jpp.xsph_colorgrad_pass, (POS3, MASS, VEL3)),
    "xsph": (jpp.xsph_pass, (POS3, MASS, VEL3)),
    "color_gradient": (jpp.color_gradient_pass, (POS3, MASS)),
    "density_colorgrad": (jpp.density_colorgrad_pass, (POS3, MASS)),
}


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    cfg = JCFG
    bpos = J.boundary_positions(cfg)
    kb = jds.boundary_k(bpos, cfg)
    dims = jdense.dims_for(cfg)
    dims_b = jdense.dims_for(cfg, kb)
    scene = jds.build_dense_scene(cfg, bpos, kb, engine="xla")

    rng = np.random.default_rng(11)
    s = cfg.spacing
    pos = np.array(
        [(0.08 + s * i, 0.01 + s * j, 0.08 + s * k)
         for i in range(5) for j in range(5) for k in range(5)], np.float32)
    pos += rng.uniform(-0.002, 0.002, pos.shape).astype(np.float32)
    n = pos.shape[0]
    vel = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    rows = [pos[:, 0], pos[:, 1], pos[:, 2],
            np.full((n,), cfg.m0, np.float32),
            vel[:, 0], vel[:, 1], vel[:, 2],
            (1.0 + rng.uniform(0, 0.2, n)).astype(np.float32),
            rng.uniform(0, 2.0, n).astype(np.float32)]
    cg = rng.normal(0, 5.0, (n, 3)).astype(np.float32)
    rows += [cg[:, 0], cg[:, 1], cg[:, 2],
             rng.normal(0, 1e-3, n).astype(np.float32)]     # stiffness
    fills = [jdense.POS_PAD] * 3 + [0.0] * 10

    idx = jdense.build_dense_index(jnp.asarray(pos), cfg, dims)
    assert int(idx.overflow) == 0
    full = jdense.fill_dense(idx, rows, fills, dims)

    bdims = jdense.DenseDims(*BOX, dims.k)
    bdims_b = jdense.DenseDims(*BOX, kb)
    bidx = jbox.build_box_index(jnp.asarray(pos), cfg, dims, bdims)
    assert int(bidx.box_overflow) == 0 and int(bidx.overflow) == 0
    boxg = jbox.fill_box(bidx, rows, fills, bdims, mode="scatter")
    bd_box = jbox.slice_boundary_box(scene.bd, dims, bdims, kb, bidx.origin)
    # the box window must reach the walls, or the boundary terms go untested
    assert int(jnp.sum(bd_box[0] < jds.POS_GUARD)) > 0
    return dict(
        grids={"full": (full, scene.bd, dims, dims_b, idx.col_count),
               "box": (boxg, bd_box, bdims, bdims_b, None)},
        bpos=bpos, kb=kb, pos=pos, rows=rows, fills=fills)


def _operands(grid, rows):
    g, bd, dims, dims_b, colc = grid
    fl = jnp.concatenate([g[r] for r in rows], 0)
    return fl, bd, dims, dims_b, colc


def _jax(name, fl, bd, colc, dims, dims_b, engine):
    """The JAX pass; fluid-only passes take no boundary operand."""
    fn = PASSES[name][0]
    if tpp.PASSES[name].has_bd:
        return fn(fl, bd, colc, dims, dims_b, JCFG, engine=engine)
    return fn(fl, colc, dims, JCFG, engine=engine)


def _port(name, fl, bd, dims, dims_b):
    tbd, tdb = None, None
    if tpp.PASSES[name].has_bd:
        tbd, tdb = _t(bd), tdense.DenseDims(*dims_b)
    out = tpp.column_pass_plain(name, _t(fl), tbd, tdense.DenseDims(*dims),
                                tdb, TCFG)
    assert out.shape == (tpp.PASSES[name].n_out, dims.k, dims.g)
    return out.numpy()


def _check(got, want):
    want = np.asarray(want).reshape(got.shape)
    assert np.isfinite(got).all()
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


@pytest.mark.parametrize("grid,engine", [("full", "xla27"), ("full", "xla"),
                                         ("box", "xla")])
@pytest.mark.parametrize("name", list(PASSES))
def test_pass_matches_jax(setup, name, grid, engine):
    fl, bd, dims, dims_b, colc = _operands(setup["grids"][grid],
                                           PASSES[name][1])
    want = _jax(name, fl, bd, colc, dims, dims_b, engine)
    _check(_port(name, fl, bd, dims, dims_b), want)


def test_scene_build_pass_matches_jax(setup):
    """The scene build's density pass: boundary vs boundary on the
    full-domain boundary grid, with a zero-mass j operand whose positions
    are real (dense_step.py:154-156)."""
    kb = setup["kb"]
    dims_b = jdense.dims_for(JCFG, kb)
    bpos = jnp.asarray(setup["bpos"])
    idx = jdense.build_dense_index(bpos, JCFG, dims_b)
    ones = jnp.ones((bpos.shape[0],), jnp.float32)
    fl = jdense.fill_dense(idx, [bpos[:, 0], bpos[:, 1], bpos[:, 2], ones],
                           [jdense.POS_PAD] * 3 + [0.0], dims_b)
    zero_bd = fl.at[3].set(0.0)
    want = jpp.density_pass(fl, zero_bd, idx.col_count, dims_b, dims_b,
                            JCFG, "xla")
    _check(_port("density", fl, zero_bd, dims_b, dims_b), want)


def test_empty_slots_and_ghosts_are_zero(setup):
    """Outputs are zero on ghost cells and empty i slots (up to the sign
    of zero), as the JAX executors give there."""
    fl, bd, dims, dims_b, _ = _operands(setup["grids"]["box"],
                                        PASSES["surface_pressure"][1])
    out = _port("surface_pressure", fl, bd, dims, dims_b)
    empty = np.asarray(fl[0]) >= jds.POS_GUARD
    assert empty.any() and (out[:, empty] == 0).all()


@pytest.mark.slow
@pytest.mark.parametrize("name", list(PASSES))
def test_pass_matches_pallas_interpret(setup, name):
    """Against the Pallas kernel itself, run by the Pallas interpreter."""
    fl, _, dims, dims_b, colc = _operands(setup["grids"]["full"],
                                          PASSES[name][1])
    scene = jds.build_dense_scene(JCFG, setup["bpos"], setup["kb"],
                                  engine="interpret")
    want = _jax(name, fl, scene.bd_jcols, colc, dims, dims_b, "interpret")
    _check(_port(name, fl, scene.bd, dims, dims_b), want)
