"""The PyTorch port's smoothing kernels, binning, dense/box index, fill,
read and boundary window against the JAX package.

Index outputs must match exactly and the filled grids bitwise: a particle
binned one cell off, or ranked differently within its cell, changes which
pairs every later pass sees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu.ops import box as jbox
from cpp_fluid_particles_tpu.ops import dense as jdense
from cpp_fluid_particles_tpu.ops import grid as jgrid
from cpp_fluid_particles_tpu.ops import kernels as jk
from cpp_fluid_particles_tpu.models import dense_step as jds

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch.models import dense_step as tds
from cpp_fluid_particles_tpu_torch.ops import box as tbox
from cpp_fluid_particles_tpu_torch.ops import column_pass_cuda as tcc
from cpp_fluid_particles_tpu_torch.ops import dense as tdense
from cpp_fluid_particles_tpu_torch.ops import grid as tgrid
from cpp_fluid_particles_tpu_torch.ops import kernels as tk
from cpp_fluid_particles_tpu_torch.ops import passes as tpp

torch.set_num_threads(2)

JCFG = J.dam_break_config(mode="parity")
TCFG = T.dam_break_config(mode="parity")
H = JCFG.radius


# ----------------------------------------------------------------------
# smoothing kernels

def _radii():
    rng = np.random.default_rng(0)
    r = np.concatenate([
        np.linspace(0.0, 1.2 * H, 4001),
        rng.uniform(0.0, 1.1 * H, 4000),
        [0.5 * H, H, 1e-7, 1.7e6],
    ]).astype(np.float32)
    return r


@pytest.mark.parametrize("name", ["w_cubic", "grad_w_cubic_coef",
                                  "w_visc_laplacian", "grad_w_surface_coef"])
def test_scalar_kernels_match(name):
    r = _radii()
    want = np.asarray(getattr(jk, name)(jnp.asarray(r), H))
    got = getattr(tk, name)(torch.as_tensor(r), H).numpy()
    assert got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


VECTOR_COEFS = {"grad_w_cubic": tk.grad_w_cubic_coef,
                "grad_w_surface_tension": tk.grad_w_surface_coef}


@pytest.mark.parametrize("name", list(VECTOR_COEFS))
def test_vector_kernels_match(name):
    """The vector kernels against JAX's at atol 1e-6 x max|JAX|.

    The two packages compute |r|^2 and the coefficient with the same
    float32 operations; only the sqrt between them can round differently.
    The bar's headroom is the output's conditioning in |r|, measured below
    on these inputs: moving |r| by one ulp moves the output by at most 0.57
    (grad_w_cubic) and 0.47 (grad_w_surface_tension) of the bar, by two
    ulps 0.88 and 0.74. The port's |r| is the correctly rounded sqrt on
    every host (``kernels.norm``; torch's own float32 sqrt follows MKL's
    CPU path and misrounds 0, 30 or 923 of these inputs), so a JAX sqrt
    within one ulp keeps the comparison within 0.6 of the bar."""
    rng = np.random.default_rng(1)
    rvec = rng.uniform(-0.7 * H, 0.7 * H, (5000, 3)).astype(np.float32)
    rvec[0] = 0.0
    want = np.asarray(getattr(jk, name)(jnp.asarray(rvec), H))
    bar = 1e-6 * np.abs(want).max()
    t = torch.as_tensor(rvec)
    got = getattr(tk, name)(t, H).numpy()
    r2 = torch.sum(t * t, dim=-1)
    r = tk.norm(t)
    np.testing.assert_array_equal(
        r.numpy(), np.sqrt(r2.numpy().astype(np.float64)).astype(np.float32))
    # the conditioning the bar rests on: one ulp of |r| stays under 0.6 bar
    for toward in (np.inf, -np.inf):
        moved = torch.nextafter(r, torch.full_like(r, toward))
        shift = VECTOR_COEFS[name](moved, H)[..., None] * t
        assert np.abs(shift.numpy() - got).max() <= 0.6 * bar
    np.testing.assert_allclose(got, want, rtol=0, atol=bar)


def test_w_cubic_max_equal():
    assert tk.w_cubic_max(H) == jk.w_cubic_max(H)


# ----------------------------------------------------------------------
# binning, index, fill, read

def _dam():
    return T.dam_break_positions(TCFG)


def _splash():
    """A perturbed mid-splash state: the dam smeared over several cells,
    a dense clump (high occupancy), particles on exact cell edges, and a
    few outside the domain."""
    rng = np.random.default_rng(7)
    pos = _dam().astype(np.float64)
    pos += rng.normal(0.0, 0.04, pos.shape)
    pos[:400] = 0.5 + rng.uniform(-0.02, 0.02, (400, 3))
    cl = np.float32(TCFG.cell_length)
    pos[400:600] = (rng.integers(0, 25, (200, 3)) * cl).astype(np.float64)
    pos[600:620] = rng.uniform(-0.1, 1.1, (20, 3))
    return np.clip(pos, -0.05, 1.05).astype(np.float32)


STATES = {"dam": _dam, "splash": _splash}


@pytest.mark.parametrize("which", list(STATES))
def test_cell_coords_bitwise(which):
    pos = STATES[which]()
    want = np.asarray(jgrid.cell_coords(jnp.asarray(pos), JCFG))
    got = tgrid.cell_coords(torch.as_tensor(pos), TCFG)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _cmp_index(ji, ti, fields):
    for f in fields:
        a, b = np.asarray(getattr(ji, f)), getattr(ti, f).numpy()
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("which", list(STATES))
@pytest.mark.parametrize("k", [4, 16])
def test_build_dense_index_exact(which, k):
    pos = STATES[which]()
    jd, td = jdense.dims_for(JCFG, k), tdense.dims_for(TCFG, k)
    assert tuple(td) == tuple(jd)
    ji = jdense.build_dense_index(jnp.asarray(pos), JCFG, jd)
    ti = tdense.build_dense_index(torch.as_tensor(pos), TCFG, td)
    _cmp_index(ji, ti, ("slots", "valid", "overflow", "max_occupancy"))


def test_build_dense_index_boundary_exact():
    bpos = T.boundary_positions(TCFG)
    kb = tds.boundary_k(bpos, TCFG)
    assert kb == jds.boundary_k(bpos, JCFG)
    ji = jdense.build_dense_index(jnp.asarray(bpos), JCFG,
                                  jdense.dims_for(JCFG, kb))
    ti = tdense.build_dense_index(torch.as_tensor(bpos), TCFG,
                                  tdense.dims_for(TCFG, kb))
    _cmp_index(ji, ti, ("slots", "valid", "overflow", "max_occupancy"))
    assert int(ti.overflow) == 0


BOX_CASES = {
    # (state, K, box): fitted, K overflow, box overflow
    "dam_fit": ("dam", 12, (20, 28, 12)),
    "splash_fit": ("splash", 40, (24, 24, 24)),
    "splash_k": ("splash", 8, (24, 24, 24)),
    "splash_box": ("splash", 40, (8, 12, 8)),
}


def _box_index(case):
    which, k, box = BOX_CASES[case]
    pos = STATES[which]()
    full_j, full_t = jdense.dims_for(JCFG, k), tdense.dims_for(TCFG, k)
    bj = jdense.DenseDims(*box, k)
    bt = tdense.DenseDims(*box, k)
    ji = jbox.build_box_index(jnp.asarray(pos), JCFG, full_j, bj)
    ti = tbox.build_box_index(torch.as_tensor(pos), TCFG, full_t, bt)
    return pos, bj, bt, ji, ti


@pytest.mark.parametrize("case", list(BOX_CASES))
def test_build_box_index_exact(case):
    _, _, _, ji, ti = _box_index(case)
    _cmp_index(ji, ti, ("slots", "valid", "origin", "ext", "overflow",
                        "box_overflow", "max_occupancy"))
    if case == "splash_k":
        assert int(ti.overflow) > 0
    if case == "splash_box":
        assert int(ti.box_overflow) > 0


@pytest.mark.parametrize("case", ["dam_fit", "splash_k", "splash_box"])
def test_fill_bitwise_and_read_exact(case):
    pos, bj, bt, ji, ti = _box_index(case)
    rng = np.random.default_rng(3)
    vel = rng.normal(0, 1, pos.shape).astype(np.float32)
    fields = [pos[:, 0], pos[:, 1], pos[:, 2], vel[:, 0], vel[:, 1],
              vel[:, 2]]
    fills = [tgrid.POS_PAD] * 3 + [0.0] * 3
    jg = jbox.fill_box(ji, [jnp.asarray(f) for f in fields], fills, bj,
                       mode="scatter")
    tg = tbox.fill_box(ti, [torch.as_tensor(f) for f in fields], fills, bt)
    assert tg.is_contiguous() and tg.shape == (6, bt.k, bt.g)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    jr = jbox.read_box(ji, jg)
    tr = tbox.read_box(ti, tg)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_slice_boundary_box_exact():
    cfg_small = dict(space_size=(0.52, 0.52, 0.52))
    jc = J.dam_break_config(mode="parity", **cfg_small)
    tc = T.dam_break_config(mode="parity", **cfg_small)
    bpos = T.boundary_positions(tc)
    kb = tds.boundary_k(bpos, tc)
    jscene = jds.build_dense_scene(jc, bpos, kb, engine="xlab")
    full_j, full_t = jdense.dims_for(jc, kb), tdense.dims_for(tc, kb)
    bd_t = torch.as_tensor(np.array(jscene.bd))
    for origin in [(0, 0, 0), (3, 1, 4), (5, 5, 5)]:
        bj = jdense.DenseDims(8, 8, 8, kb)
        bt = tdense.DenseDims(8, 8, 8, kb)
        want = jbox.slice_boundary_box(jscene.bd, full_j, bj, kb,
                                       jnp.asarray(origin, jnp.int32))
        got = tbox.slice_boundary_box(
            bd_t, full_t, bt, torch.tensor(origin, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ----------------------------------------------------------------------
# the CUDA wrapper and the dispatcher never fall back

def test_cuda_wrapper_rejects_cpu_tensors():
    d = tdense.DenseDims(3, 3, 3, 2)
    fl = torch.zeros((7, d.k, d.g))
    bd = torch.zeros((4, d.k, d.g))
    before = dict(tcc.LAUNCHES)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tcc.column_pass_cuda("density_colorgrad_visc", fl, bd, d, d, TCFG)
    assert tcc.LAUNCHES == before


def test_dispatch_by_device():
    d = tdense.DenseDims(3, 3, 3, 2)
    fl = torch.full((4, d.k, d.g), 0.0)
    fl[:3] = tgrid.POS_PAD
    bd = fl.clone()
    out = tpp.column_pass("density", fl, bd, d, d, TCFG)
    assert out.shape == (1, d.k, d.g) and not out.abs().any()
    with pytest.raises(ValueError, match="no neighbor-pass executor"):
        tpp.column_pass("density", fl.to("meta"), bd.to("meta"), d, d, TCFG)
