"""The cell-packed records of surface and surface_pressure, on the CPU.

On a card the record kernel (``column_pass_cuda.record_pass_cuda``)
walks records that its pack writes from the pass's operand: slot s of cell
c at record c*K + s, as ``{x, y, z, m}`` and the slot's j side (|cg|^2,
and for surface_pressure p / max(eps, rho^2)), the boundary window's
``{x, y, z, m}`` at c*Kb + s. The pack kernel is held bitwise to
``pack_records_plain`` on the card (tests/test_torch_cuda.py); here that
plain version is held to the layout and to the plain pass bodies'
arithmetic, on the dam's operand and on a 2x2 block's window whose ghost
faces are stale until an exchange refreshes them; and the plain surface and
surface_pressure passes, which the kernel is held to, to the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu.ops import box as jbox
from cpp_fluid_particles_tpu.ops import dense as jdense
from cpp_fluid_particles_tpu.ops import pallas_passes as jpp

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch.ops import column_pass_cuda as tcc
from cpp_fluid_particles_tpu_torch.ops import passes as tpp
from cpp_fluid_particles_tpu_torch.ops.dense import DenseDims
from cpp_fluid_particles_tpu_torch.ops.grid import POS_PAD
from cpp_fluid_particles_tpu_torch.parallel import halo
from cpp_fluid_particles_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

TCFG = T.dam_break_config(mode="parity")
JCFG = J.dam_break_config(mode="parity")
K, KB, BOX = 12, 7, (20, 24, 20)      # holds the dam at frame 0
NAMES = tuple(tcc.RECORD_IDS)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def dam():
    """The dam's box operands, filled by the JAX package: every pass row
    [pos3, mass, rho, p, cg3] (rho, p and cg random, seeded; p negative
    for some slots, as the EOS gives below rho0) and the boundary window
    [pos3, mass] (masses random) -> (fl (9, K, G), bd (4, Kb, G), dims,
    dims_b) as numpy arrays and port DenseDims."""
    rng = np.random.default_rng(19)
    pos = J.dam_break_positions(JCFG)
    n = pos.shape[0]
    rows = [pos[:, 0], pos[:, 1], pos[:, 2],
            np.full((n,), JCFG.m0, np.float32),
            rng.uniform(900.0, 1100.0, n).astype(np.float32),
            rng.uniform(-50.0, 400.0, n).astype(np.float32)]
    rows += list(rng.normal(0.0, 20.0, (3, n)).astype(np.float32))
    dims = jdense.dims_for(JCFG, K)
    bdims = jdense.DenseDims(*BOX, K)
    idx = jbox.build_box_index(jnp.asarray(pos), JCFG, dims, bdims)
    assert int(idx.overflow) == 0 and int(idx.box_overflow) == 0
    fl = jbox.fill_box(idx, rows, [jdense.POS_PAD] * 3 + [0.0] * 6, bdims,
                       mode="scatter")
    bpos = J.boundary_positions(JCFG)
    dims_b = jdense.dims_for(JCFG, KB)
    bidx = jdense.build_dense_index(jnp.asarray(bpos), JCFG, dims_b)
    assert int(bidx.overflow) == 0
    bmass = rng.uniform(0.5, 1.5, bpos.shape[0]).astype(np.float32) * JCFG.m0
    bd = jdense.fill_dense(bidx, [bpos[:, 0], bpos[:, 1], bpos[:, 2], bmass],
                           [jdense.POS_PAD] * 3 + [0.0], dims_b)
    bd = jbox.slice_boundary_box(bd, dims, bdims, KB, idx.origin)
    assert int(jnp.sum(bd[0] < POS_PAD / 2)) > 0
    return (np.asarray(fl), np.asarray(bd), DenseDims(*BOX, K),
            DenseDims(*BOX, KB))


def _rows(name, fl):
    """The pass's operand rows of the stacked [pos3, mass, rho, p, cg3]."""
    return fl if name == "surface_pressure" else np.concatenate(
        [fl[:4], fl[6:9]])


def _operands(name, dam):
    fl, bd, dims, dims_b = dam
    has_bd = tpp.PASSES[name].has_bd
    return (_t(_rows(name, fl)), _t(bd) if has_bd else None, dims,
            dims_b if has_bd else None)


def _side_of_bodies(name, f, cfg):
    """The j side as the plain pass bodies write it (ops/passes.py
    _surface_terms: ``j[4] * j[4] + j[5] * j[5] + j[6] * j[6]``;
    _surface_pressure_terms: ``j[6] * j[6] + j[7] * j[7] + j[8] * j[8]``
    and ``over``: ``f[5] / torch.clamp(f[4] * f[4], min=eps)``)."""
    if name == "surface":
        return [f[4] * f[4] + f[5] * f[5] + f[6] * f[6]]
    return [f[6] * f[6] + f[7] * f[7] + f[8] * f[8],
            f[5] / torch.clamp(f[4] * f[4], min=cfg.epsilon)]


def _holds_the_layout(name, fl, bd, dims, dims_b, recs):
    """Record c*K + s of ``recs`` holds slot s of cell c of fl: [x, y, z, m]
    and the bodies' j side, padding slots and ghost cells included
    (bitwise); the boundary's at c*Kb + s."""
    k, g = dims.k, dims.g
    assert recs.geo.shape == (g * k, 4) and recs.geo.is_contiguous()
    geo = recs.geo.reshape(g, k, 4)
    assert torch.equal(geo.permute(2, 1, 0), fl[:4])
    side = _side_of_bodies(name, fl, TCFG)
    if name == "surface":
        assert recs.side.shape == (g * k,)
        assert torch.equal(recs.side.reshape(g, k).T, side[0])
    else:
        assert recs.side.shape == (g * k, 2)
        got = recs.side.reshape(g, k, 2)
        for j in range(2):
            assert torch.equal(got[..., j].T, side[j])
    # one record spelled out: the last slot of the fullest interior cell
    c = int(torch.argmax((fl[0] < POS_PAD / 2).sum(0)))
    s = int((fl[0, :, c] < POS_PAD / 2).sum()) - 1
    assert s >= 1
    assert torch.equal(recs.geo[c * k + s], fl[:4, s, c])
    # a padding slot keeps its POS_PAD position, so a walk stops there
    pad = fl[0] >= POS_PAD / 2
    assert bool(pad.any())
    assert bool((geo[..., 0].T[pad] == POS_PAD).all())
    if bd is None:
        assert recs.bgeo is None
    else:
        assert recs.bgeo.shape == (g * dims_b.k, 4)
        assert torch.equal(recs.bgeo.reshape(g, dims_b.k, 4).permute(2, 1, 0),
                           bd)


@pytest.mark.parametrize("name", NAMES)
def test_pack_puts_each_slot_at_its_record_on_the_dam(dam, name):
    fl, bd, dims, dims_b = _operands(name, dam)
    before = dict(tcc.LAUNCHES)
    recs = tcc.pack_records(name, fl, bd, dims, dims_b, TCFG)
    assert tcc.LAUNCHES == before      # the CPU runs the plain version
    _holds_the_layout(name, fl, bd, dims, dims_b, recs)
    plain = tcc.pack_records_plain(name, fl, bd, TCFG)
    assert all(a is b is None or torch.equal(a, b)
               for a, b in zip(recs, plain))


def _block(r, box):
    """Rank r's block of a 2x2 mesh on the box."""
    mesh = tmesh.Mesh(None, r, 4, torch.device("cpu"), None, tmesh.AXES_2D,
                      (2, 2))
    return halo.make_slab(mesh, box.cx, box.cz)


def _window(x, slab, dims):
    """The block's window (with its ghost cells) of a whole-box grid."""
    cells = x.reshape(*x.shape[:2], dims.gx, dims.gy, dims.gz)
    return cells[:, :, slab.x0:slab.x1 + 2, :,
                 slab.z0:slab.z1 + 2].contiguous().reshape(*x.shape[:2], -1)


def _stale(x, ldims, rng):
    """x with every cell of its x and z ghost faces overwritten by other
    values of the same kind, as a window holds them before its exchange."""
    cells = x.clone().reshape(*x.shape[:2], ldims.gx, ldims.gy, ldims.gz)
    face = torch.zeros((ldims.gx, ldims.gy, ldims.gz), dtype=torch.bool)
    face[[0, -1]] = True
    face[:, :, [0, -1]] = True
    src = cells[..., face]
    cells[..., face] = src[..., torch.as_tensor(
        rng.permutation(src.shape[-1]))]
    return cells.reshape(x.shape), face.reshape(-1)


@pytest.mark.parametrize("name", NAMES)
def test_pack_of_a_2x2_window_with_stale_ghost_faces(dam, name):
    """On each block of a 2x2 mesh, the pack of the window as it stands
    before the exchange carries its stale ghost faces into their records
    (the pack must run after the exchange, as ``passes.column_pass`` runs
    the executor); once the faces are refreshed the window's records are
    the whole box's records of the window's cells, bitwise."""
    fl, bd, dims, dims_b = _operands(name, dam)
    whole = tcc.pack_records(name, fl, bd, dims, dims_b, TCFG)
    rng = np.random.default_rng(5)
    for r in range(4):
        slab = _block(r, dims)
        assert not slab.empty
        ldims = DenseDims(slab.x1 - slab.x0, dims.cy, slab.z1 - slab.z0, K)
        ldims_b = None if bd is None else ldims._replace(k=KB)
        lfl = _window(fl, slab, dims)
        lbd = None if bd is None else _window(bd, slab, dims_b)
        stale, face = _stale(lfl, ldims, rng)
        assert not torch.equal(stale, lfl)
        recs = tcc.pack_records(name, stale, lbd, ldims, ldims_b, TCFG)
        _holds_the_layout(name, stale, lbd, ldims, ldims_b, recs)
        moved = (recs.geo.reshape(ldims.g, K, 4)
                 != lfl[:4].permute(2, 1, 0)).any(-1).any(-1)
        assert bool(moved.any()) and not bool(moved[~face].any())
        fresh = tcc.pack_records(name, lfl, lbd, ldims, ldims_b, TCFG)
        for got, want, k in zip(fresh, whole, (K, K, KB)):
            if want is None:
                assert got is None
                continue
            cells = want.reshape(dims.gx, dims.gy, dims.gz, k, -1)
            cut = cells[slab.x0:slab.x1 + 2, :, slab.z0:slab.z1 + 2]
            assert torch.equal(got.reshape(cut.shape), cut)


@pytest.mark.parametrize("name", NAMES)
def test_plain_pass_matches_jax_on_the_dam(dam, name):
    """The plain executor, which the record kernel is held to on the card,
    against the JAX package's pass on the same operand (its sliding-box
    executor, ``xla``), at the Pallas bar (tests/test_pallas_engine.py:
    125-126)."""
    fl, bd, dims, dims_b = dam
    jfl = jnp.asarray(_rows(name, fl))
    jdims = jdense.DenseDims(*BOX, K)
    if name == "surface_pressure":
        want = jpp.surface_pressure_pass(jfl, jnp.asarray(bd), None, jdims,
                                         jdense.DenseDims(*BOX, KB), JCFG,
                                         engine="xla")
    else:
        want = jpp.surface_pass(jfl, None, jdims, JCFG, engine="xla")
    got = tpp.column_pass_plain(name, *_operands(name, dam), TCFG).numpy()
    want = np.asarray(want).reshape(got.shape)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def test_record_wrappers_refuse_what_the_kernel_cannot_take():
    """Before anything launches: a pass without a record kernel, operands
    of the wrong shape or boundary, an unknown unroll, width or reduction,
    a slot list that is not 1-D int64, and the walk on CPU tensors (the
    CPU runs the plain executor, never the walk)."""
    d = DenseDims(3, 3, 3, 2)
    fl = torch.zeros((9, d.k, d.g))
    fl[:3] = POS_PAD
    bd = fl[:4].clone()
    islots = torch.full((4,), d.k * d.g, dtype=torch.int64)
    before = dict(tcc.LAUNCHES)
    with pytest.raises(ValueError, match="no record kernel"):
        tcc.pack_records("divergence", fl[:7], bd, d, d, TCFG)
    with pytest.raises(ValueError, match="no record kernel"):
        tcc.record_pass_cuda("divergence", fl[:7], bd, islots, d, d, TCFG)
    with pytest.raises(ValueError, match="takes fl of shape"):
        tcc.pack_records("surface", fl, None, d, None, TCFG)
    with pytest.raises(ValueError, match="and a boundary operand"):
        tcc.pack_records("surface_pressure", fl, None, d, None, TCFG)
    with pytest.raises(ValueError, match="alone"):
        tcc.pack_records("surface", fl[:7], bd, d, d, TCFG)
    with pytest.raises(ValueError, match="unroll 3 is not one of"):
        tcc.record_pass_cuda("surface", fl[:7], None, islots, d, None, TCFG,
                             unroll=3)
    with pytest.raises(ValueError, match="lanes 4 is not one of"):
        tcc.record_pass_cuda("surface", fl[:7], None, islots, d, None, TCFG,
                             lanes=4)
    with pytest.raises(ValueError, match="reduction 'tree' is not one of"):
        tcc.record_pass_cuda("surface", fl[:7], None, islots, d, None, TCFG,
                             reduction="tree")
    with pytest.raises(ValueError, match="1-D int64"):
        tcc.record_pass_cuda("surface", fl[:7], None, islots.int(), d, None,
                             TCFG)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tcc.record_pass_cuda("surface_pressure", fl, bd, islots, d, d, TCFG)
    assert tcc.LAUNCHES == before
    assert set(tcc.RECORD_IDS) == {"surface", "surface_pressure"}
    assert set(tcc.RECORD_IDS) <= set(tpp.PARTICLE_PASSES)
    assert all(tcc.RECORD_IDS[n] == tcc.PASS_IDS[n] for n in tcc.RECORD_IDS)
    assert set(tcc.UNROLLS) == {1, 2}
    assert all(tcc.RECORD_DEFAULTS[n][2] in tcc.UNROLLS
               and tcc.RECORD_DEFAULTS[n][:2] in tcc.variants(n)
               for n in tcc.RECORD_IDS)


@pytest.mark.parametrize("case", ["other_pass", "other_k", "no_bgeo",
                                  "stray_bgeo", "float64"])
def test_record_pass_refuses_records_that_do_not_fit(case):
    """Records handed to the walk are checked against the pass's grids
    before anything else of the operands: the walk indexes them by K, Kb
    and G, so a pack of another pass, another K or without the boundary's
    would send it out of bounds on a card."""
    d, d3 = DenseDims(3, 3, 3, 2), DenseDims(3, 3, 3, 3)
    fl = torch.zeros((9, d.k, d.g))
    fl[:3] = POS_PAD
    bd = fl[:4].clone()
    islots = torch.full((4,), d.k * d.g, dtype=torch.int64)
    name, args = "surface_pressure", (fl, bd, islots, d, d)
    if case == "other_pass":
        recs = tcc.pack_records("surface", fl[:7], None, d, None, TCFG)
        n = d.g * d.k
        match = rf"records.side has shape \({n},\), expected \({n}, 2\)"
    elif case == "other_k":
        fl3 = torch.full((9, d3.k, d3.g), POS_PAD)
        recs = tcc.pack_records(name, fl3, fl3[:4].clone(), d3, d3, TCFG)
        match = (rf"records.geo has shape \({d3.g * d3.k}, 4\), expected "
                 rf"\({d.g * d.k}, 4\)")
    elif case == "no_bgeo":
        recs = tcc.pack_records(name, fl, bd, d, d, TCFG)._replace(bgeo=None)
        match = "records.bgeo is None"
    elif case == "stray_bgeo":
        name, args = "surface", (fl[:7], None, islots, d, None)
        recs = tcc.pack_records(name, fl[:7], None, d, None, TCFG)._replace(
            bgeo=torch.zeros((d.g * d.k, 4)))
        match = "records.bgeo is given; surface takes None"
    else:
        recs = tcc.pack_records(name, fl, bd, d, d, TCFG)
        recs = recs._replace(geo=recs.geo.double())
        match = "records.geo is not contiguous float32"
    before = dict(tcc.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        tcc.record_pass_cuda(name, *args, TCFG, records=recs)
    # records that fit pass this check; the walk then refuses CPU tensors
    good = tcc.pack_records(name, *args[:2], d, args[4], TCFG)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tcc.record_pass_cuda(name, *args, TCFG, records=good)
    assert tcc.LAUNCHES == before
