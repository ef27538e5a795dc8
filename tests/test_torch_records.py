"""The cell-packed records of the record passes, on the CPU.

On a card the record kernel (``column_pass_cuda.record_pass_cuda``)
walks records that its pack writes from the pass's operand: slot s of cell
c at record c*K + s, as ``{x, y, z, m}`` and the slot's j side (|cg|^2;
|cg|^2 and p / max(eps, rho^2) for surface_pressure; vel3 and m / rho0
for xsph_colorgrad; vel3 and 0 for viscosity), the boundary window's
``{x, y, z, m}`` at c*Kb + s.
The pack writes only the records a walk reads: the real slots, and each
cell's first padding slot as ``{POS_PAD, 0, 0, 0}``; for pbd_lambda,
stiffness_accel and the surface-off pressure_force and density_alpha
(``COUNTED``), whose walk is counted, one position pack of the real slots
alone and each cell's count of real slots, with no j side.
The pack kernel is held bitwise to
``pack_records_plain`` on those records on the card
(tests/test_torch_cuda.py); here that plain version is held to the layout,
to the records it leaves unwritten and to the plain pass bodies'
arithmetic, on the dam's operand and on a 2x2 block's window whose ghost
faces are stale until an exchange refreshes them; and the plain passes,
which the kernel is held to, to the JAX package's, at the dam's rho0 and
at a rho0 that is not a power of two. The surface-off steps hand their
counted passes one position pack a frame: DFSPH's density_alpha the pack
every stiffness_accel of the frame walks, WCSPH's pressure_force its own.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu.ops import box as jbox
from cpp_fluid_particles_tpu.ops import dense as jdense
from cpp_fluid_particles_tpu.ops import pallas_passes as jpp

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch.models import dense_step as tds
from cpp_fluid_particles_tpu_torch.ops import box as tbox
from cpp_fluid_particles_tpu_torch.ops import column_pass_cuda as tcc
from cpp_fluid_particles_tpu_torch.ops import dense as tdense
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
# the passes whose plain executor is held to the JAX package's here: the
# record passes, and PBD's projection passes whatever kernel runs them
PLAIN_NAMES = tuple(dict.fromkeys(NAMES + ("pbd_lambda", "stiffness_accel")))
# a rest density that is not a power of two, so that m / rho0 and the
# viscosity's lap / rho0 round
RHO0 = 1.3
# the record passes whose terms do not read rho0
RHO0_FREE = ("stiffness_accel", "pressure_force", "density_alpha")
# what the plain pack holds in a record no walk reads, as int32 bits
UNWRITTEN_BITS = torch.tensor(tcc.UNWRITTEN).view(torch.int32)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def dam():
    """The dam's box operands, filled by the JAX package: every pass row
    [pos3, mass, rho, p, cg3, vel3] (rho, p, cg and vel random, seeded; p
    negative for some slots, as the EOS gives below rho0) and the boundary
    window [pos3, mass] (masses random) -> (fl (12, K, G), bd (4, Kb, G),
    dims, dims_b) as numpy arrays and port DenseDims."""
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
    vel = rng.normal(0.0, 0.5, (3, n)).astype(np.float32)
    fl = jnp.concatenate([fl, jbox.fill_box(idx, list(vel), [0.0] * 3, bdims,
                                            mode="scatter")])
    bd = jdense.fill_dense(bidx, [bpos[:, 0], bpos[:, 1], bpos[:, 2], bmass],
                           [jdense.POS_PAD] * 3 + [0.0], dims_b)
    bd = jbox.slice_boundary_box(bd, dims, bdims, KB, idx.origin)
    assert int(jnp.sum(bd[0] < POS_PAD / 2)) > 0
    return (np.asarray(fl), np.asarray(bd), DenseDims(*BOX, K),
            DenseDims(*BOX, KB))


def _rows(name, fl):
    """The pass's operand rows of the stacked [pos3, mass, rho, p, cg3,
    vel3]."""
    return {"surface_pressure": fl[:9],
            "surface": np.concatenate([fl[:4], fl[6:9]]),
            "xsph_colorgrad": np.concatenate([fl[:4], fl[9:12]]),
            "viscosity": np.concatenate([fl[:4], fl[9:12]]),
            "pbd_lambda": fl[:4], "density_alpha": fl[:4],
            "pressure_force": fl[:6],
            # p (negative for some slots) as stiffness_accel's s
            "stiffness_accel": np.concatenate([fl[:4], fl[5:6]])}[name]


def _operands(name, dam):
    fl, bd, dims, dims_b = dam
    has_bd = tpp.PASSES[name].has_bd
    return (_t(_rows(name, fl)), _t(bd) if has_bd else None, dims,
            dims_b if has_bd else None)


def _side_of_bodies(name, f, cfg):
    """The j side as the plain pass bodies write it (ops/passes.py
    _surface_terms: ``j[4] * j[4] + j[5] * j[5] + j[6] * j[6]``;
    _surface_pressure_terms: ``j[6] * j[6] + j[7] * j[7] + j[8] * j[8]``
    and ``over``: ``f[5] / torch.clamp(f[4] * f[4], min=eps)``;
    _colorgrad_terms: ``_jb(j[3]) / rho_ref``; _xsph_dv and
    _viscosity_terms: ``j[4 + c]``); none in the position pack of
    COUNTED."""
    if name in tcc.COUNTED:
        return []
    if name == "surface":
        return [f[4] * f[4] + f[5] * f[5] + f[6] * f[6]]
    if name == "xsph_colorgrad":
        return [f[4], f[5], f[6], f[3] / cfg.rho0]
    if name == "viscosity":
        return [f[4], f[5], f[6], torch.zeros_like(f[4])]
    return [f[6] * f[6] + f[7] * f[7] + f[8] * f[8],
            f[5] / torch.clamp(f[4] * f[4], min=cfg.epsilon)]


def _bits(x):
    return x.contiguous().view(torch.int32)


def _occupancy(x0):
    """(K, G) row 0 -> (real, first padding) slots: a slot holds a particle
    iff its x < POS_PAD / 2, and ranks fill a cell from slot 0, so a cell's
    first padding slot is the slot at its occupancy, where there is one."""
    real = x0 < POS_PAD / 2
    occ = real.sum(0)
    assert torch.equal(real, torch.arange(x0.shape[0])[:, None] < occ)
    first = torch.arange(x0.shape[0])[:, None] == occ
    return real, first


def _grid_records(x, geo, k, g, counted=False):
    """The geo records of grid x (rows, K, G): a real slot's record c*K + s
    is [x, y, z, m] of slot s of cell c; the first padding slot's [its x,
    POS_PAD, 0, 0, 0], but in the counted pack, which has none; every
    other record UNWRITTEN in all four words; so exactly the records a walk
    reads hold values."""
    assert geo.shape == (g * k, 4) and geo.is_contiguous()
    real, first = _occupancy(x[0])
    cells = geo.reshape(g, k, 4).permute(2, 1, 0)      # (4, K, G)
    for r in range(4):
        assert torch.equal(cells[r][real], x[r][real])
    assert bool(first.any())
    probed = torch.zeros_like(first) if counted else first
    if not counted:
        assert bool((cells[0][first] == POS_PAD).all())
        assert not bool(cells[1:, first].any())
    rest = ~(real | probed)
    assert bool(rest.any())
    assert bool((_bits(cells[:, rest]) == UNWRITTEN_BITS).all())
    wreal, wfirst = tcc.walked(x[0])
    assert torch.equal(wreal, real.T.reshape(-1))
    assert torch.equal(wfirst, first.T.reshape(-1))
    return real


def _holds_the_layout(name, fl, bd, dims, dims_b, recs, cfg=TCFG):
    """Record c*K + s of ``recs`` holds slot s of cell c of fl where a walk
    reads it (``_grid_records``), and at a real slot the bodies' j side in
    ``cfg``, ghost cells included (bitwise); the j side of every other slot
    UNWRITTEN; the boundary's at c*Kb + s likewise."""
    k, g = dims.k, dims.g
    counted = name in tcc.COUNTED
    real = _grid_records(fl, recs.geo, k, g, counted)
    side = _side_of_bodies(name, fl, cfg)
    width = tcc.SIDE_WIDTH[name]
    assert len(side) == width
    if counted:
        # each cell's count: its real slots, int32, in cell order
        assert recs.side is None
        assert recs.count.dtype == torch.int32 and recs.count.is_contiguous()
        assert torch.equal(recs.count, real.sum(0, dtype=torch.int32))
    else:
        assert recs.count is None and recs.bcount is None
        want = (g * k,) if width == 1 else (g * k, width)
        assert tuple(recs.side.shape) == want and recs.side.is_contiguous()
        got = recs.side.reshape(g, k, width).permute(2, 1, 0)
    for j in range(width):
        assert torch.equal(got[j][real], side[j][real])
        assert bool((_bits(got[j][~real]) == UNWRITTEN_BITS).all())
    # one record spelled out: the last slot of the fullest interior cell
    c = int(torch.argmax((fl[0] < POS_PAD / 2).sum(0)))
    s = int((fl[0, :, c] < POS_PAD / 2).sum()) - 1
    assert s >= 1
    assert torch.equal(recs.geo[c * k + s], fl[:4, s, c])
    if bd is None:
        assert recs.bgeo is None
    else:
        breal = _grid_records(bd, recs.bgeo, dims_b.k, g, counted)
        if counted:
            assert recs.bcount.dtype == torch.int32
            assert torch.equal(recs.bcount, breal.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("name", NAMES)
def test_pack_puts_each_slot_at_its_record_on_the_dam(dam, name):
    fl, bd, dims, dims_b = _operands(name, dam)
    before = dict(tcc.LAUNCHES)
    recs = tcc.pack_records(name, fl, bd, dims, dims_b, TCFG)
    assert tcc.LAUNCHES == before      # the CPU runs the plain version
    _holds_the_layout(name, fl, bd, dims, dims_b, recs)
    plain = tcc.pack_records_plain(name, fl, bd, TCFG)
    assert all(a is b is None or torch.equal(_bits(a), _bits(b))
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
        fresh = tcc.pack_records(name, lfl, lbd, ldims, ldims_b, TCFG)
        moved = (_bits(recs.geo) != _bits(fresh.geo)).reshape(
            ldims.g, -1).any(-1)
        assert bool(moved.any()) and not bool(moved[~face].any())
        # the counts as one slot per cell
        for got, want, k in zip(fresh, whole, (K, K, KB, 1, 1)):
            if want is None:
                assert got is None
                continue
            cells = want.reshape(dims.gx, dims.gy, dims.gz, k, -1)
            cut = cells[slab.x0:slab.x1 + 2, :, slab.z0:slab.z1 + 2]
            assert torch.equal(_bits(got.reshape(cut.shape)), _bits(cut))


def _plain_matches_jax(dam, name, tcfg, jcfg):
    """The plain executor in ``tcfg`` against the JAX package's pass in
    ``jcfg`` on the same operand (its sliding-box executor, ``xla``), at
    the Pallas bar (tests/test_pallas_engine.py:125-126)."""
    fl, bd, dims, dims_b = dam
    jfl = jnp.asarray(_rows(name, fl))
    jdims = jdense.DenseDims(*BOX, K)
    jpass = getattr(jpp, f"{name}_pass")
    if tpp.PASSES[name].has_bd:
        want = jpass(jfl, jnp.asarray(bd), None, jdims,
                     jdense.DenseDims(*BOX, KB), jcfg, engine="xla")
    else:
        want = jpass(jfl, None, jdims, jcfg, engine="xla")
    got = tpp.column_pass_plain(name, *_operands(name, dam), tcfg).numpy()
    want = np.asarray(want).reshape(got.shape)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)
    return got


@pytest.mark.parametrize("name", PLAIN_NAMES)
def test_plain_pass_matches_jax_on_the_dam(dam, name):
    """The plain executor, which the record kernel is held to on the card,
    against the JAX package's pass on the same operand."""
    _plain_matches_jax(dam, name, TCFG, JCFG)


@pytest.mark.parametrize("name", PLAIN_NAMES)
def test_plain_pass_and_pack_at_another_rho0(dam, name):
    """At rho0 1.3, which divides m and lap with rounding, the plain
    executor still matches the JAX package's pass, and differs from its
    output at the dam's rho0 of 1 wherever rho0 enters the pass (in
    stiffness_accel, pressure_force and density_alpha it does not: there
    the two are equal); a record pass's
    plain pack still holds the layout and the bodies' j side bitwise (its m
    / rho0, a
    division by a tensor, rounds as the bodies' division by the Python
    scalar on the CPU)."""
    tcfg, jcfg = TCFG.replace(rho0=RHO0), JCFG.replace(rho0=RHO0)
    got = _plain_matches_jax(dam, name, tcfg, jcfg)
    fl, bd, dims, dims_b = _operands(name, dam)
    base = tpp.column_pass_plain(name, fl, bd, dims, dims_b, TCFG).numpy()
    assert np.array_equal(got, base) == (name in RHO0_FREE)
    if name in tcc.RECORD_IDS:
        recs = tcc.pack_records(name, fl, bd, dims, dims_b, tcfg)
        _holds_the_layout(name, fl, bd, dims, dims_b, recs, tcfg)


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
    with pytest.raises(ValueError, match=r"unroll 4 is not one of \(1, 2\)"):
        tcc.record_pass_cuda("surface", fl[:7], None, islots, d, None, TCFG,
                             unroll=4)
    with pytest.raises(ValueError, match="unroll 3 is not one of"):
        tcc.record_pass_cuda("pbd_lambda", fl[:4], bd, islots, d, d, TCFG,
                             unroll=3)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tcc.record_pass_cuda("pbd_lambda", fl[:4], bd, islots, d, d, TCFG,
                             unroll=4)
    # the counted walk's 32-bit indices: K*G of 2^31 or more is refused
    big = DenseDims(1290, 1290, 1290, 1)
    assert big.k * big.g >= 2**31
    with pytest.raises(ValueError, match="indexes in 32 bits"):
        tcc.record_pass_cuda("stiffness_accel", fl[:5], bd, islots, big, big,
                             TCFG)
    # and so is an operand of 2^31 floats or more: pressure_force's six rows
    # at a K*G whose four rows of pbd_lambda stay under it
    wide = DenseDims(730, 730, 730, 1)
    assert 4 * wide.k * wide.g < 2**31 <= 6 * wide.k * wide.g
    with pytest.raises(ValueError, match="indexes in 32 bits"):
        tcc.record_pass_cuda("pressure_force", fl[:6], bd, islots, wide,
                             wide, TCFG)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tcc.record_pass_cuda("pbd_lambda", fl[:4], bd, islots, wide, wide,
                             TCFG)
    assert tcc.LAUNCHES == before
    assert set(tcc.RECORD_IDS) == {"surface", "surface_pressure",
                                   "xsph_colorgrad", "viscosity",
                                   "pbd_lambda", "stiffness_accel",
                                   "pressure_force", "density_alpha"}
    assert set(tcc.COUNTED) == {"pbd_lambda", "stiffness_accel",
                                "pressure_force", "density_alpha"}
    assert set(tcc.SIDE_WIDTH) == set(tcc.RECORD_IDS)
    assert all((tcc.SIDE_WIDTH[n] == 0) == (n in tcc.COUNTED)
               for n in tcc.RECORD_IDS)
    assert set(tcc.RECORD_IDS) <= set(tpp.PARTICLE_PASSES)
    assert all(tcc.RECORD_IDS[n] == tcc.PASS_IDS[n] for n in tcc.RECORD_IDS)
    assert set(tcc.UNROLLS) == {1, 2}
    assert set(tcc.COUNTED_UNROLLS) == {1, 2, 4}
    assert all(tcc.RECORD_DEFAULTS[n][2] in tcc.unrolls(n)
               and tcc.RECORD_DEFAULTS[n][:2] in tcc.variants(n)
               for n in tcc.RECORD_IDS)
    # one position pack serves every counted pass; the others pack alone
    assert {tcc.pack_key(n) for n in tcc.COUNTED} == {"pack_positions"}
    assert all(tcc.pack_key(n) == f"pack_{n}" and tcc.pack_key(n)
               in tcc.LAUNCHES for n in tcc.RECORD_IDS
               if n not in tcc.COUNTED)


@pytest.mark.parametrize("case", ["other_pass", "other_k", "no_bgeo",
                                  "stray_bgeo", "float64", "no_count",
                                  "count_int64", "count_shape",
                                  "count_device", "side_pack",
                                  "position_pack"])
def test_record_pass_refuses_records_that_do_not_fit(case):
    """Records handed to the walk are checked against the pass's grids
    before anything else of the operands: the walk indexes them by K, Kb
    and G, so a pack of another pass, another K or without the boundary's
    would send it out of bounds on a card; the counted walk's position
    pack needs its counts, (G,) int32 on the operand's device, and a pack
    with a j side is not one, nor is a position pack a side pass's."""
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
    elif case == "float64":
        recs = tcc.pack_records(name, fl, bd, d, d, TCFG)
        recs = recs._replace(geo=recs.geo.double())
        match = "records.geo is not contiguous float32"
    elif case == "position_pack":
        recs = tcc.pack_records("pbd_lambda", fl[:4], bd, d, d, TCFG)
        match = (rf"records.side is None; surface_pressure takes "
                 rf"\({d.g * d.k}, 2\)")
    else:
        name, args = "stiffness_accel", (fl[:5], bd, islots, d, d)
        recs = tcc.pack_records("pbd_lambda", fl[:4], bd, d, d, TCFG)
        if case == "no_count":
            recs = recs._replace(count=None)
            match = "records.count is None; stiffness_accel takes"
        elif case == "count_int64":
            recs = recs._replace(count=recs.count.long())
            match = "records.count is not contiguous int32"
        elif case == "count_shape":
            recs = recs._replace(bcount=torch.zeros((d.g + 1,),
                                                    dtype=torch.int32))
            match = (rf"records.bcount has shape \({d.g + 1},\), expected "
                     rf"\({d.g},\)")
        elif case == "count_device":
            recs = recs._replace(count=torch.empty((d.g,), dtype=torch.int32,
                                                   device="meta"))
            match = "records.count is on meta, fl on cpu"
        else:
            recs = tcc.pack_records("surface_pressure", fl, bd, d, d, TCFG)
            match = "records.side is given; stiffness_accel takes None"
    before = dict(tcc.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        tcc.record_pass_cuda(name, *args, TCFG, records=recs)
    # records that fit pass this check; the walk then refuses CPU tensors
    good = tcc.pack_records(name, *args[:2], d, args[4], TCFG)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tcc.record_pass_cuda(name, *args, TCFG, records=good)
    assert tcc.LAUNCHES == before


def _cases(source, fn):
    """The pass ids of the outer switch of extern "C" function ``fn`` in
    csrc/column_pass.cu: its ``case N: return run(...)`` or ``case N:
    return launch_pack<...>`` lines."""
    body = source[source.index(f'extern "C" int {fn}('):]
    body = body[:body.index('\nextern "C"')] if '\nextern "C"' in body \
        else body
    return sorted(int(m) for m in re.findall(
        r"case (\d+):\s*return (?:run\(|launch_pack<)", body))


def test_launch_switches_name_every_pass_id():
    """The C entry points dispatch exactly the ids the wrappers send: the
    particle-list kernel every PARTICLE_PASSES id, the pack and the record
    kernel every RECORD_IDS id (a card rejects any other id as
    cudaErrorInvalidValue, which only a launch there would show)."""
    source = tcc.SOURCE.read_text()
    assert _cases(source, "particle_pass_launch") == sorted(
        tcc.PASS_IDS[n] for n in tpp.PARTICLE_PASSES)
    for fn in ("pack_records_launch", "record_pass_launch"):
        assert _cases(source, fn) == sorted(tcc.RECORD_IDS.values()), fn


def _names_real_slots(lst, x0, trash):
    """Every entry of slot list ``lst`` is the trash slot or a slot of the
    grid whose row 0 (K, G) ``x0`` holds a particle -> the trash count."""
    flat = x0.reshape(-1)
    assert bool(((lst >= 0) & (lst <= trash)).all())
    assert trash == flat.shape[0]
    listed = lst[lst != trash]
    assert bool((flat[listed] < POS_PAD / 2).all())
    assert listed.unique().shape == listed.shape
    return int((lst == trash).sum())


@pytest.mark.parametrize("k", [K, 3])
def test_the_steps_slot_lists_name_only_real_slots(k):
    """The record kernel takes its i side from the record of each listed
    slot, and the pack writes no record past a cell's first padding slot:
    so every slot list a step hands it (``BoxIndex.slots`` and ``.work``
    on one device, ``slab_slots`` of both on each block of a 2x2 mesh)
    names only slots that hold a particle, or the trash slot K*G. At K 3
    the dam overflows its cells, and the dropped particles take the trash
    slot."""
    pos = torch.as_tensor(T.dam_break_positions(TCFG))
    box = DenseDims(*BOX, k)
    idx = tbox.build_box_index(pos, TCFG, tdense.dims_for(TCFG, k), box)
    assert int(idx.box_overflow) == 0
    assert (int(idx.overflow) > 0) == (k == 3)
    fields = [pos[:, 0], pos[:, 1], pos[:, 2]]
    x0 = tbox.fill_box(idx, fields, [POS_PAD] * 3, box)[0]
    for lst in (idx.slots, idx.work):
        assert _names_real_slots(lst, x0, k * box.g) == int(idx.overflow)
    assert torch.equal(idx.work.sort().values, idx.slots.sort().values)
    owned = 0
    for r in range(4):
        slab = _block(r, box)
        ldims = slab.dims(box)
        islots = halo.slab_slots(idx.slots, box, slab)
        lx0 = tbox.fill_box(idx._replace(slots=islots), fields,
                            [POS_PAD] * 3, ldims)[0]
        trash = _names_real_slots(islots, lx0, k * ldims.g)
        work = halo.slab_slots(idx.work, box, slab)
        assert _names_real_slots(work, lx0, k * ldims.g) == trash
        owned += islots.shape[0] - trash
    assert owned == int(idx.valid.sum())


def test_counted_pack_counts_full_and_empty_cells(dam):
    """The position pack's counts are each cell's real slots, 0 on an empty
    cell and K on a full one: the dam at K 3 fills cells to K (it drops
    the particles past K), and its boundary window at Kb 7; the records
    hold exactly the real slots."""
    _, bd, _, dims_b = dam
    k = 3
    pos = torch.as_tensor(T.dam_break_positions(TCFG))
    box = DenseDims(*BOX, k)
    idx = tbox.build_box_index(pos, TCFG, tdense.dims_for(TCFG, k), box)
    assert int(idx.overflow) > 0
    fields = [pos[:, 0], pos[:, 1], pos[:, 2],
              torch.full((pos.shape[0],), TCFG.m0)]
    fl = tbox.fill_box(idx, fields, [POS_PAD] * 3 + [0.0], box)
    bd = _t(bd)
    real = fl[0] < POS_PAD / 2
    for name in tcc.COUNTED:
        # the mass again as each further row (stiffness_accel's s,
        # pressure_force's rho and p)
        rows = tpp.PASSES[name].fi
        op = torch.cat([fl] + [fl[3:4]] * (rows - 4))
        recs = tcc.pack_records(name, op, bd, box, dims_b, TCFG)
        assert torch.equal(recs.count, real.sum(0, dtype=torch.int32))
        assert bool((recs.count == k).any()) and bool((recs.count == 0).any())
        assert bool((recs.bcount == 0).any())
        assert int(recs.bcount.max()) <= KB
        _holds_the_layout(name, op, bd, box, dims_b, recs)
        assert torch.equal(_bits(recs.geo), _bits(tcc.pack_records(
            "pbd_lambda", fl, bd, box, dims_b, TCFG).geo))
    assert torch.equal(tcc.counts_plain(fl[0]), real.sum(0, dtype=torch.int32))


@pytest.mark.parametrize("name", tcc.COUNTED)
def test_shared_pack_stays_empty_on_the_cpu(dam, name):
    """A SharedPack handed to a counted pass on the CPU is not packed: the
    plain executor runs, bitwise as without it, and launches nothing."""
    fl, bd, dims, dims_b = _operands(name, dam)
    pack = tpp.SharedPack()
    before = dict(tcc.LAUNCHES)
    got = tpp.column_pass(name, fl, bd, dims, dims_b, TCFG, records=pack)
    assert pack.records is None and tcc.LAUNCHES == before
    assert torch.equal(got, tpp.column_pass_plain(name, fl, bd, dims,
                                                  dims_b, TCFG))


def test_shared_pack_refuses_other_grids():
    """A SharedPack makes its pack once, hands the same pack to every later
    call on the grids it was made for, and refuses other grids."""
    pack = tpp.SharedPack()
    made = []

    def make():
        made.append(object())
        return made[-1]
    key = (DenseDims(*BOX, 4), DenseDims(*BOX, 2), torch.device("cpu"))
    first = pack.take(key, make)
    assert pack.take(key, make) is first and len(made) == 1
    with pytest.raises(ValueError, match="packed for"):
        pack.take((DenseDims(*BOX, 5),) + key[1:], make)
    assert pack.records is first and len(made) == 1


@pytest.mark.parametrize("solver", ["dfsph", "wcsph"])
def test_surface_off_steps_hand_their_counted_passes_one_pack_a_frame(
        monkeypatch, solver):
    """With surface effects off, each frame of DFSPH hands density_alpha a
    SharedPack and every stiffness_accel of both Jacobi solves that same
    pack, and each frame of WCSPH hands pressure_force one of its own; no
    other pass gets one, and the next frame a new one. On the CPU every
    pack stays empty (the plain executor runs)."""
    cfg = TCFG.replace(surface_tension=0.0, air_pressure=0.0)
    pos = T.block_positions((0.3, 0.1, 0.3), (6, 6, 6), cfg.spacing)
    sim = T.Simulation(solver=solver, cfg=cfg, fluid_pos=pos, device="cpu")
    calls = []
    run = tpp.column_pass

    def spy(name, *args, records=None, **kwargs):
        calls.append((name, records))
        return run(name, *args, records=records, **kwargs)
    monkeypatch.setattr(tpp, "column_pass", spy)
    dims, dims_b = sim._dims()
    counted = {"dfsph": ("density_alpha", "stiffness_accel"),
               "wcsph": ("pressure_force",)}[solver]
    state, carry, packs = sim.state, sim.carry, []
    for _ in range(2):
        del calls[:]
        state, carry, _ = tds.DENSE_STEPS[solver](
            state, carry, sim.scene, cfg, T.BENCH_DT[solver], dims, dims_b,
            sim.box)
        names = [n for n, _ in calls]
        assert counted[0] in names and names.count(counted[0]) == 1
        if solver == "dfsph":
            assert names.count("stiffness_accel") >= 2
        pack = dict(calls)[counted[0]]
        assert isinstance(pack, tpp.SharedPack) and pack.records is None
        assert all(r is (pack if n in counted else None) for n, r in calls)
        packs.append(pack)
    assert packs[0] is not packs[1]
