"""The slot lists that the particle-list kernel walks, and the dispatch of
the fourteen passes that take them, on the CPU.

On a card, pbd_lambda, stiffness_accel, divergence, surface_pressure,
density_colorgrad_visc, xsph_colorgrad, density_alpha_colorgrad,
density_visc, pressure_force, density_alpha, the fluid-only viscosity,
surface and xsph, and the scene build's density run through
``column_pass_cuda.particle_pass_cuda``: one group of lanes per particle
of a slot list (the step's ``BoxIndex.slots``; for the scene's density
the boundary's ``DenseIndex.slots``), writing only those slots of an
output zeroed beforehand. That is right only if the list names every real
slot of the grid the pass reads, each once, inside the ghost ring, and
marks every other particle with the trash value K*G. These tests hold
that contract on the dam, on a perturbed splash (with K and box overflow)
and on a jittered block, and on the dam's boundary and a custom one, with
each list equal to the JAX package's; then that the steps, surface
effects on and off, and the scene build hand the list to exactly those
fourteen passes, that it still names every real slot of the projected
grid PBD's XSPH and surface passes run on, that each pass's (width,
reduction) pairs follow from its sum count, and that the wrapper and the
passes refuse what the kernel cannot take. The kernel itself runs only on
the card (tests/test_torch_cuda.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu.models import dense_step as jds
from cpp_fluid_particles_tpu.ops import box as jbox
from cpp_fluid_particles_tpu.ops import dense as jdense

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch.models import dense_step as tds
from cpp_fluid_particles_tpu_torch.ops import column_pass_cuda as tcc
from cpp_fluid_particles_tpu_torch.ops import dense as tdense
from cpp_fluid_particles_tpu_torch.ops import passes as tpp
from cpp_fluid_particles_tpu_torch.state import make_fluid_state

from test_torch_ops import _dam, _splash

torch.set_num_threads(2)

TCFG = T.dam_break_config(mode="parity")
JCFG = J.dam_break_config(mode="parity")
SMALL = T.dam_break_config(mode="parity", space_size=(0.52, 0.52, 0.52))
JSMALL = J.dam_break_config(mode="parity", space_size=(0.52, 0.52, 0.52))


def _block():
    """A jittered block resting on the floor of the small domain."""
    rng = np.random.default_rng(3)
    pos = T.block_positions((0.16, 0.006, 0.16), (6, 6, 6), SMALL.spacing)
    return pos + rng.uniform(-0.003, 0.003, pos.shape).astype(np.float32)


# (positions, K, box, small domain): fitted, K overflow, box overflow
CASES = {
    "dam": (_dam, 12, (20, 28, 12), False),
    "splash_fit": (_splash, 40, (24, 24, 24), False),
    "splash_k": (_splash, 8, (24, 24, 24), False),
    "splash_box": (_splash, 40, (8, 12, 8), False),
    "block": (_block, 14, (8, 8, 8), True),
}


def _layout(case):
    make, k, box, small = CASES[case]
    cfg, jcfg = (SMALL, JSMALL) if small else (TCFG, JCFG)
    pos = make()
    dims, dims_b = tdense.dims_for(cfg, k), tdense.dims_for(cfg, 7)
    scene = tds.DenseScene(bd=torch.zeros((4, dims_b.k, dims_b.g)))
    lo = tds._layout(torch.as_tensor(pos), cfg, dims, dims_b, scene, box)
    state = make_fluid_state(pos, cfg, "cpu")
    pos_d, _, _ = tds._fill(lo, state, cfg, [], [])
    jslots = jbox.build_box_index(jnp.asarray(pos), jcfg,
                                  jdense.dims_for(jcfg, k),
                                  jdense.DenseDims(*box, k)).slots
    return lo, pos_d, np.asarray(jslots)


@pytest.mark.parametrize("case", list(CASES))
def test_slot_list_names_every_real_slot_once(case):
    lo, pos_d, jslots = _layout(case)
    d = lo.dims
    slots = lo.idx.slots
    assert slots.dtype == torch.int64 and slots.dim() == 1
    assert slots.is_contiguous()
    np.testing.assert_array_equal(slots.numpy(), jslots)
    kg = d.k * d.g
    valid = slots < kg
    assert torch.equal(valid, lo.idx.valid)
    assert bool((slots[~valid] == kg).all())
    listed = slots[valid]
    assert bool((listed >= 0).all())
    assert listed.unique().numel() == listed.numel()
    cell = listed % d.g
    x, y, z = cell // (d.gy * d.gz), (cell // d.gz) % d.gy, cell % d.gz
    assert bool(((x > 0) & (x < d.gx - 1) & (y > 0) & (y < d.gy - 1)
                 & (z > 0) & (z < d.gz - 1)).all())
    real = torch.nonzero((pos_d[0] < tds.POS_GUARD).reshape(-1))[:, 0]
    assert torch.equal(torch.sort(listed).values, real)
    if case in ("splash_k", "splash_box"):
        assert bool((~valid).any())


@functools.cache
def _recorded_calls(solver, mode="parity", surface=True):
    """-> ([(pass name, fl, islots or None)] of one step of ``solver`` in
    ``mode``, with surface effects on or off, on the small domain's block
    after two frames, the step's slot list)."""
    cfg = SMALL if mode == "parity" else T.dam_break_config(
        mode=mode, space_size=SMALL.space_size)
    if not surface:
        cfg = cfg.replace(surface_tension=0.0, air_pressure=0.0)
    seen = []

    def record(name, fl, bd, dims, dims_b, cfg, islots=None):
        seen.append((name, fl, islots))
        return tpp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)

    sim = T.Simulation(solver=solver, cfg=cfg, fluid_pos=_block(),
                       device="cpu")
    sim.run(2)
    dims, dims_b = sim._dims()
    tds.DENSE_STEPS[solver](sim.state, sim.carry, sim.scene, cfg, cfg.dt,
                            dims, dims_b, sim.box, executor=record)
    want = tds.bx.build_box_index(
        sim.state.pos, cfg, dims,
        tdense.DenseDims(*sim.box, dims.k)).slots
    return seen, want


# the passes of each step that take the slot list, surface effects on:
# PBD's projection passes, its XSPH traversal and surface, DFSPH's
# density_alpha_colorgrad, two Jacobi passes, viscosity and surface, both
# WCSPH traversals; "_off" with surface effects off: PBD's projection
# passes and xsph, DFSPH's density_alpha, Jacobi passes and viscosity, both
# WCSPH traversals
LISTED = {"pbd": {"pbd_lambda", "stiffness_accel", "xsph_colorgrad",
                  "surface"},
          "dfsph": {"density_alpha_colorgrad", "stiffness_accel",
                    "divergence", "viscosity", "surface"},
          "wcsph": {"density_colorgrad_visc", "surface_pressure"},
          "pbd_off": {"pbd_lambda", "stiffness_accel", "xsph"},
          "dfsph_off": {"density_alpha", "stiffness_accel", "divergence",
                        "viscosity"},
          "wcsph_off": {"density_visc", "pressure_force"}}
# the passes of each step that still walk the whole grid: none
UNLISTED = {"pbd": set(), "dfsph": set(), "wcsph": set(),
            "pbd_off": set(), "dfsph_off": set(), "wcsph_off": set()}
# the pass the scene build hands the boundary index's slot list
SCENE_LISTED = {"density"}


@pytest.mark.parametrize("solver", list(LISTED))
def test_steps_hand_the_slot_list_to_the_particle_passes(solver):
    name_of_solver, off, _ = solver.partition("_off")
    seen, want = _recorded_calls(name_of_solver, "parity", surface=not off)
    with_list = {name for name, _, islots in seen if islots is not None}
    assert with_list == LISTED[solver]
    assert set.union(*LISTED.values(), SCENE_LISTED) \
        == set(tpp.PARTICLE_PASSES)
    for name, _, islots in seen:
        if name in tpp.PARTICLE_PASSES:
            assert islots is not None and torch.equal(islots, want), name
    assert ({name for name, _, _ in seen} - set(tpp.PARTICLE_PASSES)
            == UNLISTED[solver])


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_pbd_slot_list_names_every_real_slot_of_the_projected_grid(mode):
    """PBD's XSPH traversal and its surface pass run on the projected
    positions over the slot list the fill made: the projection's
    position-only clamp keeps every listed slot real and every padding slot
    POS_PAD, so the list still names every real slot of that grid once.
    Fast mode adds the warm-start predictor and the Chebyshev
    extrapolation."""
    seen, want = _recorded_calls("pbd", mode)
    first = next(f for name, f, _ in seen if name == "pbd_lambda")
    for pass_name in ("xsph_colorgrad", "surface"):
        (fl, islots), = [(fl, islots) for name, fl, islots in seen
                         if name == pass_name]
        assert torch.equal(islots, want), pass_name
        kg = fl.shape[1] * fl.shape[2]
        listed = islots[islots < kg]
        assert listed.unique().numel() == listed.numel() > 0
        real = torch.nonzero((fl[0] < tds.POS_GUARD).reshape(-1))[:, 0]
        assert torch.equal(torch.sort(listed).values, real), pass_name
        # the projection moved the positions the list was made for
        assert not torch.equal(first[:3], fl[:3]), pass_name
    # surface runs on xsph_colorgrad's positions
    xsph_fl, surf_fl = (next(f for name, f, _ in seen if name == n)
                        for n in ("xsph_colorgrad", "surface"))
    assert torch.equal(xsph_fl[:4], surf_fl[:4])


def _custom_boundary():
    """The small domain's walls, a 4x4x4 obstacle of boundary particles
    inside it and three particles whose cells fall outside the grid."""
    walls = T.boundary_positions(SMALL)
    obstacle = T.block_positions((0.2, 0.1, 0.24), (4, 4, 4), SMALL.spacing)
    outside = np.array([[-0.05, 0.2, 0.2], [0.2, 0.6, 0.2],
                        [0.2, 0.2, 1.0]], np.float32)
    return np.concatenate([walls, obstacle, outside]).astype(np.float32)


# boundary scenes: (port config, JAX config, boundary positions)
BOUNDARIES = {
    "dam": lambda: (TCFG, JCFG, T.boundary_positions(TCFG)),
    "custom": lambda: (SMALL, JSMALL, _custom_boundary()),
}


@pytest.mark.parametrize("which", list(BOUNDARIES))
def test_scene_build_hands_density_the_boundary_slot_list(which):
    """The scene build runs density on the boundary grid with the boundary
    index's slot list: it names every real slot of that grid once, in an
    interior cell, marks the particles outside the grid with the trash
    value Kb*G, and equals the JAX package's index slots; the boundary
    operand is the grid's zero-mass clone."""
    cfg, jcfg, bpos = BOUNDARIES[which]()
    kb = tds.boundary_k(bpos, cfg)
    seen = []

    def record(name, fl, bd, dims, dims_b, cfg, islots=None):
        seen.append((name, fl, bd, dims, dims_b, islots))
        return tpp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)

    scene = tds.build_dense_scene(cfg, bpos, kb, "cpu", executor=record)
    (name, fl, bd, d, d_b, islots), = seen
    assert name in SCENE_LISTED and d == d_b == tdense.dims_for(cfg, kb)
    jslots = jdense.build_dense_index(jnp.asarray(bpos), jcfg,
                                      jdense.dims_for(jcfg, kb)).slots
    np.testing.assert_array_equal(islots.numpy(), np.asarray(jslots))
    assert islots.dtype == torch.int64 and islots.is_contiguous()
    kg = d.k * d.g
    assert d.total == kg
    valid = islots < kg
    assert bool((islots[~valid] == kg).all())
    assert int((~valid).sum()) == (3 if which == "custom" else 0)
    listed = islots[valid]
    assert bool((listed >= 0).all())
    assert listed.unique().numel() == listed.numel()
    cell = listed % d.g
    x, y, z = cell // (d.gy * d.gz), (cell // d.gz) % d.gy, cell % d.gz
    assert bool(((x > 0) & (x < d.gx - 1) & (y > 0) & (y < d.gy - 1)
                 & (z > 0) & (z < d.gz - 1)).all())
    real = torch.nonzero((fl[0] < tds.POS_GUARD).reshape(-1))[:, 0]
    assert torch.equal(torch.sort(listed).values, real)
    assert torch.equal(bd[:3], fl[:3]) and not bool(bd[3].any())
    # the masses land on exactly the listed slots of the scene's grid
    flat = scene.bd.reshape(4, -1)
    assert torch.equal(torch.nonzero(flat[3])[:, 0],
                       torch.sort(listed).values)


def test_custom_scene_boundary_mass_matches_jax():
    """The custom boundary's Akinci masses against the JAX package's scene
    build, within rtol 2e-5 of the row max; positions bitwise."""
    bpos = _custom_boundary()
    kb = tds.boundary_k(bpos, SMALL)
    got = tds.build_dense_scene(SMALL, bpos, kb, "cpu").bd.numpy()
    want = np.asarray(jds.build_dense_scene(JSMALL, bpos, kb,
                                            engine="xlab").bd)
    np.testing.assert_array_equal(got[:3], want[:3])
    np.testing.assert_allclose(got[3], want[3], rtol=2e-5,
                               atol=2e-5 * np.abs(want[3]).max())


def _operands():
    d = tdense.DenseDims(3, 3, 3, 2)
    fl = torch.zeros((9, d.k, d.g))   # the most rows a particle pass reads
    fl[:3] = tds.POS_PAD
    bd = torch.zeros((4, d.k, d.g))
    bd[:3] = tds.POS_PAD
    return fl, bd, d


def test_particle_wrapper_refuses_what_the_kernel_cannot_take():
    fl, bd, d = _operands()
    fl = fl[:tpp.PASSES["stiffness_accel"].fi]
    islots = torch.full((4,), d.k * d.g, dtype=torch.int64)
    before = dict(tcc.LAUNCHES)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tcc.particle_pass_cuda("stiffness_accel", fl, bd, islots, d, d, TCFG)
    with pytest.raises(ValueError, match="1-D int64"):
        tcc.particle_pass_cuda("stiffness_accel", fl, bd,
                               islots.to(torch.int32), d, d, TCFG)
    with pytest.raises(ValueError, match="1-D int64"):
        tcc.particle_pass_cuda("stiffness_accel", fl, bd, islots[None], d, d,
                               TCFG)
    with pytest.raises(ValueError, match="no particle-list kernel"):
        tcc.particle_pass_cuda(
            "color_gradient",
            _operands()[0][:tpp.PASSES["color_gradient"].fi], bd, islots, d,
            d, TCFG)
    with pytest.raises(ValueError, match="not one of"):
        tcc.particle_pass_cuda("stiffness_accel", fl, bd, islots, d, d, TCFG,
                               lanes=4)
    with pytest.raises(ValueError, match="reduction 'tree' is not one of"):
        tcc.particle_pass_cuda("stiffness_accel", fl, bd, islots, d, d, TCFG,
                               reduction="tree")
    assert tcc.LAUNCHES == before
    assert tcc.LANES[0] in (8, 16, 32) and set(tcc.LANES) == {8, 16, 32}
    assert tcc.REDUCTIONS == ("butterfly", "transpose")
    assert set(tcc.PASS_LANES) <= set(tpp.PARTICLE_PASSES)
    assert set(tcc.PASS_REDUCTION) <= set(tpp.PARTICLE_PASSES)
    assert {tcc.default_lanes(n) for n in tpp.PARTICLE_PASSES} <= set(tcc.LANES)
    assert ({tcc.default_reduction(n) for n in tpp.PARTICLE_PASSES}
            <= set(tcc.REDUCTIONS))


def test_variants_follow_the_sum_count():
    """The butterfly runs at every width; the transpose leaves each lane one
    of the sums padded to a power of two, so a pass with 9 sums (16 padded)
    takes it at W 16 and 32 only. The wrapper refuses any other pair on the
    CPU, before it looks at the operands' device, and launches nothing."""
    every = {(w, r) for w in tcc.LANES for r in tcc.REDUCTIONS}
    for name in tpp.PARTICLE_PASSES:
        got = tcc.variants(name)
        assert len(set(got)) == len(got)
        if tpp.PASSES[name].n_out <= 8:
            assert set(got) == every, name
        assert (tcc.default_lanes(name), tcc.default_reduction(name)) in got
    assert tpp.PASSES["density_alpha_colorgrad"].n_out == 9
    # pressure_force's and xsph's 3 sums pad to 4, density_alpha's 5 to 8
    # and density's 1 stays 1: each takes the transpose at every width, six
    # variants
    assert [tpp.PASSES[n].n_out for n in ("pressure_force", "density_alpha",
                                          "xsph", "density")] == [3, 5, 3, 1]
    for name in ("pressure_force", "density_alpha", "xsph", "density"):
        assert len(tcc.variants(name)) == 6 and set(tcc.variants(name)) \
            == every, name
    assert set(tcc.variants("density_alpha_colorgrad")) == every - {
        (8, "transpose")}
    fl, bd, d = _operands()
    fl = fl[:tpp.PASSES["density_alpha_colorgrad"].fi]
    islots = torch.full((4,), d.k * d.g, dtype=torch.int64)
    before = dict(tcc.LAUNCHES)
    with pytest.raises(ValueError, match="density_alpha_colorgrad has 9 "
                       "sums, too many for the transpose reduction at 8 "
                       "lanes"):
        tcc.particle_pass_cuda("density_alpha_colorgrad", fl, bd, islots, d,
                               d, TCFG, lanes=8, reduction="transpose")
    assert tcc.LAUNCHES == before
    # the butterfly at 8 lanes gets past the pair check to the device check
    with pytest.raises(ValueError, match="not a CUDA device"):
        tcc.particle_pass_cuda("density_alpha_colorgrad", fl, bd, islots, d,
                               d, TCFG, lanes=8, reduction="butterfly")


@pytest.mark.parametrize("name", tpp.PARTICLE_PASSES)
def test_particle_passes_require_the_slot_list(name):
    fl, bd, d = _operands()
    # the pass function, and which of the executor's rows it returns
    fn, rows_out = {
        "pbd_lambda": (tpp.pbd_lambda_pass, slice(None)),
        "stiffness_accel": (tpp.stiffness_accel_pass, slice(None)),
        "divergence": (tpp.divergence_pass, 0),
        "surface_pressure": (tpp.surface_pressure_pass, slice(None)),
        "density_colorgrad_visc": (tpp.density_colorgrad_visc_pass,
                                   slice(None)),
        "xsph_colorgrad": (tpp.xsph_colorgrad_pass, slice(None)),
        "viscosity": (tpp.viscosity_pass, slice(None)),
        "surface": (tpp.surface_pass, slice(None)),
        "density_alpha_colorgrad": (tpp.density_alpha_colorgrad_pass,
                                    slice(None)),
        "density_visc": (tpp.density_visc_pass, slice(None)),
        "pressure_force": (tpp.pressure_force_pass, slice(None)),
        "density_alpha": (tpp.density_alpha_pass, slice(None)),
        "xsph": (tpp.xsph_pass, slice(None)),
        "density": (tpp.density_pass, 0)}[name]
    rows = tpp.PASSES[name].fi
    # a fluid-only pass function takes no boundary operand
    args = ((fl[:rows], bd, d, d) if tpp.PASSES[name].has_bd
            else (fl[:rows], d))
    with pytest.raises(TypeError, match="islots"):
        fn(*args, TCFG)
    islots = torch.full((4,), d.k * d.g, dtype=torch.int64)
    out = fn(*args, TCFG, islots=islots)
    bd_plain, d_b = (bd, d) if tpp.PASSES[name].has_bd else (None, None)
    assert torch.equal(out, tpp.column_pass_plain(name, fl[:rows], bd_plain,
                                                  d, d_b, TCFG)[rows_out])
