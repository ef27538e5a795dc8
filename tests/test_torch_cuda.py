"""The hand-written CUDA neighbor-pass kernel, its particle-list variant
for pbd_lambda, stiffness_accel, divergence, surface_pressure,
density_colorgrad_visc, xsph_colorgrad, density_alpha_colorgrad,
density_visc, pressure_force, density_alpha, the fluid-only viscosity,
surface and xsph, and the scene build's density (at each group width and
reduction the pass takes; the wrapper refuses the others), and its
brick-tiled fluid-only variant on the card. Every Simulation on the card
launches the particle-list density once, for its scene, and the column
kernel never.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
False. The file imports neither jax nor the JAX package, so it runs on a
machine without jax, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

(``--noconftest``: tests/conftest.py sets up jax for the other files.)
"""

import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch.exp import flat_pallas_proto as fp
from cpp_fluid_particles_tpu_torch.models import dense_step as ds
from cpp_fluid_particles_tpu_torch.ops import column_pass_cuda as cc
from cpp_fluid_particles_tpu_torch.ops import passes as pp
from cpp_fluid_particles_tpu_torch.ops.passes import flat_pallas_pass

pytestmark = pytest.mark.cuda

CFG = T.dam_break_config(mode="parity", space_size=(0.52, 0.52, 0.52))
BAR = 2e-5          # rtol, and atol x the output's max


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _block():
    """A jittered block resting on the floor, so boundary terms count."""
    rng = np.random.default_rng(3)
    pos = T.block_positions((0.16, 0.006, 0.16), (8, 8, 8), CFG.spacing)
    return pos + rng.uniform(-0.003, 0.003, pos.shape).astype(np.float32)


@pytest.fixture(scope="module")
def operands(dev):
    """The operands the main paths give each pass: the scene build's
    density pass with the boundary index's slot list, and one step of each
    solver with surface effects on and off, after 3 frames of the solver,
    each with the slot list the step hands it (None but for
    ``pp.PARTICLE_PASSES``). color_gradient and density_colorgrad, which
    no step runs, take PBD's [pos3, mass]."""
    calls = {}

    def record(name, fl, bd, dims, dims_b, cfg, islots=None):
        calls.setdefault(name, (name, fl, bd, dims, dims_b, islots))
        return pp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)

    off = CFG.replace(surface_tension=0.0, air_pressure=0.0)
    for solver in ("wcsph", "dfsph", "pbd"):
        sim = T.Simulation(solver=solver, cfg=CFG, fluid_pos=_block(),
                           device=dev)
        sim.run(3)
        dims, dims_b = sim._dims()
        for cfg in (CFG, off):
            ds.DENSE_STEPS[solver](sim.state, sim.carry, sim.scene, cfg,
                                   CFG.dt, dims, dims_b, sim.box,
                                   executor=record)
    ds.build_dense_scene(CFG, T.boundary_positions(CFG), sim._kb, dev,
                         executor=record)
    _, fl, bd, dims, dims_b, _ = calls["pbd_lambda"]
    for name in ("color_gradient", "density_colorgrad"):
        calls[name] = (name, fl, bd, dims, dims_b, None)
    assert sorted(calls) == sorted(cc.PASS_IDS)
    return calls


@pytest.mark.parametrize("name", list(cc.PASS_IDS))
def test_kernel_matches_plain_and_repeats_bitwise(operands, name):
    _, fl, bd, dims, dims_b, _ = operands[name]
    want = pp.column_pass_plain(name, fl, bd, dims, dims_b, CFG)
    n0 = cc.LAUNCHES[name]
    got = cc.column_pass_cuda(name, fl, bd, dims, dims_b, CFG)
    again = cc.column_pass_cuda(name, fl, bd, dims, dims_b, CFG)
    torch.cuda.synchronize()
    assert cc.LAUNCHES[name] == n0 + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=BAR, atol=BAR * scale)


def test_wrapper_checks_operands(operands):
    name, fl, bd, dims, dims_b, _ = operands["density_colorgrad_visc"]
    with pytest.raises(ValueError, match="float32"):
        cc.column_pass_cuda(name, fl.double(), bd, dims, dims_b, CFG)
    with pytest.raises(ValueError, match="contiguous"):
        cc.column_pass_cuda(name, fl.transpose(1, 2).contiguous()
                            .transpose(1, 2), bd, dims, dims_b, CFG)
    with pytest.raises(ValueError, match="shape"):
        cc.column_pass_cuda(name, fl[:4].contiguous(), bd, dims, dims_b,
                            CFG)
    # a fluid-only pass takes no boundary operand, the others need one
    with pytest.raises(ValueError, match="no boundary operand"):
        cc.column_pass_cuda("viscosity", fl, bd, dims, dims_b, CFG)
    with pytest.raises(ValueError, match="a boundary operand"):
        cc.column_pass_cuda("divergence", fl, None, dims, None, CFG)
    # the particle-list wrapper refuses the same, in both directions
    _, vfl, _, vdims, _, vslots = operands["viscosity"]
    with pytest.raises(ValueError, match="no boundary operand"):
        cc.particle_pass_cuda("viscosity", vfl, bd, vslots, vdims, dims_b,
                              CFG)
    _, dfl, _, ddims, _, dslots = operands["divergence"]
    with pytest.raises(ValueError, match="a boundary operand"):
        cc.particle_pass_cuda("divergence", dfl, None, dslots, ddims, None,
                              CFG)


def _refused(name, fl, bd, islots, dims, dims_b, lanes, reduction):
    """Whether (lanes, reduction) lies outside the pass's variants; if so,
    check that the wrapper refuses it and launches nothing."""
    if (lanes, reduction) in cc.variants(name):
        return False
    n0 = dict(cc.LAUNCHES)
    with pytest.raises(ValueError, match=f"{name} has "
                       f"{pp.PASSES[name].n_out} sums, too many for the "
                       f"{reduction} reduction at {lanes} lanes"):
        cc.particle_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG,
                              lanes=lanes, reduction=reduction)
    assert cc.LAUNCHES == n0
    return True


@pytest.mark.parametrize("reduction", cc.REDUCTIONS)
@pytest.mark.parametrize("lanes", cc.LANES)
@pytest.mark.parametrize("name", pp.PARTICLE_PASSES)
def test_particle_kernel_matches_plain_and_column_kernel(operands, name,
                                                         lanes, reduction):
    """The particle-list kernel on the slot list its step gives it: within
    BAR of the plain executor and of column_pass_kernel (its sums run in
    another order), two launches bitwise equal, each launch counted once.
    The transpose reduction adds the same pairs in the same order as the
    butterfly, so the two are bitwise equal at one width. A pair outside
    the pass's variants is refused before anything launches."""
    _, fl, bd, dims, dims_b, islots = operands[name]
    assert islots is not None
    if _refused(name, fl, bd, islots, dims, dims_b, lanes, reduction):
        return
    want = pp.column_pass_plain(name, fl, bd, dims, dims_b, CFG)
    old = cc.column_pass_cuda(name, fl, bd, dims, dims_b, CFG)
    n0 = cc.LAUNCHES[f"particle_{name}"]
    got = cc.particle_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG,
                                lanes=lanes, reduction=reduction)
    again = cc.particle_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG,
                                  lanes=lanes, reduction=reduction)
    torch.cuda.synchronize()
    assert cc.LAUNCHES[f"particle_{name}"] == n0 + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all()) and bool(got.any())
    for ref in (want, old):
        scale = float(ref.abs().max())
        torch.testing.assert_close(got, ref, rtol=BAR, atol=BAR * scale)
    butterfly = cc.particle_pass_cuda(name, fl, bd, islots, dims, dims_b,
                                      CFG, lanes=lanes,
                                      reduction="butterfly")
    assert torch.equal(got, butterfly)


@pytest.mark.parametrize("reduction", cc.REDUCTIONS)
@pytest.mark.parametrize("lanes", cc.LANES)
@pytest.mark.parametrize("name", pp.PARTICLE_PASSES)
def test_particle_kernel_writes_only_listed_slots(operands, name, lanes,
                                                  reduction):
    """Invalid particles (slot K*G) leave their slots 0 and the others as
    with the whole list; an empty list gives an all-zero output. A pair
    outside the pass's variants is refused."""
    _, fl, bd, dims, dims_b, islots = operands[name]
    if _refused(name, fl, bd, islots, dims, dims_b, lanes, reduction):
        return
    full = cc.particle_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG,
                                 lanes=lanes, reduction=reduction)
    kg = dims.k * dims.g
    drop = torch.arange(0, islots.shape[0], 3, device=islots.device)
    cut = islots.clone()
    cut[drop] = kg
    part = cc.particle_pass_cuda(name, fl, bd, cut, dims, dims_b, CFG,
                                 lanes=lanes, reduction=reduction
                                 ).reshape(full.shape[0], -1)
    full = full.reshape(full.shape[0], -1)
    gone = islots[drop]
    gone = gone[gone < kg]
    assert gone.numel() > 0
    assert not bool(part[:, gone].any())
    kept = cut[cut < kg]
    assert torch.equal(part[:, kept], full[:, kept])
    empty = cc.particle_pass_cuda(name, fl, bd, islots[:0], dims, dims_b,
                                  CFG, lanes=lanes, reduction=reduction)
    assert not bool(empty.any())


@pytest.mark.parametrize("reduction", cc.REDUCTIONS)
@pytest.mark.parametrize("lanes", cc.LANES)
def test_particle_stiffness_accel_is_exactly_zero_at_zero_lambda(operands,
                                                                 lanes,
                                                                 reduction):
    """PBD's exact all-lambda-zero exit needs stiffness_accel to store +-0
    where no pair contributes."""
    _, fl, bd, dims, dims_b, islots = operands["stiffness_accel"]
    zero = fl.clone()
    zero[4] = 0.0
    out = cc.particle_pass_cuda("stiffness_accel", zero, bd, islots, dims,
                                dims_b, CFG, lanes=lanes,
                                reduction=reduction)
    assert not bool(out.any())


@pytest.mark.parametrize("name", pp.PARTICLE_PASSES)
def test_particle_passes_on_the_card_need_the_slot_list(operands, name):
    """On a card these passes never fall back: no slot list raises, and
    the wrapper refuses a list, width or reduction its kernel does not
    take."""
    _, fl, bd, dims, dims_b, islots = operands[name]
    with pytest.raises(ValueError, match="needs islots"):
        pp.column_pass(name, fl, bd, dims, dims_b, CFG)
    with pytest.raises(ValueError, match="1-D int64"):
        cc.particle_pass_cuda(name, fl, bd, islots.int(), dims, dims_b, CFG)
    with pytest.raises(ValueError, match="not one of"):
        cc.particle_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG,
                              lanes=4)
    with pytest.raises(ValueError, match="not one of"):
        cc.particle_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG,
                              reduction="tree")


def _scene_built_once():
    """The Simulation's constructor built its scene once: the particle-list
    density launched once, the column kernel's density never (nor any
    other column-kernel instance)."""
    la = cc.LAUNCHES
    assert la["particle_density"] == 1 and la["density"] == 0, la
    assert not any(la[name] for name in cc.PASS_IDS), la


def test_scene_build_runs_through_the_kernel(dev):
    """The scene build on the card launches the particle-list density once
    and gives the CPU's boundary positions bitwise and its Akinci masses
    within BAR of the row max; a second build is bitwise equal."""
    bpos = T.boundary_positions(CFG)
    kb = ds.boundary_k(bpos, CFG)
    cc.reset_launch_counts()
    gpu = ds.build_dense_scene(CFG, bpos, kb, dev).bd
    torch.cuda.synchronize()
    _scene_built_once()
    again = ds.build_dense_scene(CFG, bpos, kb, dev).bd
    assert torch.equal(gpu, again)
    cpu = ds.build_dense_scene(CFG, bpos, kb, "cpu").bd
    assert torch.equal(gpu[:3].cpu(), cpu[:3])
    scale = float(cpu[3].abs().max())
    torch.testing.assert_close(gpu[3].cpu(), cpu[3], rtol=BAR,
                               atol=BAR * scale)


def test_simulation_runs_through_the_kernel(dev):
    """The same frames on the card and on the CPU agree at the one-step
    bars after 3 frames, and the card's frames all launched the kernel."""
    cc.reset_launch_counts()
    gpu = T.Simulation(solver="wcsph", cfg=CFG, fluid_pos=_block(),
                       device=dev)
    gpu.run(3)
    frames = 4 + gpu.retries                    # warm-up + 3 + retries
    _scene_built_once()
    assert {k: n for k, n in cc.LAUNCHES.items() if n} == {
        "particle_density": 1, "particle_density_colorgrad_visc": frames,
        "particle_surface_pressure": frames}
    cpu = T.Simulation(solver="wcsph", cfg=CFG, fluid_pos=_block(),
                       device="cpu")
    cpu.run(3)
    assert gpu.config_key == cpu.config_key
    np.testing.assert_allclose(gpu.state.pos.cpu().numpy(),
                               cpu.state.pos.numpy(), atol=2e-6)
    np.testing.assert_allclose(gpu.state.vel.cpu().numpy(),
                               cpu.state.vel.numpy(), atol=2e-3)


def test_surface_off_wcsph_simulation_runs_through_the_kernel(dev):
    """With surface effects off, the card's WCSPH frames launch
    density_visc and pressure_force through the particle-list kernel, once
    a frame each, and the column kernel never; they agree with the CPU's
    at the one-step bars after 3 frames."""
    off = CFG.replace(surface_tension=0.0, air_pressure=0.0)
    cc.reset_launch_counts()
    gpu = T.Simulation(solver="wcsph", cfg=off, fluid_pos=_block(),
                       device=dev)
    gpu.run(3)
    frames = 4 + gpu.retries                    # warm-up + 3 + retries
    _scene_built_once()
    assert {k: n for k, n in cc.LAUNCHES.items() if n} == {
        "particle_density": 1, "particle_density_visc": frames,
        "particle_pressure_force": frames}
    cpu = T.Simulation(solver="wcsph", cfg=off, fluid_pos=_block(),
                       device="cpu")
    cpu.run(3)
    assert gpu.config_key == cpu.config_key
    np.testing.assert_allclose(gpu.state.pos.cpu().numpy(),
                               cpu.state.pos.numpy(), atol=2e-6)
    np.testing.assert_allclose(gpu.state.vel.cpu().numpy(),
                               cpu.state.vel.numpy(), atol=2e-3)


def _dfsph_frames_launched(per_frame, frames):
    """The card's DFSPH frames launched ``per_frame`` (particle-list
    instances, once a frame each) and divergence == stiffness_accel >= 5 a
    frame, the particle-list density once for the scene, nothing else."""
    _scene_built_once()
    la = cc.LAUNCHES
    for name in per_frame:
        assert la[name] == frames, (name, la)
    assert la["particle_divergence"] == la["particle_stiffness_accel"] \
        >= 5 * frames
    assert {k: n for k, n in la.items() if n} == dict(
        {name: frames for name in per_frame}, particle_density=1,
        particle_divergence=la["particle_divergence"],
        particle_stiffness_accel=la["particle_stiffness_accel"])


def _dfsph_step_agrees(gpu, cfg):
    """One DFSPH step from the card's state agrees on the card and on the
    CPU at the one-step bars, with equal iteration counts."""
    dims, dims_b = gpu._dims()

    def step(state, carry, scene):
        return ds.dfsph_step(state, carry, scene, cfg, CFG.dt, dims, dims_b,
                             gpu.box)

    def cpu(x):
        return type(x)(*(t.cpu() for t in x))

    g1, _, gm = step(gpu.state, gpu.carry, gpu.scene)
    c1, _, cm = step(cpu(gpu.state), cpu(gpu.carry), cpu(gpu.scene))
    assert int(gm["grid_overflow"]) == 0
    for key in ("divergence_iters", "density_iters"):
        assert int(gm[key]) == int(cm[key])
    np.testing.assert_allclose(g1.pos.cpu().numpy(), c1.pos.numpy(),
                               atol=2e-6)
    np.testing.assert_allclose(g1.vel.cpu().numpy(), c1.vel.numpy(),
                               atol=2e-3)


def test_dfsph_simulation_runs_through_the_kernel(dev):
    """Every pass of the card's DFSPH frames launched the particle-list
    kernel; then one step from the state they reached agrees on the card
    and on the CPU at the one-step bars, with equal iteration counts."""
    cc.reset_launch_counts()
    gpu = T.Simulation(solver="dfsph", cfg=CFG, fluid_pos=_block(),
                       device=dev)
    gpu.run(3)
    frames = 4 + gpu.retries                    # warm-up + 3 + retries
    _dfsph_frames_launched(("particle_density_alpha_colorgrad",
                            "particle_viscosity", "particle_surface"),
                           frames)
    _dfsph_step_agrees(gpu, CFG)


def test_surface_off_dfsph_simulation_runs_through_the_kernel(dev):
    """With surface effects off, the card's DFSPH frames launch
    density_alpha and viscosity through the particle-list kernel once a
    frame each, the Jacobi passes as with surface effects on, and the
    column kernel never; one step from the state
    they reached agrees with the CPU's at the one-step bars, with equal
    iteration counts."""
    off = CFG.replace(surface_tension=0.0, air_pressure=0.0)
    cc.reset_launch_counts()
    gpu = T.Simulation(solver="dfsph", cfg=off, fluid_pos=_block(),
                       device=dev)
    gpu.run(3)
    frames = 4 + gpu.retries                    # warm-up + 3 + retries
    _dfsph_frames_launched(("particle_density_alpha", "particle_viscosity"),
                           frames)
    _dfsph_step_agrees(gpu, off)


def _pbd_frames_agree(cfg, per_frame, dev):
    """Run the card's PBD block 3 frames in ``cfg``: the two projection
    passes launched the particle-list kernel once per projection
    iteration, ``per_frame`` (particle-list instances) once a frame, the
    scene's density once, nothing else; then one step from the state they
    reached agrees on the card and on the CPU at the one-step bars, with
    equal iteration counts."""
    cc.reset_launch_counts()
    gpu = T.Simulation(solver="pbd", cfg=cfg, fluid_pos=_block(),
                       device=dev)
    iters = [int(gpu.metrics["pbd_iters"])]
    for _ in range(3):
        gpu.step()
        iters.append(int(gpu.metrics["pbd_iters"]))
    assert gpu.retries == 0
    _scene_built_once()
    la = cc.LAUNCHES
    assert la["particle_pbd_lambda"] == la["particle_stiffness_accel"] \
        == sum(iters)
    for name in per_frame:
        assert la[name] == 4, (name, la)
    assert {k: n for k, n in la.items() if n} == dict(
        {name: 4 for name in per_frame}, particle_density=1,
        particle_pbd_lambda=sum(iters), particle_stiffness_accel=sum(iters))

    dims, dims_b = gpu._dims()

    def step(state, carry, scene):
        return ds.pbd_step(state, carry, scene, cfg, cfg.dt, dims, dims_b,
                           gpu.box)

    def cpu(x):
        return type(x)(*(t.cpu() for t in x))

    g1, gc, gm = step(gpu.state, gpu.carry, gpu.scene)
    c1, cc1, cm = step(cpu(gpu.state), cpu(gpu.carry), cpu(gpu.scene))
    assert int(gm["grid_overflow"]) == 0
    assert int(gm["pbd_iters"]) == int(cm["pbd_iters"])
    np.testing.assert_allclose(g1.pos.cpu().numpy(), c1.pos.numpy(),
                               atol=2e-6)
    np.testing.assert_allclose(g1.vel.cpu().numpy(), c1.vel.numpy(),
                               atol=2e-3)
    np.testing.assert_allclose(gc.pos_last.cpu().numpy(),
                               cc1.pos_last.numpy(), atol=2e-6)


def test_pbd_simulation_runs_through_the_kernel(dev):
    """Every pass of the card's PBD frames launched the particle-list
    kernel, the two projection passes once per projection iteration,
    xsph_colorgrad and surface once per frame; one step from the state
    they reached agrees with the CPU's."""
    _pbd_frames_agree(CFG, ("particle_xsph_colorgrad", "particle_surface"),
                      dev)


def test_surface_off_pbd_simulation_runs_through_the_kernel(dev):
    """With surface effects off, the card's PBD frames launch the
    fluid-only xsph through the particle-list kernel once a frame
    (particle_xsph == the frames run) and the column kernel's xsph never;
    one step from the state they reached agrees with the CPU's."""
    off = CFG.replace(surface_tension=0.0, air_pressure=0.0)
    _pbd_frames_agree(off, ("particle_xsph",), dev)
    assert cc.LAUNCHES["xsph"] == 0


@pytest.fixture(scope="module")
def flat_state(dev):
    """Positions and velocities of the block after 3 WCSPH frames."""
    sim = T.Simulation(solver="wcsph", cfg=CFG, fluid_pos=_block(),
                       device=dev)
    sim.run(3)
    return sim.state.pos, sim.state.vel


@pytest.mark.parametrize("k", [fp.K, 101])
@pytest.mark.parametrize("body", list(cc.FLAT_IDS))
def test_flat_kernel_matches_plain_and_untiled(flat_state, body, k):
    """The tiled kernel through flat_pallas_pass against a second tiled
    launch (bitwise), the untiled kernel and the plain executor (per row,
    BAR), each launch counted once (fp.compare). CFG's ghosted grid is no
    multiple of 4, so at K 24 the last bricks run past its edge; at K 101
    the brick shrinks below 2x4x4 for every body."""
    fl, dims = fp.build_grid(*flat_state, CFG, k)
    x = fp.operand(body, fl)
    brick = cc.flat_brick(x.shape[0], k)[0]
    if k == fp.K:
        assert brick == cc.BRICKS[0]
        assert any(g % b for g, b in zip((dims.gx, dims.gy, dims.gz), brick))
    else:
        assert brick != cc.BRICKS[0]
    n0 = cc.LAUNCHES[f"flat_{body}"]
    out = flat_pallas_pass(body, x, dims, CFG)
    assert cc.LAUNCHES[f"flat_{body}"] == n0 + 1
    rec = fp.compare(body, fl, dims, CFG, out)
    assert rec["brick"] == list(brick)
    assert bool(out.any())


def test_flat_wrapper_checks_operands(flat_state):
    fl, dims = fp.build_grid(*flat_state, CFG)
    x = fp.operand("dcv", fl)
    with pytest.raises(ValueError, match="float32"):
        cc.flat_pass_cuda("dcv", x.double(), dims, CFG)
    with pytest.raises(ValueError, match="shape"):
        cc.flat_pass_cuda("dcv", fl[:5], dims, CFG)
    with pytest.raises(ValueError, match="not a CUDA device"):
        cc.flat_pass_cuda("dcv", x.cpu(), dims, CFG)
    big = dims._replace(k=240)            # 7 rows x 240 slots: no brick fits
    with pytest.raises(ValueError, match="do not fit"):
        cc.flat_pass_cuda("dcv", torch.zeros((7, 240, dims.g),
                                             device=x.device), big, CFG)


@pytest.mark.parametrize("body", list(cc.FLAT_IDS))
def test_flat_kernel_on_every_brick_is_bitwise_equal(flat_state, body):
    """Every brick of the ladder that fits K 24 gives the default brick's
    output bitwise (fp.time_bricks checks it and times each)."""
    fl, dims = fp.build_grid(*flat_state, CFG)
    x = fp.operand(body, fl)
    out = flat_pallas_pass(body, x, dims, CFG)
    ladder = fp.time_bricks(body, fl, dims, CFG, out)
    assert [tuple(r["brick"]) for r in ladder] == list(cc.BRICKS)
    assert all(r["ms"] > 0 and r["busy_bricks"] <= r["bricks"]
               for r in ladder)


def test_flat_wrapper_checks_the_brick(flat_state):
    fl, dims = fp.build_grid(*flat_state, CFG)
    x = fp.operand("dcv", fl)
    with pytest.raises(ValueError, match="not one of"):
        cc.flat_pass_cuda("dcv", x, dims, CFG, brick=(3, 3, 3))
    big = dims._replace(k=60)      # 7 rows x 60 slots: 2x2x4 fits, 2x4x4 not
    x = torch.zeros((7, 60, dims.g), device=x.device)
    with pytest.raises(ValueError, match="does not fit"):
        cc.flat_pass_cuda("dcv", x, big, CFG, brick=(2, 4, 4))
