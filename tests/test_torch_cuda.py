"""The hand-written CUDA neighbor-pass kernel, its particle-list variant
for pbd_lambda, stiffness_accel, divergence, surface_pressure,
density_colorgrad_visc, xsph_colorgrad, density_alpha_colorgrad,
density_visc, pressure_force, density_alpha, the fluid-only viscosity,
surface and xsph, and the scene build's density (at each group width and
reduction the pass takes; the wrapper refuses the others; divergence and
density_colorgrad_visc also on cells full to K and on empty ones, and on a
2x2 block's window), the cell-packed record kernel and its pack that run
the passes of ``column_pass_cuda.RECORD_IDS`` on the steps (at each width,
reduction and unroll, in any order of the slot list, on full and empty
cells and on a 2x2 block's window, bitwise the particle-list kernel; the
pack bitwise its plain version on the records a walk reads; both also at
a rho0 that is not a power of two; the counted walk of pbd_lambda,
stiffness_accel and the surface-off pressure_force and density_alpha also
on one position pack shared by PBD's two, bitwise a fresh pack's, and at a
listed padding slot), and the brick-tiled
fluid-only variant, on the card.
Every Simulation on the card launches the particle-list density once, for
its scene, and the column kernel never.

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
from cpp_fluid_particles_tpu_torch.ops import box as bxm
from cpp_fluid_particles_tpu_torch.ops import column_pass_cuda as cc
from cpp_fluid_particles_tpu_torch.ops import passes as pp
from cpp_fluid_particles_tpu_torch.ops.dense import DenseDims
from cpp_fluid_particles_tpu_torch.ops.grid import POS_PAD
from cpp_fluid_particles_tpu_torch.ops.passes import flat_pallas_pass
from cpp_fluid_particles_tpu_torch.parallel import halo
from cpp_fluid_particles_tpu_torch.parallel import mesh as tmesh

pytestmark = pytest.mark.cuda

CFG = T.dam_break_config(mode="parity", space_size=(0.52, 0.52, 0.52))
BAR = 2e-5          # rtol, and atol x the output's max
# the record passes whose terms do not read rho0
RHO0_FREE = ("stiffness_accel", "pressure_force", "density_alpha")


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


def _no_r2_cut(monkeypatch):
    """From here on the wrappers hand the kernels r2_cut = +inf, so every
    candidate pair reaches the square root and in_support, as it did
    before the kernels turned pairs past r2_cut away early."""
    consts = cc._consts

    def uncut(cfg):
        vals = consts(cfg)
        vals[len(vals) - 1] = float("inf")
        return vals
    monkeypatch.setattr(cc, "_consts", uncut)


@pytest.mark.parametrize("name", list(cc.PASS_IDS))
def test_r2_cut_changes_no_bit(operands, monkeypatch, name):
    """The squared-distance early-out rejects only pairs that in_support
    rejects too, and runs the same float operations on the others: the
    column kernel, the particle-list kernel at every (width, reduction) of
    the pass, and the record kernel at every (width, reduction, unroll),
    give bitwise the same output with r2_cut as with +inf."""
    _, fl, bd, dims, dims_b, islots = operands[name]

    def run_all():
        outs = [cc.column_pass_cuda(name, fl, bd, dims, dims_b, CFG)]
        if name in pp.PARTICLE_PASSES:
            outs += [cc.particle_pass_cuda(name, fl, bd, islots, dims,
                                           dims_b, CFG, lanes=lanes,
                                           reduction=red)
                     for lanes, red in cc.variants(name)]
        if name in cc.RECORD_IDS:
            outs += [cc.record_pass_cuda(name, fl, bd, islots, dims, dims_b,
                                         CFG, lanes=lanes, reduction=red,
                                         unroll=u)
                     for lanes, red in cc.variants(name)
                     for u in cc.unrolls(name)]
        torch.cuda.synchronize()
        return outs
    cut = run_all()
    _no_r2_cut(monkeypatch)
    uncut = run_all()
    n_var = len(cc.variants(name)) if name in pp.PARTICLE_PASSES else 0
    n_rec = n_var * len(cc.unrolls(name)) if name in cc.RECORD_IDS else 0
    assert len(cut) == 1 + n_var + n_rec
    for a, b in zip(cut, uncut):
        assert torch.equal(a, b)


def _kernels(*names):
    """The launch counters of passes ``names`` on a path: the record
    kernel's pack and walk for ``cc.RECORD_IDS`` (the walk alone for
    ``cc.COUNTED``, whose shared position pack a path counts apart), else
    the particle-list kernel."""
    return tuple(k for n in names for k in (
        (f"record_{n}",) if n in cc.COUNTED
        else (f"pack_{n}", f"record_{n}") if n in cc.RECORD_IDS
        else (f"particle_{n}",)))


def _walk(name):
    """The launch counter of pass ``name``'s walk on a path."""
    return _kernels(name)[-1]


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
    bars after 3 frames, and the card's frames all launched the kernels:
    density_colorgrad_visc the particle-list kernel, surface_pressure the
    record kernel and its pack where ``cc.RECORD_IDS`` has it."""
    cc.reset_launch_counts()
    gpu = T.Simulation(solver="wcsph", cfg=CFG, fluid_pos=_block(),
                       device=dev)
    gpu.run(3)
    frames = 4 + gpu.retries                    # warm-up + 3 + retries
    _scene_built_once()
    assert {k: n for k, n in cc.LAUNCHES.items() if n} == dict(
        {k: frames for k in _kernels("density_colorgrad_visc",
                                     "surface_pressure")},
        particle_density=1)
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
    density_visc through the particle-list kernel and pressure_force
    through its path's kernel (for ``cc.COUNTED`` the counted walk and a
    position pack of its own), once a frame each, and the column kernel
    never; they agree with the CPU's at the one-step bars after 3
    frames."""
    off = CFG.replace(surface_tension=0.0, air_pressure=0.0)
    cc.reset_launch_counts()
    gpu = T.Simulation(solver="wcsph", cfg=off, fluid_pos=_block(),
                       device=dev)
    gpu.run(3)
    frames = 4 + gpu.retries                    # warm-up + 3 + retries
    _scene_built_once()
    packs = ("pack_positions",) if "pressure_force" in cc.COUNTED else ()
    assert {k: n for k, n in cc.LAUNCHES.items() if n} == dict(
        {k: frames for k in _kernels("density_visc", "pressure_force")
         + packs}, particle_density=1)
    cpu = T.Simulation(solver="wcsph", cfg=off, fluid_pos=_block(),
                       device="cpu")
    cpu.run(3)
    assert gpu.config_key == cpu.config_key
    np.testing.assert_allclose(gpu.state.pos.cpu().numpy(),
                               cpu.state.pos.numpy(), atol=2e-6)
    np.testing.assert_allclose(gpu.state.vel.cpu().numpy(),
                               cpu.state.vel.numpy(), atol=2e-3)


def _dfsph_frames_launched(per_frame, frames):
    """The card's DFSPH frames launched ``per_frame`` (launch counters,
    once a frame each), divergence == stiffness_accel >= 5 a frame, one
    position pack a frame where stiffness_accel's walk is counted, the
    particle-list density once for the scene, nothing else."""
    _scene_built_once()
    la = cc.LAUNCHES
    sa = _walk("stiffness_accel")
    packs = ({"pack_positions": frames} if "stiffness_accel" in cc.COUNTED
             else {})
    for name in per_frame:
        assert la[name] == frames, (name, la)
    assert la["particle_divergence"] == la[sa] >= 5 * frames
    assert {k: n for k, n in la.items() if n} == dict(
        {name: frames for name in per_frame}, particle_density=1,
        particle_divergence=la["particle_divergence"], **{sa: la[sa]},
        **packs)


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
    kernel, or for ``cc.RECORD_IDS`` (surface) the record kernel and its
    pack; then one step from the state they
    reached agrees on the card
    and on the CPU at the one-step bars, with equal iteration counts."""
    cc.reset_launch_counts()
    gpu = T.Simulation(solver="dfsph", cfg=CFG, fluid_pos=_block(),
                       device=dev)
    gpu.run(3)
    frames = 4 + gpu.retries                    # warm-up + 3 + retries
    _dfsph_frames_launched(_kernels("density_alpha_colorgrad", "viscosity",
                                    "surface"), frames)
    _dfsph_step_agrees(gpu, CFG)


def test_surface_off_dfsph_simulation_runs_through_the_kernel(dev):
    """With surface effects off, the card's DFSPH frames launch
    density_alpha and viscosity once a frame each (through the
    particle-list kernel, or for ``cc.RECORD_IDS`` the record kernel and
    its pack), the Jacobi passes as with surface effects on, and the
    column kernel never; one step from the state
    they reached agrees with the CPU's at the one-step bars, with equal
    iteration counts."""
    off = CFG.replace(surface_tension=0.0, air_pressure=0.0)
    cc.reset_launch_counts()
    gpu = T.Simulation(solver="dfsph", cfg=off, fluid_pos=_block(),
                       device=dev)
    gpu.run(3)
    frames = 4 + gpu.retries                    # warm-up + 3 + retries
    _dfsph_frames_launched(_kernels("density_alpha", "viscosity"), frames)
    _dfsph_step_agrees(gpu, off)


def _pbd_frames_agree(cfg, per_frame, dev):
    """Run the card's PBD block 3 frames in ``cfg``: the two projection
    passes launched their kernels once per projection iteration (the
    counted walks sharing one position pack an iteration), ``per_frame``
    (launch counters) once a frame, the scene's density once, nothing
    else; then one step from the state they reached agrees on the card and
    on the CPU at the one-step bars, with equal iteration counts."""
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
    projection = _kernels("pbd_lambda", "stiffness_accel")
    if set(cc.COUNTED) & {"pbd_lambda", "stiffness_accel"}:
        projection += ("pack_positions",)
    assert all(la[k] == sum(iters) for k in projection), la
    for name in per_frame:
        assert la[name] == 4, (name, la)
    assert {k: n for k, n in la.items() if n} == dict(
        {name: 4 for name in per_frame}, particle_density=1,
        **{k: sum(iters) for k in projection})

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
    kernel, the two projection passes once per projection iteration, and
    xsph_colorgrad and surface once per frame, for ``cc.RECORD_IDS`` the
    record kernel and its pack; one step from the state they reached
    agrees with the CPU's."""
    _pbd_frames_agree(CFG, _kernels("xsph_colorgrad", "surface"), dev)


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


@pytest.mark.parametrize("body", list(cc.FLAT_IDS))
def test_flat_r2_cut_changes_no_bit(flat_state, monkeypatch, body):
    """The brick kernel and the untiled kernel give bitwise the same
    output with r2_cut as with +inf (test_r2_cut_changes_no_bit)."""
    fl, dims = fp.build_grid(*flat_state, CFG)
    x = fp.operand(body, fl)

    def run_both():
        outs = [cc.flat_pass_cuda(body, x, dims, CFG, tiled=t)
                for t in (True, False)]
        torch.cuda.synchronize()
        return outs
    cut = run_both()
    _no_r2_cut(monkeypatch)
    for a, b in zip(cut, run_both()):
        assert torch.equal(a, b)


def test_flat_wrapper_checks_the_brick(flat_state):
    fl, dims = fp.build_grid(*flat_state, CFG)
    x = fp.operand("dcv", fl)
    with pytest.raises(ValueError, match="not one of"):
        cc.flat_pass_cuda("dcv", x, dims, CFG, brick=(3, 3, 3))
    big = dims._replace(k=60)      # 7 rows x 60 slots: 2x2x4 fits, 2x4x4 not
    x = torch.zeros((7, 60, dims.g), device=x.device)
    with pytest.raises(ValueError, match="does not fit"):
        cc.flat_pass_cuda("dcv", x, big, CFG, brick=(2, 4, 4))


# ----------------------------------------------------------------------
# the particle-list kernel on full and empty cells and on a block's window
# ----------------------------------------------------------------------

# the two passes whose default variant the work list moved to W 8
WINDOW_PASSES = ("divergence", "density_colorgrad_visc")


def _particles_vs(name, fl, bd, islots, dims, dims_b, lanes, reduction,
                  want):
    """The particle-list kernel on these operands: two launches bitwise
    equal, each counted once, within BAR of ``want`` (per output row, at
    the listed slots) and 0 at every other slot -> the output."""
    n0 = cc.LAUNCHES[f"particle_{name}"]

    def run():
        return cc.particle_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG,
                                     lanes=lanes, reduction=reduction)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert cc.LAUNCHES[f"particle_{name}"] == n0 + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all()) and bool(got.any())
    listed = islots[islots < dims.k * dims.g]
    flat, ref = got.reshape(got.shape[0], -1), want.reshape(got.shape[0], -1)
    for r in range(got.shape[0]):
        scale = float(ref[r, listed].abs().max())
        torch.testing.assert_close(flat[r, listed], ref[r, listed], rtol=BAR,
                                   atol=BAR * scale)
    rest = torch.ones(flat.shape[1], dtype=torch.bool, device=flat.device)
    rest[listed] = False
    assert not bool(flat[:, rest].any())
    return got


def _full_and_empty_cells(dev, name):
    """Operands of pass ``name`` on a 6x5x4-cell box (K 6, Kb 3) in which
    every ghosted cell, the ring included, holds K (or Kb) particles, none
    or a random count below, a third of the cells each, jittered inside
    their cells; masses and velocities random. -> fl, bd, the slot list
    (every real slot of an interior cell, shuffled, and trash entries),
    dims, dims_b."""
    rng = np.random.default_rng(11)
    dims = DenseDims(6, 5, 4, 6)
    dims_b = DenseDims(6, 5, 4, 3)
    cl = CFG.cell_length
    ghosted = (dims.gx, dims.gy, dims.gz)
    corner = np.stack(np.meshgrid(*(np.arange(n) for n in ghosted),
                                  indexing="ij"), -1).reshape(-1, 3) - 1.0

    def grid(rows, k):
        kind = rng.integers(0, 3, dims.g)
        occ = np.where(kind == 0, k, np.where(kind == 1, 0,
                                              rng.integers(1, k, dims.g)))
        x = np.zeros((rows, k, dims.g), np.float32)
        x[:3] = POS_PAD
        real = np.arange(k)[:, None] < occ[None, :]
        pos = (corner[None] + rng.uniform(0.02, 0.98, (k, dims.g, 3))) * cl
        for a in range(3):
            x[a] = np.where(real, pos[..., a], x[a])
        x[3] = np.where(real, rng.uniform(5e-5, 1.5e-4, (k, dims.g)), 0.0)
        for a in range(4, rows):
            x[a] = np.where(real, rng.uniform(-1.0, 1.0, (k, dims.g)), 0.0)
        return x, occ, real

    fl, occ, real = grid(pp.PASSES[name].fi, dims.k)
    bd, occ_b, _ = grid(4, dims_b.k)
    cell = np.arange(dims.g)
    x, y, z = (cell // (dims.gy * dims.gz), cell // dims.gz % dims.gy,
               cell % dims.gz)
    inner = ((x > 0) & (x < dims.gx - 1) & (y > 0) & (y < dims.gy - 1)
             & (z > 0) & (z < dims.gz - 1))
    assert (occ[inner] == dims.k).any() and (occ[inner] == 0).any()
    assert (occ_b == dims_b.k).any() and (occ_b == 0).any()
    slots = np.flatnonzero((real & inner[None, :]).reshape(-1))
    slots = np.concatenate([slots, np.full(5, dims.k * dims.g)])
    rng.shuffle(slots)
    return (torch.as_tensor(fl, device=dev), torch.as_tensor(bd, device=dev),
            torch.as_tensor(slots, dtype=torch.int64, device=dev), dims,
            dims_b)


@pytest.mark.parametrize("reduction", cc.REDUCTIONS)
@pytest.mark.parametrize("lanes", cc.LANES)
@pytest.mark.parametrize("name", WINDOW_PASSES)
def test_particle_kernel_on_full_and_empty_cells(dev, name, lanes,
                                                 reduction):
    """Cells full to K (and to Kb on the boundary) have no padding slot to
    stop a walk, empty ones none to read, and the ghost ring holds
    particles as a block's window does: the particle-list kernel within BAR
    of the plain executor at every listed slot, 0 elsewhere."""
    fl, bd, islots, dims, dims_b = _full_and_empty_cells(dev, name)
    want = pp.column_pass_plain(name, fl, bd, dims, dims_b, CFG)
    _particles_vs(name, fl, bd, islots, dims, dims_b, lanes, reduction, want)


@pytest.fixture(scope="module")
def window_operands(dev):
    """For each of WINDOW_PASSES: the whole box's operands from one step
    of its solver after 3 frames of the block, and the BoxIndex, full
    boundary grid and dims that ops/box.slab_window cuts a block's window
    from."""
    got = {}
    for name, solver in (("divergence", "dfsph"),
                         ("density_colorgrad_visc", "wcsph")):
        sim = T.Simulation(solver=solver, cfg=CFG, fluid_pos=_block(),
                           device=dev)
        sim.run(3)
        calls = {}

        def record(n, fl, bd, dims, dims_b, cfg, islots=None):
            calls.setdefault(n, (fl, bd, dims, dims_b, islots))
            return pp.column_pass_plain(n, fl, bd, dims, dims_b, cfg)
        full, full_b = sim._dims()
        ds.DENSE_STEPS[solver](sim.state, sim.carry, sim.scene, CFG, CFG.dt,
                               full, full_b, sim.box, executor=record)
        box = DenseDims(*sim.box, full.k)
        idx = bxm.build_box_index(sim.state.pos, CFG, full, box)
        got[name] = calls[name] + (idx, sim.scene.bd, full, box,
                                   DenseDims(*sim.box, full_b.k))
    return got


def _window(x, slab, dims):
    """The block's window (with its ghost planes) of a whole-box grid."""
    cells = x.reshape(*x.shape[:2], dims.gx, dims.gy, dims.gz)
    return cells[:, :, slab.x0:slab.x1 + 2, :,
                 slab.z0:slab.z1 + 2].contiguous().reshape(*x.shape[:2], -1)


@pytest.mark.parametrize("reduction", cc.REDUCTIONS)
@pytest.mark.parametrize("lanes", cc.LANES)
@pytest.mark.parametrize("name", WINDOW_PASSES)
def test_particle_kernel_on_a_2x2_window(window_operands, name, lanes,
                                         reduction):
    """On each block of a 2x2 mesh, the window ops/box.slab_window cuts
    (its cell-major slot list and boundary window) with the fluid grid's
    window, ghost planes refreshed: the particle-list kernel within BAR of
    the plain executor on the window, and at the block's own particles
    bitwise equal to the kernel on the whole box, as the mesh needs."""
    fl, bd, dims, dims_b, islots, idx, full_bd, full, box, box_b = \
        window_operands[name]
    assert torch.equal(idx.work, islots)
    whole = cc.particle_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG,
                                  lanes=lanes, reduction=reduction)
    whole = whole.reshape(whole.shape[0], -1)
    kg = dims.k * dims.g
    seen = 0
    for r in range(4):
        mesh = tmesh.Mesh(None, r, 4, fl.device, None, tmesh.AXES_2D, (2, 2))
        slab = halo.make_slab(mesh, box.cx, box.cz)
        if slab.empty:
            continue
        lslots, lwork, ldims, ldims_b, lbd = bxm.slab_window(
            idx, full_bd, full, box, box_b, slab)
        assert torch.equal(torch.sort(lwork).values,
                           torch.sort(lslots).values)
        lslots = lwork
        lfl = _window(fl, slab, dims)
        assert torch.equal(lbd, _window(bd, slab, dims_b))
        want = pp.column_pass_plain(name, lfl, lbd, ldims, ldims_b, CFG)
        got = _particles_vs(name, lfl, lbd, lslots, ldims, ldims_b, lanes,
                            reduction, want)
        own = lslots < ldims.k * ldims.g
        assert torch.equal(got.reshape(got.shape[0], -1)[:, lslots[own]],
                           whole[:, islots[own]])
        assert bool((islots[own] < kg).all())
        seen += int(own.sum())
    assert seen == int((islots < kg).sum())


def test_graph_timing_leaves_the_launch_counts(operands):
    """utils.check.time_graph_ms captures a wrapper in a CUDA graph and
    replays it: the launch counts are as before, neither the captured
    calls nor the replays counted."""
    from cpp_fluid_particles_tpu_torch.utils.check import time_graph_ms
    _, fl, bd, dims, dims_b, islots = operands["divergence"]
    before = dict(cc.LAUNCHES)
    ms = time_graph_ms(lambda: cc.particle_pass_cuda(
        "divergence", fl, bd, islots, dims, dims_b, CFG), 5)
    assert ms > 0
    assert cc.LAUNCHES == before


# ----------------------------------------------------------------------
# the cell-packed record kernel (``cc.RECORD_IDS``) and its pack
# ----------------------------------------------------------------------

def _order(islots, dims, order):
    """The same slots as the step's list ``islots``: as given ("step"), in
    cell-major order ("cell_major", BoxIndex.work's: by cell, then rank;
    trash last) or shuffled (seeded)."""
    if order == "step":
        return islots
    if order == "shuffled":
        gen = torch.Generator().manual_seed(7)
        return islots[torch.randperm(islots.shape[0], generator=gen).to(
            islots.device)].contiguous()
    kg = dims.k * dims.g
    key = torch.where(islots < kg, (islots % dims.g) * dims.k
                      + islots // dims.g, kg)
    return islots[torch.sort(key, stable=True).indices].contiguous()


def _walked_records(recs, fl, bd):
    """The records of ``recs`` that a walk reads (``cc.read_records``): geo
    at the real slots and, but in the counted pack, each cell's first
    padding slot, the j side at the real slots, the boundary's geo
    likewise, and the counted pack's counts -> a tuple of tensors."""
    return cc.read_records(recs, fl, bd)


@pytest.mark.parametrize("name", list(cc.RECORD_IDS))
def test_pack_kernel_is_bitwise_its_plain_version(operands, name):
    """On every record a walk reads, the pack kernel writes exactly
    pack_records_plain's (|cg|^2 is rounded as the torch ops round it,
    never contracted into an fma; m / rho0, which the kernel divides and
    torch multiplies by the reciprocal, at this config's rho0 of 1), twice
    the same, one launch counted per call and no walk."""
    _, fl, bd, dims, dims_b, _ = operands[name]
    n0 = dict(cc.LAUNCHES)
    got = cc.pack_records(name, fl, bd, dims, dims_b, CFG)
    again = cc.pack_records(name, fl, bd, dims, dims_b, CFG)
    torch.cuda.synchronize()
    key = cc.pack_key(name)
    assert cc.LAUNCHES[key] == n0[key] + 2
    assert cc.LAUNCHES[f"record_{name}"] == n0[f"record_{name}"]
    plain = cc.pack_records_plain(name, fl, bd, CFG)
    assert all(t is None or t.is_cuda for t in got)
    assert all((a is None) == (b is None) and (a is None or (
        a.shape == b.shape and a.dtype == b.dtype)) for a, b in zip(got,
                                                                    plain))
    for a, b, c in zip(*(_walked_records(r, fl, bd)
                         for r in (got, again, plain))):
        assert a.numel() > 0 and bool(torch.isfinite(c.float()).all())
        assert torch.equal(a, b) and torch.equal(a, c)
    assert (got.bgeo is None) == (not pp.PASSES[name].has_bd)


# (pass, lanes, reduction) of every record pass at each variant it takes
RECORD_VARIANTS = [(name, lanes, red) for name in cc.RECORD_IDS
                   for lanes, red in cc.variants(name)]


@pytest.mark.parametrize("order", ["step", "cell_major", "shuffled"])
@pytest.mark.parametrize("name, lanes, reduction", RECORD_VARIANTS)
def test_record_kernel_is_bitwise_the_particle_kernel(operands, name, lanes,
                                                      reduction, order):
    """At every unroll, the record kernel on the step's operand and slots
    (in the list's order, cell-major, or shuffled): within BAR of the plain
    executor, two launches bitwise equal, and bitwise equal to the
    particle-list kernel at the same (width, reduction): the same pairs
    in the same order through the same float operations. Each call counts
    one pack and one walk; with records handed in, the walk alone."""
    _, fl, bd, dims, dims_b, islots = operands[name]
    lst = _order(islots, dims, order)
    want = pp.column_pass_plain(name, fl, bd, dims, dims_b, CFG)
    part = cc.particle_pass_cuda(name, fl, bd, lst, dims, dims_b, CFG,
                                 lanes=lanes, reduction=reduction)
    recs = cc.pack_records(name, fl, bd, dims, dims_b, CFG)
    scale = float(want.abs().max())
    key = cc.pack_key(name)
    for unroll in cc.unrolls(name):
        n0 = dict(cc.LAUNCHES)
        got = cc.record_pass_cuda(name, fl, bd, lst, dims, dims_b, CFG,
                                  lanes=lanes, reduction=reduction,
                                  unroll=unroll)
        again = cc.record_pass_cuda(name, fl, bd, lst, dims, dims_b, CFG,
                                    lanes=lanes, reduction=reduction,
                                    unroll=unroll, records=recs)
        torch.cuda.synchronize()
        assert cc.LAUNCHES[key] == n0[key] + 1
        assert cc.LAUNCHES[f"record_{name}"] == n0[f"record_{name}"] + 2
        assert torch.equal(got, again)
        assert bool(torch.isfinite(got).all()) and bool(got.any())
        torch.testing.assert_close(got, want, rtol=BAR, atol=BAR * scale)
        assert torch.equal(got, part), unroll


@pytest.mark.parametrize("name", list(cc.RECORD_IDS))
def test_record_kernel_writes_only_listed_slots(operands, name):
    """Invalid particles (slot K*G) leave their slots 0 and the others as
    with the whole list; an empty list gives an all-zero output."""
    _, fl, bd, dims, dims_b, islots = operands[name]
    full = cc.record_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG)
    kg = dims.k * dims.g
    drop = torch.arange(0, islots.shape[0], 3, device=islots.device)
    cut = islots.clone()
    cut[drop] = kg
    part = cc.record_pass_cuda(name, fl, bd, cut, dims, dims_b, CFG
                               ).reshape(full.shape[0], -1)
    full = full.reshape(full.shape[0], -1)
    gone = islots[drop]
    gone = gone[gone < kg]
    assert gone.numel() > 0
    assert not bool(part[:, gone].any())
    kept = cut[cut < kg]
    assert torch.equal(part[:, kept], full[:, kept])
    empty = cc.record_pass_cuda(name, fl, bd, islots[:0], dims, dims_b, CFG)
    assert not bool(empty.any())


@pytest.mark.parametrize("name, unroll", [(name, u) for name in cc.RECORD_IDS
                                          for u in cc.unrolls(name)])
def test_record_kernel_on_full_and_empty_cells(dev, name, unroll):
    """Cells full to K (and Kb) hold no padding record to stop a batch of
    the walk, empty ones stop it at their first record, and the ghost ring
    holds particles: within BAR of the plain executor at every listed slot,
    0 elsewhere, and bitwise the particle-list kernel, at every variant."""
    fl, bd, islots, dims, dims_b = _full_and_empty_cells(dev, name)
    if not pp.PASSES[name].has_bd:
        bd, dims_b = None, None
    want = pp.column_pass_plain(name, fl, bd, dims, dims_b, CFG)
    for lanes, red in cc.variants(name):
        part = _particles_vs(name, fl, bd, islots, dims, dims_b, lanes, red,
                             want)
        got = cc.record_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG,
                                  lanes=lanes, reduction=red, unroll=unroll)
        assert torch.equal(got, part), (lanes, red)


@pytest.fixture(scope="module")
def record_window_operands(dev):
    """For each record pass: the whole box's operands from one step of its
    solver (surface, viscosity and stiffness_accel: DFSPH;
    surface_pressure: WCSPH; xsph_colorgrad and pbd_lambda: PBD; with
    surface effects off, pressure_force: WCSPH, density_alpha: DFSPH)
    after 3 frames of the block, and the BoxIndex, full boundary grid and
    dims that ops/box.slab_window cuts a block's window from."""
    off = CFG.replace(surface_tension=0.0, air_pressure=0.0)
    got = {}
    for name, solver, cfg in (
            ("surface", "dfsph", CFG), ("surface_pressure", "wcsph", CFG),
            ("xsph_colorgrad", "pbd", CFG), ("viscosity", "dfsph", CFG),
            ("pbd_lambda", "pbd", CFG), ("stiffness_accel", "dfsph", CFG),
            ("pressure_force", "wcsph", off),
            ("density_alpha", "dfsph", off)):
        sim = T.Simulation(solver=solver, cfg=cfg, fluid_pos=_block(),
                           device=dev)
        sim.run(3)
        calls = {}

        def record(n, fl, bd, dims, dims_b, cfg, islots=None):
            calls.setdefault(n, (fl, bd, dims, dims_b, islots))
            return pp.column_pass_plain(n, fl, bd, dims, dims_b, cfg)
        full, full_b = sim._dims()
        ds.DENSE_STEPS[solver](sim.state, sim.carry, sim.scene, cfg, CFG.dt,
                               full, full_b, sim.box, executor=record)
        box = DenseDims(*sim.box, full.k)
        idx = bxm.build_box_index(sim.state.pos, CFG, full, box)
        got[name] = calls[name] + (idx, sim.scene.bd, full, box,
                                   DenseDims(*sim.box, full_b.k))
    return got


@pytest.mark.parametrize("name, lanes, reduction", RECORD_VARIANTS)
def test_record_kernel_on_a_2x2_window(record_window_operands, name, lanes,
                                       reduction):
    """On each block of a 2x2 mesh, the window ops/box.slab_window cuts
    (the list the step hands the pass there: surface the window's
    cell-major list, surface_pressure its slots in the particles' order;
    surface_pressure's boundary window) with the fluid grid's window,
    ghost cells refreshed: the record kernel, packing the window, is
    bitwise the particle-list kernel on it, 0 at every slot it does not
    list, at the block's own particles bitwise the record kernel on the
    whole box, as the mesh needs, and so within BAR of the plain executor
    on the window, the bar's row max being the whole box's (a block lists
    as few as a dozen particles, too few for its own row max to scale the
    bar)."""
    fl, bd, dims, dims_b, islots, idx, full_bd, full, box, box_b = \
        record_window_operands[name]
    work = name != "surface_pressure"
    assert torch.equal(idx.work if work else idx.slots, islots)
    whole = cc.record_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG,
                                lanes=lanes, reduction=reduction)
    whole = whole.reshape(whole.shape[0], -1)
    scale = pp.column_pass_plain(name, fl, bd, dims, dims_b, CFG).reshape(
        whole.shape[0], -1).abs().amax(1)
    kg = dims.k * dims.g
    seen = 0
    for r in range(4):
        mesh = tmesh.Mesh(None, r, 4, fl.device, None, tmesh.AXES_2D, (2, 2))
        slab = halo.make_slab(mesh, box.cx, box.cz)
        if slab.empty:
            continue
        lslots, lwork, ldims, ldims_b, lbd = bxm.slab_window(
            idx, full_bd, full, box, box_b, slab)
        lst = lwork if work else lslots
        lfl = _window(fl, slab, dims)
        if bd is None:
            lbd, ldims_b = None, None
        else:
            assert torch.equal(lbd, _window(bd, slab, dims_b))
        got = cc.record_pass_cuda(name, lfl, lbd, lst, ldims, ldims_b, CFG,
                                  lanes=lanes, reduction=reduction)
        part = cc.particle_pass_cuda(name, lfl, lbd, lst, ldims, ldims_b, CFG,
                                     lanes=lanes, reduction=reduction)
        assert torch.equal(got, part)
        # the window's list maps the whole box's elementwise
        own = lst < ldims.k * ldims.g
        flat = got.reshape(got.shape[0], -1)
        assert torch.equal(flat[:, lst[own]], whole[:, islots[own]])
        rest = torch.ones(flat.shape[1], dtype=torch.bool, device=fl.device)
        rest[lst[own]] = False
        assert not bool(flat[:, rest].any())
        want = pp.column_pass_plain(name, lfl, lbd, ldims, ldims_b, CFG
                                    ).reshape(flat.shape)
        for row in range(flat.shape[0]):
            torch.testing.assert_close(
                flat[row, lst[own]], want[row, lst[own]], rtol=BAR,
                atol=BAR * float(scale[row]))
        seen += int(own.sum())
    assert seen == int((islots < kg).sum())


def test_record_wrappers_refuse_on_the_card(operands):
    """On CUDA tensors too, a pass without a record kernel, an unroll,
    width or reduction the kernel lacks, and a slot list on another device
    are refused before anything launches."""
    _, fl, bd, dims, dims_b, islots = operands["surface_pressure"]
    _, dfl, _, ddims, _, _ = operands["divergence"]
    before = dict(cc.LAUNCHES)
    with pytest.raises(ValueError, match="no record kernel"):
        cc.pack_records("divergence", dfl, bd, ddims, dims_b, CFG)
    with pytest.raises(ValueError, match="unroll 8 is not one of"):
        cc.record_pass_cuda("surface_pressure", fl, bd, islots, dims,
                            dims_b, CFG, unroll=8)
    with pytest.raises(ValueError, match="lanes 4 is not one of"):
        cc.record_pass_cuda("surface_pressure", fl, bd, islots, dims,
                            dims_b, CFG, lanes=4)
    with pytest.raises(ValueError, match="islots is on cpu"):
        cc.record_pass_cuda("surface_pressure", fl, bd, islots.cpu(), dims,
                            dims_b, CFG)
    with pytest.raises(ValueError, match="a boundary operand"):
        cc.record_pass_cuda("surface_pressure", fl, None, islots, dims, None,
                            CFG)
    # records of another pass, or packed on the CPU, are refused too
    _, sfl, _, sdims, _, _ = operands["surface"]
    recs = cc.pack_records_plain("surface_pressure", fl, bd, CFG)
    other = cc.pack_records("surface", sfl, None, sdims, None, CFG)
    before = dict(cc.LAUNCHES)
    with pytest.raises(ValueError, match=r"records\.(geo|side) has shape"):
        cc.record_pass_cuda("surface_pressure", fl, bd, islots, dims,
                            dims_b, CFG, records=other)
    with pytest.raises(ValueError, match="records.geo is on cpu"):
        cc.record_pass_cuda("surface_pressure", fl, bd, islots, dims,
                            dims_b, CFG,
                            records=cc.Records(*(None if t is None else
                                                 t.cpu() for t in recs)))
    assert cc.LAUNCHES == before


@pytest.mark.parametrize("name", list(cc.RECORD_IDS))
def test_record_kernel_replays_from_a_cuda_graph(operands, name):
    """The pack and the walk allocate on the current stream and never
    sync, so a CUDA graph holds both: its replay gives the eager output
    bitwise, and utils.check.time_graph_ms leaves the launch counts."""
    from cpp_fluid_particles_tpu_torch.utils.check import time_graph_ms
    _, fl, bd, dims, dims_b, islots = operands[name]
    eager = cc.record_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cc.record_pass_cuda(name, fl, bd, islots, dims, dims_b, CFG)
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    before = dict(cc.LAUNCHES)
    assert time_graph_ms(lambda: cc.record_pass_cuda(
        name, fl, bd, islots, dims, dims_b, CFG), 5) > 0
    assert cc.LAUNCHES == before


@pytest.mark.parametrize("name", list(cc.RECORD_IDS))
def test_pack_and_record_kernel_at_another_rho0(operands, name):
    """At rho0 1.3, not a power of two, so that m / rho0 (the pack's j side
    of xsph_colorgrad) and lap / rho0 round: the pack kernel is bitwise
    pack_records_plain on the records a walk reads (the plain pack divides
    by a tensor, as the kernel's __fdiv_rn; torch on a card would multiply
    by the reciprocal of a Python scalar), and the record kernel is bitwise
    the particle-list kernel at every variant and unroll, within BAR of the
    plain executor at that rho0."""
    cfg = CFG.replace(rho0=1.3)
    _, fl, bd, dims, dims_b, islots = operands[name]
    got = cc.pack_records(name, fl, bd, dims, dims_b, cfg)
    plain = cc.pack_records_plain(name, fl, bd, cfg)
    torch.cuda.synchronize()
    for a, b in zip(_walked_records(got, fl, bd),
                    _walked_records(plain, fl, bd)):
        assert a.numel() > 0 and bool(torch.isfinite(b).all())
        assert torch.equal(a, b)
    want = pp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)
    base = pp.column_pass_plain(name, fl, bd, dims, dims_b, CFG)
    # the terms of stiffness_accel, pressure_force and density_alpha do not
    # read rho0
    assert torch.equal(want, base) == (name in RHO0_FREE)
    scale = float(want.abs().max())
    for lanes, red in cc.variants(name):
        part = cc.particle_pass_cuda(name, fl, bd, islots, dims, dims_b, cfg,
                                     lanes=lanes, reduction=red)
        torch.testing.assert_close(part, want, rtol=BAR, atol=BAR * scale)
        for unroll in cc.unrolls(name):
            rec = cc.record_pass_cuda(name, fl, bd, islots, dims, dims_b,
                                      cfg, lanes=lanes, reduction=red,
                                      unroll=unroll)
            assert torch.equal(rec, part), (lanes, red, unroll)


# ----------------------------------------------------------------------
# the counted walk (``cc.COUNTED``) over one shared position pack
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def projection_operands(dev):
    """pbd_lambda's and stiffness_accel's operands of one projection
    iteration of a PBD step after 3 frames of the block: the same
    positions, masses and boundary window."""
    sim = T.Simulation(solver="pbd", cfg=CFG, fluid_pos=_block(), device=dev)
    sim.run(3)
    calls = {}

    def record(n, fl, bd, dims, dims_b, cfg, islots=None):
        calls.setdefault(n, (fl, bd, dims, dims_b, islots))
        return pp.column_pass_plain(n, fl, bd, dims, dims_b, cfg)
    dims, dims_b = sim._dims()
    ds.pbd_step(sim.state, sim.carry, sim.scene, CFG, CFG.dt, dims, dims_b,
                sim.box, executor=record)
    return calls["pbd_lambda"], calls["stiffness_accel"]


@pytest.mark.parametrize("unroll", cc.COUNTED_UNROLLS)
def test_one_position_pack_serves_both_projection_passes(projection_operands,
                                                         unroll):
    """The position pack of pbd_lambda's operand, handed to
    stiffness_accel's walk, gives bitwise its walk on a fresh pack of its
    own operand, and both walks bitwise their particle-list kernels at
    every variant; the two packs are bitwise equal where a walk reads, and
    a reused pack counts no pack launch."""
    (lfl, lbd, ldims, ldims_b, lslots), (fl, bd, dims, dims_b, islots) = \
        projection_operands
    assert torch.equal(lfl, fl[:4]) and torch.equal(lbd, bd)
    shared = cc.pack_records("pbd_lambda", lfl, lbd, ldims, ldims_b, CFG)
    own = cc.pack_records("stiffness_accel", fl, bd, dims, dims_b, CFG)
    for a, b in zip(cc.read_records(shared, lfl, lbd),
                    cc.read_records(own, fl, bd)):
        assert torch.equal(a, b)
    for lanes, red in cc.variants("stiffness_accel"):
        n0 = dict(cc.LAUNCHES)
        got = cc.record_pass_cuda("stiffness_accel", fl, bd, islots, dims,
                                  dims_b, CFG, lanes=lanes, reduction=red,
                                  unroll=unroll, records=shared)
        lam = cc.record_pass_cuda("pbd_lambda", lfl, lbd, lslots, ldims,
                                  ldims_b, CFG, lanes=lanes, reduction=red,
                                  unroll=unroll, records=shared)
        assert cc.LAUNCHES["pack_positions"] == n0["pack_positions"]
        fresh = cc.record_pass_cuda("stiffness_accel", fl, bd, islots, dims,
                                    dims_b, CFG, lanes=lanes, reduction=red,
                                    unroll=unroll)
        torch.cuda.synchronize()
        assert cc.LAUNCHES["pack_positions"] == n0["pack_positions"] + 1
        assert torch.equal(got, fresh), (lanes, red)
        assert torch.equal(got, cc.particle_pass_cuda(
            "stiffness_accel", fl, bd, islots, dims, dims_b, CFG,
            lanes=lanes, reduction=red))
        assert torch.equal(lam, cc.particle_pass_cuda(
            "pbd_lambda", lfl, lbd, lslots, ldims, ldims_b, CFG, lanes=lanes,
            reduction=red))


def test_shared_pack_is_packed_once_by_column_pass(projection_operands):
    """passes.column_pass packs a SharedPack at the first counted pass that
    takes it, and the second walks that pack: one pack launch, two walks,
    each pass bitwise its walk on its own pack."""
    (lfl, lbd, ldims, ldims_b, lslots), (fl, bd, dims, dims_b, islots) = \
        projection_operands
    pack = pp.SharedPack()
    n0 = dict(cc.LAUNCHES)
    lam = pp.pbd_lambda_pass(lfl, lbd, ldims, ldims_b, CFG, islots=lslots,
                             records=pack)
    sa = pp.stiffness_accel_pass(fl, bd, dims, dims_b, CFG, islots=islots,
                                 records=pack)
    torch.cuda.synchronize()
    assert pack.records is not None
    assert {k: cc.LAUNCHES[k] - n0[k] for k in cc.LAUNCHES
            if cc.LAUNCHES[k] != n0[k]} == {
        "pack_positions": 1, "record_pbd_lambda": 1,
        "record_stiffness_accel": 1}
    assert torch.equal(lam, cc.record_pass_cuda("pbd_lambda", lfl, lbd,
                                                lslots, ldims, ldims_b, CFG))
    assert torch.equal(sa, cc.record_pass_cuda("stiffness_accel", fl, bd,
                                               islots, dims, dims_b, CFG))


@pytest.mark.parametrize("unroll", cc.COUNTED_UNROLLS)
def test_counted_stiffness_accel_is_exactly_zero_at_zero_lambda(
        projection_operands, unroll):
    """PBD's exact all-lambda-zero exit needs the counted walk to store +-0
    where no pair contributes, at every variant."""
    _, (fl, bd, dims, dims_b, islots) = projection_operands
    zero = fl.clone()
    zero[4] = 0.0
    for lanes, red in cc.variants("stiffness_accel"):
        out = cc.record_pass_cuda("stiffness_accel", zero, bd, islots, dims,
                                  dims_b, CFG, lanes=lanes, reduction=red,
                                  unroll=unroll)
        assert not bool(out.any()), (lanes, red)


@pytest.mark.parametrize("unroll", cc.COUNTED_UNROLLS)
def test_counted_pressure_force_is_exactly_zero_at_zero_pressure(operands,
                                                                 unroll):
    """At p = 0 every pressure_force term is +-0, fluid and boundary
    alike: the counted walk stores +-0 at every listed slot, at every
    variant, bitwise the particle-list kernel."""
    _, fl, bd, dims, dims_b, islots = operands["pressure_force"]
    zero = fl.clone()
    zero[5] = 0.0
    for lanes, red in cc.variants("pressure_force"):
        out = cc.record_pass_cuda("pressure_force", zero, bd, islots, dims,
                                  dims_b, CFG, lanes=lanes, reduction=red,
                                  unroll=unroll)
        assert not bool(out.any()), (lanes, red)
        assert torch.equal(out, cc.particle_pass_cuda(
            "pressure_force", zero, bd, islots, dims, dims_b, CFG,
            lanes=lanes, reduction=red)), (lanes, red)


@pytest.mark.parametrize("unroll", cc.COUNTED_UNROLLS)
def test_counted_walk_stores_nothing_at_a_listed_padding_slot(
        projection_operands, operands, unroll):
    """The counted pack writes no record for a padding slot; the walk tells
    by its operand's row 0 whether a listed slot holds a particle, as the
    particle-list kernel does: on a list of every slot (padding slots
    included) over a pack whose unwritten records hold NaN, every counted
    pass (PBD's two on a projection iteration's operands, the surface-off
    pressure_force and density_alpha on their steps') is bitwise the
    particle-list kernel at every variant."""
    cases = list(zip(("pbd_lambda", "stiffness_accel"), projection_operands))
    cases += [(n, operands[n][1:]) for n in ("pressure_force",
                                             "density_alpha")]
    assert sorted(n for n, _ in cases) == sorted(cc.COUNTED)
    for name, (fl, bd, dims, dims_b, _) in cases:
        every = torch.arange(dims.k * dims.g, dtype=torch.int64,
                             device=fl.device)
        recs = cc.pack_records(name, fl, bd, dims, dims_b, CFG)
        real = fl[0].t().reshape(-1) < POS_PAD / 2  # record order c*K + s
        assert not bool(real.all())
        poisoned = recs.geo.clone()
        poisoned[~real] = float("nan")
        recs = recs._replace(geo=poisoned)
        for lanes, red in cc.variants(name):
            got = cc.record_pass_cuda(name, fl, bd, every, dims, dims_b, CFG,
                                      lanes=lanes, reduction=red,
                                      unroll=unroll, records=recs)
            assert torch.equal(got, cc.particle_pass_cuda(
                name, fl, bd, every, dims, dims_b, CFG, lanes=lanes,
                reduction=red)), (name, lanes, red)
