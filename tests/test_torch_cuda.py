"""The hand-written CUDA neighbor-pass kernel on the card.

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
from cpp_fluid_particles_tpu_torch.models import dense_step as ds
from cpp_fluid_particles_tpu_torch.ops import column_pass_cuda as cc
from cpp_fluid_particles_tpu_torch.ops import passes as pp

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
    """The operands the main path gives each pass: the scene build's
    density pass and one WCSPH step's two passes."""
    calls = []

    def record(name, fl, bd, dims, dims_b, cfg):
        calls.append((name, fl, bd, dims, dims_b))
        return pp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)

    sim = T.Simulation(solver="wcsph", cfg=CFG, fluid_pos=_block(),
                       device=dev)
    sim.run(3)
    ds.build_dense_scene(CFG, T.boundary_positions(CFG), sim._kb, dev,
                         executor=record)
    dims, dims_b = sim._dims()
    ds.wcsph_step(sim.state, (), sim.scene, CFG, CFG.dt, dims, dims_b,
                  sim.box, executor=record)
    return {c[0]: c for c in calls}


@pytest.mark.parametrize("name", list(cc.PASS_IDS))
def test_kernel_matches_plain_and_repeats_bitwise(operands, name):
    _, fl, bd, dims, dims_b = operands[name]
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
    name, fl, bd, dims, dims_b = operands["density_colorgrad_visc"]
    with pytest.raises(ValueError, match="float32"):
        cc.column_pass_cuda(name, fl.double(), bd, dims, dims_b, CFG)
    with pytest.raises(ValueError, match="contiguous"):
        cc.column_pass_cuda(name, fl.transpose(1, 2).contiguous()
                            .transpose(1, 2), bd, dims, dims_b, CFG)
    with pytest.raises(ValueError, match="shape"):
        cc.column_pass_cuda(name, fl[:4].contiguous(), bd, dims, dims_b,
                            CFG)


def test_simulation_runs_through_the_kernel(dev):
    """The same frames on the card and on the CPU agree at the one-step
    bars after 3 frames, and the card's frames all launched the kernel."""
    cc.reset_launch_counts()
    gpu = T.Simulation(solver="wcsph", cfg=CFG, fluid_pos=_block(),
                       device=dev)
    gpu.run(3)
    frames = 4 + gpu.retries                    # warm-up + 3 + retries
    assert cc.LAUNCHES == {"density": 1, "density_colorgrad_visc": frames,
                           "surface_pressure": frames}
    cpu = T.Simulation(solver="wcsph", cfg=CFG, fluid_pos=_block(),
                       device="cpu")
    cpu.run(3)
    assert gpu.config_key == cpu.config_key
    np.testing.assert_allclose(gpu.state.pos.cpu().numpy(),
                               cpu.state.pos.numpy(), atol=2e-6)
    np.testing.assert_allclose(gpu.state.vel.cpu().numpy(),
                               cpu.state.vel.numpy(), atol=2e-3)
