"""The PyTorch port's config and scene builders against the JAX package.

The config is a copy, not an import (the JAX package's ``__init__`` pulls in
jax), so every field and default must stay equal. Scene positions must be
bitwise equal: the array order is the particle identity (state.py:50-53).
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu import config as jcfg

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch import config as tcfg

torch.set_num_threads(2)

PORT_DIR = pathlib.Path(T.__file__).resolve().parent


def test_config_fields_and_defaults_equal():
    jf = {f.name: f for f in dataclasses.fields(jcfg.SimConfig)}
    tf = {f.name: f for f in dataclasses.fields(tcfg.SimConfig)}
    assert list(jf) == list(tf)
    for name, f in jf.items():
        assert tf[name].default == f.default, name
        assert tf[name].type == f.type, name
    assert tcfg.FAST_MODE_FLAGS == jcfg.FAST_MODE_FLAGS
    assert tcfg.BENCH_DT == jcfg.BENCH_DT
    assert tcfg.PI == jcfg.PI


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_dam_break_config_equal(mode):
    j = jcfg.dam_break_config(mode=mode, space_size=(0.52, 0.52, 0.52))
    t = tcfg.dam_break_config(mode=mode, space_size=(0.52, 0.52, 0.52))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    # the derived quantities the passes read
    for attr in ("rho0", "m0", "cell_size"):
        assert getattr(t, attr) == getattr(j, attr), attr


SCENES = {
    "dam_break": lambda m: m.dam_break_positions(m.dam_break_config()),
    "boundary": lambda m: m.boundary_positions(m.dam_break_config()),
    "boundary_small": lambda m: m.boundary_positions(
        m.dam_break_config(space_size=(0.52, 0.52, 0.52))),
    "block": lambda m: m.block_positions((0.1, 0.2, 0.3), (5, 4, 3), 0.02),
    "scaled_dam": lambda m: m.scaled_dam_scene(3000)[1],
    "drop": lambda m: m.drop_scene()[1],
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_scene_positions_bitwise(scene):
    a, b = SCENES[scene](J), SCENES[scene](T)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(b, a)


def test_reference_scene_sizes():
    cfg = T.dam_break_config()
    assert T.dam_break_positions(cfg).shape == (20736, 3)
    assert T.boundary_positions(cfg).shape == (14408, 3)


def test_make_fluid_state_matches():
    cfg = T.dam_break_config(space_size=(0.52, 0.52, 0.52))
    pos = T.block_positions((0.1, 0.1, 0.1), (3, 4, 5), cfg.spacing)
    js = J.make_fluid_state(pos, J.dam_break_config(
        space_size=(0.52, 0.52, 0.52)))
    ts = T.make_fluid_state(pos, cfg, "cpu")
    assert ts._fields == js._fields
    for name in ts._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name)
        assert b.dtype == torch.float32 and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), a)


def test_same_public_names():
    assert set(T.__all__) == set(J.__all__)


def test_port_imports_with_jax_blocked():
    """Importing every module of the port succeeds in a fresh interpreter
    where ``import jax`` fails."""
    mods = sorted(
        "cpp_fluid_particles_tpu_torch." + ".".join(
            p.relative_to(PORT_DIR).with_suffix("").parts)
        for p in PORT_DIR.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['cpp_fluid_particles_tpu'] = None; "
            "import importlib, cpp_fluid_particles_tpu_torch; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            "assert 'jax.numpy' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(PORT_DIR.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_in_port_sources():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax\b|"
                     r"(import|from)\s+cpp_fluid_particles_tpu(\.|\s|$))",
                     re.M)
    for p in PORT_DIR.rglob("*.py"):
        assert not pat.search(p.read_text()), p
