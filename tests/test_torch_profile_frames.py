"""The frame profiler's bookkeeping (cpp_fluid_particles_tpu_torch/exp/
profile_frames.py) on the CPU: how it names a device event's kernel group,
sums the device's busy time and builds the surface-off config. The profile
itself needs a card."""

import pytest
import torch

from cpp_fluid_particles_tpu_torch.config import dam_break_config
from cpp_fluid_particles_tpu_torch.exp import profile_frames as pf

torch.set_num_threads(2)


@pytest.mark.parametrize("name, want", [
    ("void (anonymous namespace)::particle_pass_kernel<(anonymous "
     "namespace)::PbdLambdaPass, 16>(float const*, float const*, long "
     "const*, float*, int, int, int, int, int, int, (anonymous "
     "namespace)::Consts)", "particle_pbd_lambda"),
    ("void (anonymous namespace)::particle_pass_kernel<(anonymous "
     "namespace)::StiffnessAccelPass, 8>(...)", "particle_stiffness_accel"),
    ("void (anonymous namespace)::particle_pass_kernel<(anonymous "
     "namespace)::DensityColorgradViscPass, 8, true>(float const*, float "
     "const*, long const*, float*, int, int, int, int, int, int, (anonymous "
     "namespace)::Consts)", "particle_density_colorgrad_visc"),
    ("void (anonymous namespace)::particle_pass_kernel<(anonymous "
     "namespace)::DensityViscPass, 32, false>(...)", "particle_density_visc"),
    ("void (anonymous namespace)::particle_pass_kernel<(anonymous "
     "namespace)::DensityAlphaColorgradPass, 16, true>(...)",
     "particle_density_alpha_colorgrad"),
    ("void (anonymous namespace)::particle_pass_kernel<(anonymous "
     "namespace)::PressureForcePass, 8, false>(...)",
     "particle_pressure_force"),
    ("void (anonymous namespace)::particle_pass_kernel<(anonymous "
     "namespace)::DensityAlphaPass, 32, true>(...)", "particle_density_alpha"),
    ("void (anonymous namespace)::particle_pass_kernel<(anonymous "
     "namespace)::XsphPass, 32, true>(...)", "particle_xsph"),
    ("void (anonymous namespace)::particle_pass_kernel<(anonymous "
     "namespace)::DensityPass, 32, false>(...)", "particle_density"),
    ("void (anonymous namespace)::column_pass_kernel<(anonymous "
     "namespace)::DensityPass>(...)", "column_density"),
    ("void (anonymous namespace)::column_pass_kernel<(anonymous "
     "namespace)::XsphColorgradPass>(...)", "column_xsph_colorgrad"),
    ("void (anonymous namespace)::column_pass_kernel<(anonymous "
     "namespace)::SurfacePass>(...)", "column_surface"),
    ("void (anonymous namespace)::record_pass_kernel<(anonymous "
     "namespace)::SurfacePressurePass, 8, false, 2>((anonymous namespace)::"
     "Records<(anonymous namespace)::SurfacePressurePass>, long const*, "
     "float*, int, int, int, int, int, int, (anonymous namespace)::Consts)",
     "record_surface_pressure"),
    ("void (anonymous namespace)::record_pass_kernel<(anonymous "
     "namespace)::SurfacePass, 8, true, 1>(...)", "record_surface"),
    ("void (anonymous namespace)::pack_kernel<(anonymous "
     "namespace)::SurfacePressurePass>(float const*, float const*, float4*, "
     "(anonymous namespace)::SurfacePressurePass::J*, float4*, int, int, "
     "long, (anonymous namespace)::Consts)", "pack_surface_pressure"),
    ("void (anonymous namespace)::pack_kernel<(anonymous "
     "namespace)::SurfacePass>(...)", "pack_surface"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "other"),
    ("Memset (Device)", "other"),
])
def test_device_events_fall_into_kernel_groups(name, want):
    assert pf.group(name) == want


def test_busy_time_is_the_union_of_device_intervals():
    # us intervals: two overlapping, one nested, one apart -> 0.030 ms
    assert pf.union_ms([(0, 10), (5, 15), (6, 7), (40, 55)]) == 0.030
    assert pf.union_ms([]) == 0.0


def test_profile_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the profile would run")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        pf.main(["--windows", "2", "--frames", "1"])


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_surface_flag_builds_the_surface_off_config(mode):
    """--surface off is the dam's config in that mode with surface tension
    and air pressure 0, so every step takes its surface-off passes;
    --surface on (the default) is the config unchanged."""
    on = pf.make_config(mode)
    assert on == pf.make_config(mode, "on") == dam_break_config(mode)
    assert on.surface_tension > on.epsilon or on.air_pressure > on.epsilon
    off = pf.make_config(mode, "off")
    assert off == on.replace(surface_tension=0.0, air_pressure=0.0)
    assert not (off.surface_tension > off.epsilon
                or off.air_pressure > off.epsilon)


def test_surface_flag_parses_and_defaults_to_on():
    ap = pf.build_argparser()
    assert ap.parse_args([]).surface == "on"
    assert ap.parse_args(["--surface", "off"]).surface == "off"
    with pytest.raises(SystemExit):
        ap.parse_args(["--surface", "maybe"])
