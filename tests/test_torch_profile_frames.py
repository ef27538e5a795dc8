"""The frame profiler's bookkeeping (cpp_fluid_particles_tpu_torch/exp/
profile_frames.py) on the CPU: how it names a device event's kernel group
and sums the device's busy time. The profile itself needs a card."""

import pytest
import torch

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
    ("void (anonymous namespace)::column_pass_kernel<(anonymous "
     "namespace)::DensityPass>(...)", "column_density"),
    ("void (anonymous namespace)::column_pass_kernel<(anonymous "
     "namespace)::XsphColorgradPass>(...)", "column_xsph_colorgrad"),
    ("void (anonymous namespace)::column_pass_kernel<(anonymous "
     "namespace)::SurfacePass>(...)", "column_surface"),
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
