"""The frozen-operand timer's bookkeeping (cpp_fluid_particles_tpu_torch/
exp/pass_state.py) on the CPU, on a small block of the dam's config: the
operands it captures are the ones the step hands the pass (the slot list
in the step's order for that pass), and they round-trip through its npz
bitwise with their shapes and config. The timing itself needs a card."""

import pytest
import torch

import cpp_fluid_particles_tpu_torch as cft
from cpp_fluid_particles_tpu_torch.exp import pass_state as ps
from cpp_fluid_particles_tpu_torch.ops import box as bx
from cpp_fluid_particles_tpu_torch.ops import passes as pp

torch.set_num_threads(2)


@pytest.mark.parametrize("solver, name", ps.CASES)
def test_capture_round_trips_the_steps_operands(tmp_path, solver, name):
    cfg = cft.dam_break_config("parity")
    pos = cft.block_positions((0.3, 0.1, 0.3), (6, 6, 6), cfg.spacing)
    sim = cft.Simulation(solver=solver, cfg=cfg, fluid_pos=pos,
                         device="cpu")
    dt = cft.BENCH_DT[solver]
    sim.run_scan(2, dt)
    before = sim.state.pos.clone()
    case = ps.capture(sim, name, dt)
    assert torch.equal(sim.state.pos, before)
    dims = case["dims"]
    assert case["name"] == name and case["cfg"] == sim.cfg
    assert tuple(case["fl"].shape) == (pp.PASSES[name].fi, dims.k, dims.g)
    assert (case["bd"] is not None) == pp.PASSES[name].has_bd
    idx = bx.build_box_index(sim.state.pos, sim.cfg, sim._dims()[0], dims)
    # the WCSPH step hands surface_pressure the particles' order, the
    # other steps their passes the cell-major work list
    want = idx.slots if name == "surface_pressure" else idx.work
    assert torch.equal(case["islots"], want)
    ps.save_case(tmp_path / "case.npz", case)
    got = ps.load_case(tmp_path / "case.npz", "cpu")
    assert got["name"] == name and got["cfg"] == case["cfg"]
    assert got["dims"] == dims and got["dims_b"] == case["dims_b"]
    for key in ("fl", "bd", "islots"):
        if case[key] is None:
            assert got[key] is None
        else:
            assert got[key].dtype == case[key].dtype
            assert torch.equal(got[key], case[key])
    out = pp.column_pass_plain(name, got["fl"], got["bd"], got["dims"],
                               got["dims_b"], got["cfg"])
    assert torch.isfinite(out).all() and out.abs().max() > 0


def test_time_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        ps.main(["time", "--state", str(tmp_path), "--out", str(tmp_path)])
