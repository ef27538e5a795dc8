#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
hand-written neighbor-pass kernel (cpp_fluid_particles_tpu_torch/csrc/
column_pass.cu) with nvcc, holds each kernel instance against the plain
torch executor on the card, then drives the port's main path —
``Simulation(solver="wcsph", cfg=dam_break_config(mode="parity"),
device="cuda")`` on the full 20,736-particle dam — for 300 frames at the
reference benchmark's dt, and checks that every frame went through the
kernel. Phases:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc build of the kernel, seconds taken
  3. kernel   each pass instance vs ``column_pass_plain`` on the operands
              the main path gives it, at frame 0 and after phase 5;
              per-row tolerance rtol 2e-5, atol 2e-5 x the row's max;
              two launches must agree bitwise
  4. step     one wcsph_step with the kernel vs with the plain executor
              (pos atol 2e-6, vel atol 2e-3), and the drift after 5 steps
  5. slice    300 frames through the constructor, run() and run_scan();
              physics and launch-count checks, ms/frame from CUDA events
  6. timing   kernel vs plain executor per pass at the phase-5 shapes

Each phase prints one line. Before the last line it prints the JSON kernel
table; the last line is ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without that line. JAX is not imported. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FRAMES = 300
CHUNK = 25
PASS_BAR = 2e-5          # pass outputs: rtol, and atol x the row's max
STEP_POS_ATOL = 2e-6
STEP_VEL_ATOL = 2e-3
TPU_KERNEL = "cpp_fluid_particles_tpu/ops/pallas_passes.py:107"
KERNEL_SRC = "cpp_fluid_particles_tpu_torch/csrc/column_pass.cu"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def import_port():
    """The port from THIS checkout, never from elsewhere on the path."""
    sys.path.insert(0, str(ROOT))
    import cpp_fluid_particles_tpu_torch as cfp
    if Path(cfp.__file__).resolve().parent.parent != ROOT:
        raise RuntimeError(f"imported the port from {cfp.__file__}, not "
                           f"from {ROOT}")
    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    return cfp


class Recorder:
    """An executor that records the operands of every pass and runs the
    plain executor on them."""

    def __init__(self, plain):
        self.plain = plain
        self.calls = []

    def __call__(self, name, fl, bd, dims, dims_b, cfg):
        self.calls.append((name, fl, bd, dims, dims_b))
        return self.plain(name, fl, bd, dims, dims_b, cfg)


def capture(sim, ds, pp, dt):
    """The operands the main path gives each pass instance: the scene
    build's density pass, and one WCSPH step's two passes from sim.state."""
    from cpp_fluid_particles_tpu_torch.state import boundary_positions
    rec = Recorder(pp.column_pass_plain)
    ds.build_dense_scene(sim.cfg, boundary_positions(sim.cfg), sim._kb,
                         sim.device, executor=rec)
    dims, dims_b = sim._dims()
    ds.wcsph_step(sim.state, (), sim.scene, sim.cfg, dt, dims, dims_b,
                  sim.box, executor=rec)
    return rec.calls


def compare_passes(tag, calls, cfg, pp, cc, torch, errs):
    for name, fl, bd, dims, dims_b in calls:
        want = pp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)
        got = cc.column_pass_cuda(name, fl, bd, dims, dims_b, cfg)
        again = cc.column_pass_cuda(name, fl, bd, dims, dims_b, cfg)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{tag} {name}: two launches differ")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag} {name}: non-finite output")
        diff = (got - want).abs()
        worst_rel = 0.0
        for r in range(want.shape[0]):
            scale = float(want[r].abs().max()) + 1e-12
            bound = PASS_BAR * want[r].abs() + PASS_BAR * scale
            if not bool((diff[r] <= bound).all()):
                raise AssertionError(
                    f"{tag} {name} row {r}: max err {float(diff[r].max())} "
                    f"over the bar (row max {scale})")
            worst_rel = max(worst_rel, float(diff[r].max()) / scale)
        max_abs = float(diff.max())
        e = errs.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
        e["max_abs_err"] = max(e["max_abs_err"], max_abs)
        e["max_rel_err"] = max(e["max_rel_err"], worst_rel)
        log("kernel", f"{tag} {name} K={dims.k} Kb={dims_b.k} "
            f"grid={dims.gx}x{dims.gy}x{dims.gz} max_abs_err={max_abs:.3e} "
            f"max_err/row_max={worst_rel:.3e} bitwise_repeat=yes")


def step_vs_plain(sim, ds, pp, torch, dt, n_drift=5):
    dims, dims_b = sim._dims()

    def run(executor, n):
        st = sim.state
        for _ in range(n):
            st, _, _ = ds.wcsph_step(st, (), sim.scene, sim.cfg, dt, dims,
                                     dims_b, sim.box, executor=executor)
        return st

    a, b = run(None, 1), run(pp.column_pass_plain, 1)
    dpos = float((a.pos - b.pos).abs().max())
    dvel = float((a.vel - b.vel).abs().max())
    if not (dpos <= STEP_POS_ATOL and dvel <= STEP_VEL_ATOL):
        raise AssertionError(f"step: kernel vs plain dpos={dpos} "
                             f"dvel={dvel} over the bars")
    a, b = run(None, n_drift), run(pp.column_pass_plain, n_drift)
    log("step", f"one step kernel vs plain: dpos={dpos:.3e} (bar "
        f"{STEP_POS_ATOL}) dvel={dvel:.3e} (bar {STEP_VEL_ATOL}); after "
        f"{n_drift} steps: dpos={float((a.pos - b.pos).abs().max()):.3e} "
        f"dvel={float((a.vel - b.vel).abs().max()):.3e}")


def time_ms(fn, torch, reps, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cfp = import_port()
    from cpp_fluid_particles_tpu_torch.models import dense_step as ds
    from cpp_fluid_particles_tpu_torch.ops import column_pass_cuda as cc
    from cpp_fluid_particles_tpu_torch.ops import passes as pp

    record = {"torch": torch.__version__, "cuda": torch.version.cuda}
    # 1. device
    card = smi()
    kind = torch.cuda.get_device_name(0)
    record["nvidia_smi"] = card
    log("device", f"{card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    lib = cc.build()
    cc._library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    record["build_s"], record["ptxas"] = build_s, ptxas
    log("build", f"{KERNEL_SRC} -> {lib.name} in {build_s:.1f} s; "
        + "; ".join(ln for ln in ptxas if "registers" in ln))

    cfg = cfp.dam_break_config(mode="parity")
    dt = cfp.BENCH_DT["wcsph"]
    errs = {}

    # 3 + 4 at frame 0 (the state after the constructor's warm-up step)
    probe = cfp.Simulation(solver="wcsph", cfg=cfg, device="cuda")
    compare_passes("frame0", capture(probe, ds, pp, dt), cfg, pp, cc,
                   torch, errs)
    step_vs_plain(probe, ds, pp, torch, dt)
    del probe

    # 5. the slice
    cc.reset_launch_counts()
    t_run = time.perf_counter()
    sim = cfp.Simulation(solver="wcsph", cfg=cfg, device="cuda")
    y0 = float(torch.as_tensor(cfp.dam_break_positions(cfg))[:, 1].mean())
    rerun_frames = 1 + sim.retries               # warm-up step + retries
    r0 = sim.retries
    stats = sim.run(CHUNK, dt)
    rerun_frames += CHUNK + (sim.retries - r0)
    step_ms = stats["ms_per_frame"] * CHUNK
    scan_ms = 0.0
    chunks = []                  # per chunk: last frame, ms/frame, K, box
    for _ in range((FRAMES - CHUNK) // CHUNK):
        r0 = sim.retries
        ms = sim.run_scan(CHUNK, dt)
        scan_ms += ms * CHUNK
        rerun_frames += CHUNK * (1 + sim.retries - r0)
        chunks.append([sim.frame, ms, sim.max_per_cell, list(sim.box)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_run
    launches = dict(cc.LAUNCHES)

    pos = sim.state.pos
    space = torch.tensor(cfg.space_size, device=pos.device)
    if sim.frame != FRAMES:
        raise AssertionError(f"ran {sim.frame} frames, not {FRAMES}")
    if not bool(torch.isfinite(pos).all()):
        raise AssertionError("non-finite positions")
    if not bool(((pos >= 0) & (pos <= 0.99 * space)).all()):
        raise AssertionError("positions outside [0, 0.99*space]")
    y1 = float(pos[:, 1].mean())
    if not y1 < y0:
        raise AssertionError(f"mean y did not decrease: {y0} -> {y1}")
    if sim.dropped_frames != 0:
        raise AssertionError(f"dropped_frames={sim.dropped_frames}")
    # each frame run (warm-up, retries included) launches both WCSPH
    # passes once: 2 x rerun_frames main-path launches, plus the scene
    # build's one density launch
    if (launches["density_colorgrad_visc"] != rerun_frames
            or launches["surface_pressure"] != rerun_frames
            or launches["density"] != 1):
        raise AssertionError(f"launch counts {launches}; expected "
                             f"{rerun_frames} per WCSPH pass and 1 density")
    ms_frame = (step_ms + scan_ms) / FRAMES
    record["slice"] = {
        "frames": FRAMES, "dt": dt, "fluid": sim.fluid_size,
        "boundary": sim.boundary_size, "K": sim.max_per_cell,
        "box": list(sim.box), "retries": sim.retries,
        "dropped_frames": sim.dropped_frames, "launches": launches,
        "ms_per_frame": ms_frame, "ms_per_frame_step": step_ms / CHUNK,
        "ms_per_frame_run_scan": scan_ms / (FRAMES - CHUNK),
        "wall_s": wall_s, "mean_y": [y0, y1], "run_scan_chunks": chunks}
    log("slice", f"{sim.fluid_size} fluid + {sim.boundary_size} boundary, "
        f"{FRAMES} frames at dt {dt}: K={sim.max_per_cell} box={sim.box} "
        f"retries={sim.retries} dropped_frames=0 mean_y {y0:.4f}->{y1:.4f} "
        f"launches={launches} | {ms_frame:.3f} ms/frame (CUDA events; "
        f"step() {step_ms / CHUNK:.3f}, run_scan "
        f"{scan_ms / (FRAMES - CHUNK):.3f}) wall {wall_s:.1f} s | {card}")

    # 3 (post-impact) and 6 at the phase-5 shapes
    calls = capture(sim, ds, pp, dt)
    compare_passes(f"frame{FRAMES}", calls, cfg, pp, cc, torch, errs)
    times = {}
    for name, fl, bd, dims, dims_b in calls:
        def kern():
            cc.column_pass_cuda(name, fl, bd, dims, dims_b, cfg)

        def plain():
            pp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)
        # plain, kernel, kernel, plain: compared within one call
        p1 = time_ms(plain, torch, 5)
        k1 = time_ms(kern, torch, 50)
        k2 = time_ms(kern, torch, 50)
        p2 = time_ms(plain, torch, 5)
        times[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                       "runs_ms": [p1, k1, k2, p2],
                       "grid": [dims.gx, dims.gy, dims.gz], "K": dims.k,
                       "Kb": dims_b.k}
        log("timing", f"{name} K={dims.k} grid={dims.gx}x{dims.gy}x"
            f"{dims.gz}: kernel {min(k1, k2):.4f} ms, plain "
            f"{min(p1, p2):.4f} ms (plain,kernel,kernel,plain = "
            f"{p1:.4f},{k1:.4f},{k2:.4f},{p2:.4f}) | {card}")
    record["times"], record["errors"] = times, errs

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SRC,
         "replaces": TPU_KERNEL, "launches": launches[name],
         "max_abs_err": errs[name]["max_abs_err"],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"]}
        for name in cc.PASS_IDS]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(dict(record, table=table), indent=1))
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
