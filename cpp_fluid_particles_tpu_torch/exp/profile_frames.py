"""Where a frame's device time goes, per window of frames of the dam.

    python -m cpp_fluid_particles_tpu_torch.exp.profile_frames \\
        [--solver pbd|dfsph|wcsph] [--mode parity|fast] [--surface on|off] \\
        [--windows 101 251] [--frames 25] [--out DIR]

Runs ``Simulation(solver, cfg=dam_break_config(mode), device="cuda")`` on
the 20,736-particle dam at the reference's dt (``BENCH_DT``) up to the
frame before each window, then runs the window's frames from the same
state three times: twice timed by CUDA events (``run_scan``, one chunk),
once under ``torch.profiler``. ``--surface off`` sets surface tension and
air pressure to 0 (``make_config``), so the steps take their surface-off
passes. Each window prints one line and one JSON record (also written to
``DIR/profile_<solver>_<mode>.json``, ``..._surface_off.json`` with
``--surface off``):

  * ms/frame of the two timed runs, and of the profiled run;
  * solver iterations and host syncs per frame (DFSPH: divergence and
    density iterations; PBD: projection iterations);
  * device busy ms per frame: the union of the device intervals (kernels,
    memsets, copies) the profiler recorded; busy share: that over the
    faster unprofiled ms/frame;
  * device ms per frame of each kernel group (the particle-list kernel,
    the column kernel, the record kernel and its pack, each per pass, the
    counted walk with the record kernel as ``record_<pass>`` and its
    position pack as ``pack_positions``, as the launch counters count
    them; everything else) and the device ops per frame.

K and the box are whatever the run reached; a window whose runs refit
either is flagged (``refit``) because its frames then ran at other shapes.
Needs a card: the profile is of device time, which the CPU has not got.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from pathlib import Path

import torch

from ..config import BENCH_DT, dam_break_config
from ..simulation import Simulation

ITER_KEYS = ("pbd_iters", "divergence_iters", "density_iters", "host_syncs")
CHUNK = 25
# kernel functor in a device event's name -> pass
FUNCTORS = {"PbdLambdaPass": "pbd_lambda",
            "StiffnessAccelPass": "stiffness_accel",
            "DivergencePass": "divergence",
            "XsphColorgradPass": "xsph_colorgrad", "XsphPass": "xsph",
            "SurfacePass": "surface",
            "DensityAlphaColorgradPass": "density_alpha_colorgrad",
            "ViscosityPass": "viscosity",
            "DensityColorgradViscPass": "density_colorgrad_visc",
            "SurfacePressurePass": "surface_pressure",
            "DensityViscPass": "density_visc",
            "PressureForcePass": "pressure_force",
            "DensityAlphaPass": "density_alpha", "DensityPass": "density"}


def make_config(mode: str, surface: str = "on"):
    """The dam's config in ``mode``; surface "off": surface tension and air
    pressure 0."""
    cfg = dam_break_config(mode)
    return (cfg if surface == "on"
            else cfg.replace(surface_tension=0.0, air_pressure=0.0))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# kernel -> its group's prefix: the counted walk's with the record
# kernel's, as the launch counters count them (record_<pass>)
GROUPS = {"particle_pass_kernel": "particle", "column_pass_kernel": "column",
          "record_pass_kernel": "record", "counted_pass_kernel": "record",
          "pack_kernel": "pack"}


def group(name: str) -> str:
    """A device event's name -> its kernel group; the position pack that
    pbd_lambda and stiffness_accel share, ``pack_positions``."""
    if "count_pack_kernel" in name:
        return "pack_positions"
    for kernel, prefix in GROUPS.items():
        if kernel in name:
            m = re.search(r"::(\w+Pass)\b", name)
            what = FUNCTORS.get(m.group(1), m.group(1)) if m else "?"
            return f"{prefix}_{what}"
    return "other"


def union_ms(intervals) -> float:
    """Length of the union of (start, end) intervals in us, as ms."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


class Tally:
    """Wraps a Simulation's step to keep each frame's iteration metrics."""

    def __init__(self, sim: Simulation):
        self.frames = []
        step = sim._step_fn

        def tallied(*args, **kwargs):
            out = step(*args, **kwargs)
            self.frames.append({k: out[2][k] for k in ITER_KEYS
                                if k in out[2]})
            return out
        sim._step_fn = tallied

    def per_frame(self):
        keys = self.frames[0].keys() if self.frames else ()
        return {k: float(torch.stack([f[k] for f in self.frames])
                         .float().mean()) for k in keys}


def snapshot(sim):
    return (sim.state, sim.carry, sim.max_per_cell, sim.box,
            sim._down_votes, sim.frame, sim.retries)


def restore(sim, snap):
    (sim.state, sim.carry, sim.max_per_cell, sim.box, sim._down_votes,
     sim.frame, sim.retries) = snap


def profile_window(sim, tally, frames: int, dt: float) -> dict:
    """The window's frames from the current state, three times."""
    snap = snapshot(sim)
    shapes = (sim.max_per_cell, sim.box)
    timed, refit = [], False
    for _ in range(2):
        restore(sim, snap)
        timed.append(sim.run_scan(frames, dt))
        refit |= (sim.max_per_cell, sim.box) != shapes \
            or sim.retries != snap[-1]
    restore(sim, snap)
    tally.frames.clear()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled = sim.run_scan(frames, dt)
        torch.cuda.synchronize()
    refit |= (sim.max_per_cell, sim.box) != shapes
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {}
    for e in dev:
        g = group(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = union_ms([(e.time_range.start, e.time_range.end) for e in dev])
    rec = {"first_frame": snap[5] + 1, "frames": frames,
           "K": shapes[0], "box": list(shapes[1]), "refit": refit,
           "ms_per_frame": timed, "profiled_ms_per_frame": profiled,
           **tally.per_frame(),
           "device_busy_ms_per_frame": busy / frames if dev else None,
           "busy_share": busy / frames / min(timed) if dev else None,
           "device_ops_per_frame": len(dev) / frames,
           "group_ms_per_frame": {g: v / frames
                                  for g, v in sorted(groups.items())}}
    restore(sim, snap)
    return rec


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--solver", default="pbd",
                    choices=("pbd", "dfsph", "wcsph"))
    ap.add_argument("--mode", default="parity", choices=("parity", "fast"))
    ap.add_argument("--surface", default="on", choices=("on", "off"))
    ap.add_argument("--windows", type=int, nargs="+", default=[101, 251])
    ap.add_argument("--frames", type=int, default=CHUNK)
    ap.add_argument("--out", default="chiprun_out")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_frames needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    dt = BENCH_DT[args.solver]
    sim = Simulation(solver=args.solver,
                     cfg=make_config(args.mode, args.surface), device="cuda")
    tag = args.mode + ("" if args.surface == "on" else " surface off")
    tally = Tally(sim)
    smi = card()
    records = []
    for first in sorted(args.windows):
        while sim.frame < first - 1:
            sim.run_scan(min(CHUNK, first - 1 - sim.frame), dt)
        rec = profile_window(sim, tally, args.frames, dt)
        rec.update(solver=args.solver, mode=args.mode, card=smi)
        if args.surface == "off":
            rec["surface"] = "off"
        records.append(rec)
        iters = ", ".join(f"{k} {rec[k]:.2f}" for k in ITER_KEYS if k in rec)
        busy = rec["device_busy_ms_per_frame"]
        print(f"[profile] {args.solver} {tag} frames {first}-"
              f"{first + args.frames - 1}, K {rec['K']}, box "
              f"{tuple(rec['box'])}{' (refit)' if rec['refit'] else ''}: "
              f"ms/frame {rec['ms_per_frame'][0]:.3f}, "
              f"{rec['ms_per_frame'][1]:.3f} (profiled "
              f"{rec['profiled_ms_per_frame']:.3f}); {iters}; device busy "
              + ("not measured (the profiler saw no device events)"
                 if busy is None else
                 f"{busy:.3f} ms/frame, {100 * rec['busy_share']:.1f}% of "
                 f"the faster run, {rec['device_ops_per_frame']:.1f} device "
                 f"ops/frame; " + ", ".join(
                     f"{g} {v:.3f}"
                     for g, v in rec["group_ms_per_frame"].items()))
              + f" | {smi}", flush=True)
        print(json.dumps(rec), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    suffix = "" if args.surface == "on" else "_surface_off"
    (out / f"profile_{args.solver}_{args.mode}{suffix}.json").write_text(
        json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
