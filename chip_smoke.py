#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It builds the
hand-written kernels (cpp_fluid_particles_tpu_torch/csrc/column_pass.cu)
with nvcc, holds each of the neighbor pass's sixteen instances, and the
particle-list kernel that runs pbd_lambda, stiffness_accel, divergence,
surface_pressure, density_colorgrad_visc, xsph_colorgrad,
density_alpha_colorgrad, density_visc, pressure_force, density_alpha,
viscosity, surface, xsph and the scene build's density, and the
cell-packed record kernel and its pack that run surface and
surface_pressure on the main path (so no path launches the column kernel),
against the plain torch executor on the card,
then drives the port's paths on the full 20,736-particle dam
(``dam_break_config(mode="parity")``, device "cuda"),
each with the launch counts reset just before it and read just after:
WCSPH, DFSPH and PBD for 300 frames each at the reference benchmark's dt,
PBD in its default fast mode as ``Simulation(device="cuda")`` builds it,
and the three solvers with surface effects off for a short run, then
the flat-grid prototype's entry point with its brick-tiled kernel, the
README's first command through the port's ``simulate`` CLI, and last the
README's multi-GPU recipe, the 1,000,000-particle DFSPH scene on an
x-slab mesh and on a 2x2 x-z block mesh of ranks (each a process of
``exp/mesh_run.py``), held bitwise to the single-device run. Phases:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc build of the kernels, seconds taken, and ptxas's
              registers and spills for every instance, the particle-list
              kernel's at each (group width, reduction) of
              ``variants(name)`` too, the record kernel's also at each
              unroll of ``UNROLLS``, and the pack kernel's; for the six
              fluid-only instances of phase 7 also their shared memory
  3. kernel   each pass instance vs ``column_pass_plain`` on the operands
              its path gives it, at frame 0 and after the path's run;
              per-row tolerance ``utils.check.PASS_BAR``: rtol 2e-5,
              atol 2e-5 x the row's max;
              two launches must agree bitwise. color_gradient and
              density_colorgrad, which no step runs, on PBD's [pos3, mass].
              The fourteen pp.PARTICLE_PASSES (the fluid-only viscosity,
              surface and xsph among them) also through the particle-list
              kernel on the step's slot list (density: the scene build's
              boundary grid with the boundary index's slot list, then
              the scene's boundary masses from the kernel against those
              from plain, per row at the same bar) at each (group width,
              reduction) of ``variants(name)`` (the transpose needs the
              pass's sums padded to a power of two to fit the group:
              density_alpha_colorgrad's 9 take it at W 16 and 32 only):
              against the plain executor and column_pass_kernel at the
              same bar, two launches bitwise (and whether the transpose
              reduction is bitwise equal to the butterfly at the same
              width). surface and surface_pressure also through the
              record kernel: its pack bitwise equal to pack_records_plain,
              the walk at each variant and unroll against the plain
              executor at the bar and bitwise equal to the particle-list
              kernel at the same variant
  4. step     one solver step with the kernel vs with the plain executor
              (pos atol 2e-6, vel atol 2e-3, equal iteration counts), and
              the drift after 5 steps; for WCSPH and DFSPH also with
              surface effects off
  5. slice    WCSPH: 300 frames at dt 0.001 through the constructor,
              run() and run_scan(); physics and launch-count checks
              (particle_density_colorgrad_visc == pack_surface_pressure ==
              record_surface_pressure == the frames run, particle_density
              == 1, the scene build's;
              on this and every later path the column kernel's count of
              every instance is 0), ms/frame from CUDA events
  5b. dfsph   the same for DFSPH at dt 0.004 (particle_divergence ==
              particle_stiffness_accel >= 5 x the frames run,
              particle_density_alpha_colorgrad == particle_viscosity ==
              pack_surface == record_surface == the frames run), plus
              iteration bounds,
              the mean iterations and the host syncs per frame
  5c. pbd     the same for PBD at dt 0.004 (the fixed 20-iteration
              projection with its exact all-lambda-zero exit):
              particle_pbd_lambda == particle_stiffness_accel == the sum
              of the frames' iterations, particle_xsph_colorgrad ==
              pack_surface == record_surface == the frames run
  5d. pbd_default  ``Simulation(device="cuda")`` as constructed (PBD in
              fast mode: tolerance exit + Chebyshev) with the 5c checks
  5e. off     the three solvers with surface tension and air pressure
              off, a short run each: the surface-off instances' launches
              (WCSPH particle_density_visc == particle_pressure_force ==
              the frames run; DFSPH particle_density_alpha ==
              particle_viscosity == the frames run and the divergence
              identity as in 5b; PBD as in 5c with particle_xsph == the
              frames run in place of xsph_colorgrad and surface)
  6. timing   kernel vs plain executor per pass at the shapes of its
              solver's 300-frame state (WCSPH's for density_visc and
              pressure_force; density_alpha on DFSPH's and xsph on PBD's,
              one surface-off step from it; density on the scene build's
              boundary grid), beside the pass's bound; the
              PARTICLE_PASSES as a ladder in turns: column kernel, the
              particle-list kernel with the butterfly at 8, 16, 32 lanes
              and the transpose reduction at 8, 16, 32 (where
              ``variants(name)`` has it) on the slot list its path gives
              it, then the default variant on the same slots in the other
              order (the paths hand every pass but surface_pressure
              ``BoxIndex.work``, in cell-major order; surface_pressure
              ``BoxIndex.slots``, in the particles'), then the same
              backwards, column kernel (best of two each), every
              rung timed by CUDA events around 50 calls and by a CUDA graph
              of 50 calls (the device's time alone); surface (on DFSPH's
              state and on PBD's) and surface_pressure add the record
              kernel's rungs, its pack included: each variant at the
              default unroll, the default variant at the other unrolls and
              on the other order, then the pack alone and the walk alone,
              and a line saying whether the record kernel's default beat
              the particle-list kernel's in both ladder passes; then
              divergence once
              more on the 1M recipe's one-device state after its warm-up
              frame, against plain, in cell-major order and in the
              particles', in turns
  7. flat     the flat-grid prototype's entry point
              (cpp_fluid_particles_tpu_torch/exp/flat_pallas_proto.py): the
              state after 150 WCSPH frames of the dam on a K = 24
              full-domain grid, its three fluid-only bodies through the
              brick-tiled kernel (the launch counts reset just before and
              read just after), each held against a second tiled launch
              (bitwise), the untiled kernel on the same functor and the
              plain executor (per row, the phase-3 bar), then timed,
              and the tiled kernel timed on each brick that fits K 24
  8. app      ``simulate.main`` as a user runs it, the launch counts reset
              just before each run and read just after: 100 frames of the
              default dam (PBD fast) rendered every 4th frame at 700 px
              into a GIF (25 frames), and ``--solver wcsph --parity``
              for 50 frames into a PNG; positions finite and in range,
              dropped_frames 0, the PBD (5d) and WCSPH (5) launch
              identities, the card's render of the final state against
              the CPU's (``utils.check.render_errors``: at most 0.5% of
              pixels over 1e-3, the others within 1e-5), the render's ms
              per call at 700 px, the CLI's ms/frame and the GIF encoder
              that ran
  9. mesh     the README's multi-GPU recipe: ``scaled_dam_scene(1_000_000)``
              with DFSPH (fast mode) for 3 frames through
              ``Simulation(mesh=...)``, each rank a process of
              ``exp/mesh_run.py`` under the environment contract, (a) on
              2 ranks over gloo sharing cuda:0 (the real ghost-plane
              exchange), (b) on 1 rank over NCCL (its set-up and every
              collective but the exchange, which one rank never makes),
              (c) on one rank per GPU over NCCL where more than one GPU is
              visible (else it says why it did not run); and the dam for
              WCSPH and PBD parity, 100 frames each, under (a) (the
              collapsing column makes PBD's projection run all 20
              iterations in the later frames); (d) the 1M recipe and the
              PBD dam on the (gx, gz) 2-D mesh of 2x2 ranks over gloo
              sharing cuda:0 (``--mesh2d 2x2``: the x phase, then the z
              phase of the exchange), (e) the 1M recipe on 2x2 ranks over
              NCCL, one per GPU, where four or more GPUs are visible (else
              it says why it did not run). Every rank
              of every run is held to a single-device run of the same
              frames: positions, velocities and density bitwise, every
              frame's metrics (iterations, host syncs, error sums,
              capacity) and the retries equal, and every kernel of its
              path launched (particle_density: the scene build's), none of
              the column kernel, each as often as on one device; the
              1-D runs make no z exchange. Per rank: launches, exchanges
              and their bytes (per axis), all-reduces and all-gathers per
              frame run, what gloo staged through host memory, ms/frame
              (CUDA events; under (a) and (d) the ranks share one card, so
              it is no scaling figure); and each run's wall seconds

A pass's bound is the larger of its bytes over 3.35 TB/s and its
operations over 67 TFLOP/s (float32, H100 SXM data sheet), both counted on
this run's operands. Bytes: each input read once, as far as the data needs
it (every row of each real slot, plus row 0 of one padding slot per cell
that is not full, where a slot loop stops), and the whole (n_out, K, G)
output written once. Operations: GEOM_FLOPS per candidate pair (each
cell's real slots against its 27 neighbours' real slots) plus PAIR_FLOPS
per pair inside the support.

Each phase prints one line per item. Before the last line it prints the
JSON kernel table, then the card's nvidia-smi line; the last line is
``{"ok": true, "device": {...}}``. A phase that fails logs a ``[fail]``
line and the phases after it still run, so one failure does not hide
another; then the run exits non-zero without the table and that line. JAX
is not imported. Details go to ``chiprun_out/chip_smoke.json``.

``python3 chip_smoke.py --mesh`` runs phases 1, 2 and 9 alone, for a
machine with several GPUs, where runs (c) and (e) run too: it ends with
the nvidia-smi line and prints neither the kernel table nor the ``ok``
line. Phase 9 leaves its details in ``mesh/phase.json`` beside its rank
logs in either case.
"""

from __future__ import annotations

import functools
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FRAMES = 300
OFF_FRAMES = 50          # the surface-off runs of phase 5e
APP_STEPS, APP_EVERY = 100, 4   # phase 8: the CLI's GIF run
APP_PNG_STEPS = 50              # phase 8: the CLI's PNG run
# phase 9: the README's multi-GPU recipe at full size, and the dam
MESH_1M = "dfsph-fast:scaled1000000:3"
MESH_DAM = ("wcsph:dam:100", "pbd:dam:100")
MESH_2D = "2x2"          # the (gx, gz) mesh of run (d)
MESH_TIMEOUT = 420       # seconds for one run of the per-rank entry point
# the particle-list kernels each solver's mesh path must launch on every
# rank (particle_density: the scene build's)
MESH_KERNELS = {
    "dfsph": ("particle_density", "particle_density_alpha_colorgrad",
              "particle_divergence", "particle_stiffness_accel",
              "particle_viscosity", "pack_surface", "record_surface"),
    "wcsph": ("particle_density", "particle_density_colorgrad_visc",
              "pack_surface_pressure", "record_surface_pressure"),
    "pbd": ("particle_density", "particle_pbd_lambda",
            "particle_stiffness_accel", "particle_xsph_colorgrad",
            "pack_surface", "record_surface")}
CHUNK = 25
STEP_POS_ATOL = 2e-6
STEP_VEL_ATOL = 2e-3
TPU_KERNEL = "cpp_fluid_particles_tpu/ops/pallas_passes.py:107"
FLAT_TPU_KERNEL = "exp/flat_pallas_proto.py:67"
KERNEL_SRC = "cpp_fluid_particles_tpu_torch/csrc/column_pass.cu"
PEAK_F32 = 67e12         # FLOP/s, float32 outside the tensor cores
PEAK_BYTES = 3.35e12     # bytes/s, HBM3
# operations per candidate pair: dx, dy, dz (3), r^2 (5), sqrt (1), the
# support test 2r/h (2)
GEOM_FLOPS = 11
# operations per pair inside the support, (fluid, boundary), counted from
# the functors of KERNEL_SRC: each add, multiply, division and square root
# is one, a select counts its longer side (w_cubic 8, grad_w_cubic_coef 10,
# w_visc_laplacian 3, grad_w_surface_coef 13, p/rho^2 3, |cg|^2 5)
PAIR_FLOPS = {"density": (10, 10), "density_colorgrad_visc": (46, 30),
              "surface_pressure": (53, 18),
              "density_alpha_colorgrad": (47, 37), "divergence": (21, 18),
              "stiffness_accel": (21, 18), "viscosity": (16, 0),
              "surface": (41, 0), "density_alpha": (37, 27),
              "density_visc": (26, 10), "pressure_force": (24, 18),
              "pbd_lambda": (38, 38), "xsph_colorgrad": (40, 28),
              "xsph": (20, 0), "color_gradient": (28, 28),
              "density_colorgrad": (30, 30)}
# instances that no step runs, in either package: held in phases 3 and 6
# on the PBD path's own [pos3, mass] operands, never launched by a path
OFF_PATH = {name: "no step runs it; held on the PBD path's [pos3, mass] "
            "operands at frame 0 and after the PBD run"
            for name in ("color_gradient", "density_colorgrad")}
# the operands of the two rows that no step of a 300-frame path gives
STATE = {"density": "the scene build's boundary grid (full domain, Kb = K) "
         "and its zero-mass clone, with the boundary index's slot list; "
         "launched once per scene, by the Simulation constructor",
         "xsph": "one surface-off PBD step from the 300-frame PBD parity "
         "state, with that step's slot list"}


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
    """An executor that records the operands of the first call of every
    pass, the step's slot list among them, and runs the plain executor on
    all calls."""

    def __init__(self, plain):
        self.plain = plain
        self.calls = {}

    def __call__(self, name, fl, bd, dims, dims_b, cfg, islots=None):
        self.calls.setdefault(name, (name, fl, bd, dims, dims_b, islots))
        return self.plain(name, fl, bd, dims, dims_b, cfg)


def surface_off(cfg):
    return cfg.replace(surface_tension=0.0, air_pressure=0.0)


def capture(sim, ds, pp, dt):
    """The operands the main path gives each pass instance from sim.state:
    WCSPH: the scene build's density pass (the boundary grid, its zero-mass
    clone and the boundary index's slot list), one step's two passes and one
    surface-off step's two (phase 6 times those on this state, the WCSPH
    dam's). DFSPH: one step's five passes, then one surface-off WCSPH step
    and one surface-off DFSPH step on the same state for the surface-off
    instances. PBD: one step's four passes (stiffness_accel on lambda) and
    one surface-off step's xsph; color_gradient and density_colorgrad,
    which no step runs, on the first projection iteration's [pos3, mass]
    operands."""
    from cpp_fluid_particles_tpu_torch.state import boundary_positions
    rec = Recorder(pp.column_pass_plain)
    dims, dims_b = sim._dims()
    if sim.solver_name == "wcsph":
        ds.build_dense_scene(sim.cfg, boundary_positions(sim.cfg), sim._kb,
                             sim.device, executor=rec)
        for cfg in (sim.cfg, surface_off(sim.cfg)):
            ds.wcsph_step(sim.state, (), sim.scene, cfg, dt, dims, dims_b,
                          sim.box, executor=rec)
    elif sim.solver_name == "dfsph":
        off = surface_off(sim.cfg)
        ds.dfsph_step(sim.state, sim.carry, sim.scene, sim.cfg, dt, dims,
                      dims_b, sim.box, executor=rec)
        ds.wcsph_step(sim.state, (), sim.scene, off, dt, dims, dims_b,
                      sim.box, executor=rec)
        ds.dfsph_step(sim.state, sim.carry, sim.scene, off, dt, dims,
                      dims_b, sim.box, executor=rec)
    else:
        for cfg in (sim.cfg, surface_off(sim.cfg)):
            ds.pbd_step(sim.state, sim.carry, sim.scene, cfg, dt, dims,
                        dims_b, sim.box, executor=rec)
        _, fl, bd, pdims, pdims_b, _ = rec.calls["pbd_lambda"]
        for name in ("color_gradient", "density_colorgrad"):
            rec.calls[name] = (name, fl, bd, pdims, pdims_b, None)
    return list(rec.calls.values())


def launched(name, n):
    """The launch counts of ``n`` calls of pass ``name`` on its path: the
    record kernel's pack and walk for the passes of its RECORD_IDS, else
    the particle-list kernel's."""
    from cpp_fluid_particles_tpu_torch.ops.column_pass_cuda import RECORD_IDS
    if name in RECORD_IDS:
        return {f"pack_{name}": n, f"record_{name}": n}
    return {f"particle_{name}": n}


def note_err(errs, key, max_abs, worst_rel):
    e = errs.setdefault(key, {"max_abs_err": 0.0, "max_rel_err": 0.0})
    e["max_abs_err"] = max(e["max_abs_err"], max_abs)
    e["max_rel_err"] = max(e["max_rel_err"], worst_rel)


def launch_twice(tag, fn, torch):
    """fn() twice -> its output, after checking that the two launches are
    bitwise equal and finite."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{tag}: two launches differ")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{tag}: non-finite output")
    return got


def compare_passes(tag, calls, cfg, pp, cc, torch, errs):
    """Each pass's column kernel against the plain executor; each of
    pp.PARTICLE_PASSES also through the particle-list kernel at each
    (group width, reduction) of ``cc.variants(name)``, against the plain
    executor and the column kernel (errors kept as ``particle_<name>``),
    and the transpose reduction against the butterfly at the same width
    (bitwise or not, logged)."""
    from cpp_fluid_particles_tpu_torch.utils.check import row_errors
    for name, fl, bd, dims, dims_b, islots in calls:
        want = pp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)
        got = launch_twice(f"{tag} {name}", lambda: cc.column_pass_cuda(
            name, fl, bd, dims, dims_b, cfg), torch)
        max_abs, worst_rel = row_errors(f"{tag} {name}", got, want)
        note_err(errs, name, max_abs, worst_rel)
        kb = dims_b.k if dims_b is not None else 0
        log("kernel", f"{tag} {name} K={dims.k} Kb={kb} "
            f"grid={dims.gx}x{dims.gy}x{dims.gz} max_abs_err={max_abs:.3e} "
            f"max_err/row_max={worst_rel:.3e} bitwise_repeat=yes")
        if name not in pp.PARTICLE_PASSES:
            continue
        if islots is None:
            raise AssertionError(f"{tag} {name}: the step gave no slot list")
        outs = {}
        for lanes, red in cc.variants(name):
            what = f"{tag} particle {name} W={lanes} {red}"
            part = outs[lanes, red] = launch_twice(
                what, lambda: cc.particle_pass_cuda(
                    name, fl, bd, islots, dims, dims_b, cfg, lanes=lanes,
                    reduction=red), torch)
            max_abs, worst_rel = row_errors(what, part, want)
            _, vs_column = row_errors(f"{what} vs column kernel", part, got)
            note_err(errs, f"particle_{name}", max_abs, worst_rel)
            # the butterfly exists at every width and comes first
            same = torch.equal(part, outs[lanes, cc.REDUCTIONS[0]])
            log("kernel", f"{what} N={islots.shape[0]} K={dims.k} "
                f"Kb={kb}: vs plain max_abs_err={max_abs:.3e} "
                f"max_err/row_max={worst_rel:.3e}, vs column kernel "
                f"max_err/row_max={vs_column:.3e}, bitwise_repeat=yes, "
                f"bitwise equal to {cc.REDUCTIONS[0]}: "
                f"{'yes' if same else 'no'}")
        if name in cc.RECORD_IDS:
            compare_records(tag, name, fl, bd, dims, dims_b, islots, cfg,
                            want, outs, cc, torch, errs)


def compare_records(tag, name, fl, bd, dims, dims_b, islots, cfg, want,
                    outs, cc, torch, errs):
    """The pack kernel bitwise against its plain version (two packs bitwise
    equal), then the record kernel at each (group width, reduction) of
    ``cc.variants(name)`` and each unroll of ``cc.UNROLLS``: two launches
    bitwise, within the bar of the plain executor ``want``, and bitwise
    equal to the particle-list kernel's ``outs`` at the same variant
    (errors kept as ``record_<name>``; the pack's as ``pack_<name>``)."""
    from cpp_fluid_particles_tpu_torch.utils.check import row_errors
    packs = [cc.pack_records(name, fl, bd, dims, dims_b, cfg)
             for _ in range(2)]
    plain = cc.pack_records_plain(name, fl, bd, cfg)
    torch.cuda.synchronize()
    for a, b, c in zip(*packs, plain):
        if a is None and b is None and c is None:
            continue
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"{tag} pack {name}: two packs differ or "
                                 "differ from pack_records_plain")
    note_err(errs, f"pack_{name}", 0.0, 0.0)
    kb = dims_b.k if dims_b is not None else 0
    log("kernel", f"{tag} pack {name} K={dims.k} Kb={kb}: records "
        f"({dims.g * dims.k} fluid, {dims.g * kb} boundary) bitwise equal to "
        "pack_records_plain; bitwise_repeat=yes")
    for lanes, red in cc.variants(name):
        errs_u = []
        for unroll in cc.UNROLLS:
            what = f"{tag} record {name} W={lanes} {red} U={unroll}"
            got = launch_twice(what, lambda: cc.record_pass_cuda(
                name, fl, bd, islots, dims, dims_b, cfg, lanes=lanes,
                reduction=red, unroll=unroll), torch)
            max_abs, worst_rel = row_errors(what, got, want)
            note_err(errs, f"record_{name}", max_abs, worst_rel)
            if not torch.equal(got, outs[lanes, red]):
                raise AssertionError(f"{what}: not bitwise equal to the "
                                     "particle-list kernel at W="
                                     f"{lanes} {red}")
            errs_u.append(f"U={unroll} {worst_rel:.3e}")
        log("kernel", f"{tag} record {name} W={lanes} {red} "
            f"N={islots.shape[0]} K={dims.k} Kb={kb}: vs plain "
            f"max_err/row_max {', '.join(errs_u)}; each unroll bitwise "
            "equal to the particle-list kernel at this variant; "
            "bitwise_repeat=yes")


def scene_mass_vs_plain(sim, ds, pp, torch, errs):
    """The scene build as the constructor runs it (density through the
    particle-list kernel on the boundary index's slot list) against the
    same build with the plain executor: the boundary positions bitwise,
    the Akinci masses per row within PASS_BAR (errors kept as
    ``b_mass``); and the build repeated equals sim's scene bitwise."""
    from cpp_fluid_particles_tpu_torch.state import boundary_positions
    from cpp_fluid_particles_tpu_torch.utils.check import row_errors
    b_pos = boundary_positions(sim.cfg)
    got = ds.build_dense_scene(sim.cfg, b_pos, sim._kb, sim.device).bd
    want = ds.build_dense_scene(sim.cfg, b_pos, sim._kb, sim.device,
                                executor=pp.column_pass_plain).bd
    torch.cuda.synchronize()
    if not torch.equal(got, sim.scene.bd):
        raise AssertionError("scene: two builds differ")
    if not torch.equal(got[:3], want[:3]):
        raise AssertionError("scene: boundary positions differ from plain's")
    max_abs, worst_rel = row_errors("scene b_mass", got[3:4], want[3:4])
    note_err(errs, "b_mass", max_abs, worst_rel)
    real = int((got[0] < ds.POS_GUARD).sum())
    log("kernel", f"scene b_mass ({real} boundary particles, Kb="
        f"{sim._kb}) kernel vs plain: max_abs_err={max_abs:.3e} "
        f"max_err/row_max={worst_rel:.3e}; positions bitwise equal; "
        "bitwise_repeat=yes")


ITER_KEYS = ("divergence_iters", "density_iters", "pbd_iters")


def iters(m) -> str:
    return "".join(f" {k}={int(m[k])}" for k in ITER_KEYS if k in m)


def step_vs_plain(sim, ds, pp, torch, dt, cfg=None, n_drift=5):
    """Steps from sim's state with the kernels against the plain executor,
    with sim.cfg or ``cfg`` (its surface-off copy)."""
    dims, dims_b = sim._dims()
    step = ds.DENSE_STEPS[sim.solver_name]
    cfg = sim.cfg if cfg is None else cfg
    what = sim.solver_name + ("" if cfg == sim.cfg else " surface off")

    def run(executor, n):
        st, ca, m = sim.state, sim.carry, {}
        for _ in range(n):
            st, ca, m = step(st, ca, sim.scene, cfg, dt, dims, dims_b,
                             sim.box, executor=executor)
        return st, m

    (a, ma), (b, mb) = run(None, 1), run(pp.column_pass_plain, 1)
    dpos = float((a.pos - b.pos).abs().max())
    dvel = float((a.vel - b.vel).abs().max())
    if not (dpos <= STEP_POS_ATOL and dvel <= STEP_VEL_ATOL):
        raise AssertionError(f"step: {what} kernel vs plain dpos={dpos} "
                             f"dvel={dvel} over the bars")
    if iters(ma) != iters(mb):
        raise AssertionError(f"step: {what} iterations differ, "
                             f"kernel{iters(ma)} plain{iters(mb)}")
    (a, _), (b, _) = run(None, n_drift), run(pp.column_pass_plain, n_drift)
    log("step", f"{what} one step kernel vs plain: dpos={dpos:.3e}"
        f" (bar {STEP_POS_ATOL}) dvel={dvel:.3e} (bar {STEP_VEL_ATOL});"
        f" kernel{iters(ma)} plain{iters(mb)}; after {n_drift} steps: "
        f"dpos={float((a.pos - b.pos).abs().max()):.3e} "
        f"dvel={float((a.vel - b.vel).abs().max()):.3e}")


class Tally:
    """Wraps a solver's step in ``DENSE_STEPS`` while a Simulation is
    constructed, so that the Simulation keeps every frame's metrics (the
    constructor's warm-up and frames re-run by a capacity retry included),
    read once at the end."""

    def __init__(self, ds, solver):
        self.frames = []
        step = ds.DENSE_STEPS[solver]

        def tallied(*args, **kwargs):
            out = step(*args, **kwargs)
            self.frames.append(out[2])
            return out
        self.step = tallied

    def column(self, key, torch):
        return torch.stack([m[key] for m in self.frames]).cpu().tolist()


def build_tallied(ds, name, tally, build):
    """build() with solver ``name``'s step in ``DENSE_STEPS`` swapped for
    the tallied one while it runs (a Simulation binds its step when it is
    constructed); tally None: build() alone."""
    saved = ds.DENSE_STEPS[name]
    if tally is not None:
        ds.DENSE_STEPS[name] = tally.step
    try:
        return build()
    finally:
        ds.DENSE_STEPS[name] = saved


def construct(cfp, ds, solver, cfg, tally):
    """Simulation(solver=..., cfg=..., device="cuda"), or with solver None
    ``Simulation(device="cuda")`` as a user builds it; with a Tally, its
    step is the tallied one."""
    if solver is None:
        build = lambda: cfp.Simulation(device="cuda")  # noqa: E731
    else:
        build = lambda: cfp.Simulation(  # noqa: E731
            solver=solver, cfg=cfg, device="cuda")
    return build_tallied(ds, cfp.resolve_solver(solver or "pbd"), tally,
                         build)


def check_final(sim, frames, torch):
    """A path's end: ``frames`` frames run, positions finite and in
    [0, 0.99*space], no frame committed with dropped particles."""
    pos = sim.state.pos
    space = torch.tensor(sim.cfg.space_size, device=pos.device)
    if sim.frame != frames:
        raise AssertionError(f"ran {sim.frame} frames, not {frames}")
    if not bool(torch.isfinite(pos).all()):
        raise AssertionError("non-finite positions")
    if not bool(((pos >= 0) & (pos <= 0.99 * space)).all()):
        raise AssertionError("positions outside [0, 0.99*space]")
    if sim.dropped_frames != 0:
        raise AssertionError(f"dropped_frames={sim.dropped_frames}")


def drive(cfp, ds, cc, torch, cfg, solver, dt, frames, tally=False):
    """Construct, run() one chunk, then run_scan() chunks, from the dam
    start: -> (sim, stats). The launch counts are reset before the
    constructor and read after the last chunk. solver None constructs
    ``Simulation(device="cuda")`` with its defaults (cfg is ignored)."""
    cc.reset_launch_counts()
    t_run = time.perf_counter()
    tl = Tally(ds, cfp.resolve_solver(solver or "pbd")) if tally else None
    sim = construct(cfp, ds, solver, cfg, tl)
    cfg, solver = sim.cfg, sim.solver_name
    y0 = float(torch.as_tensor(cfp.dam_break_positions(cfg))[:, 1].mean())
    rerun_frames = 1 + sim.retries               # warm-up step + retries
    ctor_frames = rerun_frames
    r0 = sim.retries
    chunk = min(CHUNK, frames)
    step_ms = sim.run(chunk, dt)["ms_per_frame"] * chunk
    rerun_frames += chunk + (sim.retries - r0)
    scan_ms = 0.0
    chunks = []                  # per chunk: last frame, ms/frame, K, box
    for _ in range((frames - chunk) // chunk):
        r0 = sim.retries
        ms = sim.run_scan(chunk, dt)
        scan_ms += ms * chunk
        rerun_frames += chunk * (1 + sim.retries - r0)
        chunks.append([sim.frame, ms, sim.max_per_cell, list(sim.box)])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_run
    launches = dict(cc.LAUNCHES)

    check_final(sim, frames, torch)
    y1 = float(sim.state.pos[:, 1].mean())
    if not y1 < y0:
        raise AssertionError(f"mean y did not decrease: {y0} -> {y1}")
    stats = {
        "solver": solver, "frames": frames, "dt": dt,
        "surface": cfg.surface_tension > 0 or cfg.air_pressure > 0,
        "fluid": sim.fluid_size, "boundary": sim.boundary_size,
        "K": sim.max_per_cell, "box": list(sim.box), "retries": sim.retries,
        "dropped_frames": sim.dropped_frames, "rerun_frames": rerun_frames,
        "launches": launches, "ms_per_frame": (step_ms + scan_ms) / frames,
        "ms_per_frame_step": step_ms / chunk,
        "ms_per_frame_run_scan": scan_ms / max(frames - chunk, 1),
        "wall_s": wall_s, "mean_y": [y0, y1], "run_scan_chunks": chunks,
        "ctor_frames": ctor_frames}
    if tl is not None:
        for key in ITER_KEYS + ("host_syncs",):
            if key in tl.frames[0]:
                stats[key] = tl.column(key, torch)
        if len(stats["host_syncs"]) != rerun_frames:
            raise AssertionError(f"tallied {len(stats['host_syncs'])} "
                                 f"frames, expected {rerun_frames}")
    return sim, stats


def drop_columns(st):
    """The per-frame columns stay out of the saved record."""
    for key in ITER_KEYS + ("host_syncs",):
        st.pop(key, None)


def pbd_checks(st, cfg, off=False):
    """PBD launch identities over every frame run (the warm-up and retries
    included), all through the particle-list kernel: pbd_lambda ==
    stiffness_accel == the sum of the frames' iterations, one XSPH
    traversal per frame (xsph_colorgrad and surface, or xsph with surface
    effects off); iterations in [1, pbd_max_iter]. Adds the mean iterations
    and host syncs per frame run after the constructor."""
    it, frames_run = st["pbd_iters"], st["rerun_frames"]
    n = sum(it)
    want = {"particle_pbd_lambda": n, "particle_stiffness_accel": n}
    want.update({"particle_xsph": frames_run} if off else
                dict(launched("surface", frames_run),
                     particle_xsph_colorgrad=frames_run))
    expect_launches(st, want)
    if not (min(it) >= 1 and max(it) <= cfg.pbd_max_iter):
        raise AssertionError(f"PBD iterations out of bounds: "
                             f"{min(it)}-{max(it)}, cap {cfg.pbd_max_iter}")
    after = slice(st["ctor_frames"], None)
    st["mean_iters"] = sum(it[after]) / len(it[after])
    syncs = st["host_syncs"][after]
    st["host_syncs_per_frame"] = sum(syncs) / len(syncs)
    return (f" | per frame run: pbd iters {st['mean_iters']:.2f} "
            f"({min(it)}-{max(it)}), projection host syncs "
            f"{st['host_syncs_per_frame']:.2f} (plus one capacity fetch per "
            f"chunk)")


def expect_launches(stats, want):
    """want: pass name -> exact count, or (lo, None) for a lower bound;
    names not listed must not have launched, apart from particle_density,
    which the scene build launches once (a path builds one scene). So the
    column kernel's count of every instance must be 0."""
    got = stats["launches"]
    bad = []
    for name, n in got.items():
        w = want.get(name, 1 if name == "particle_density" else 0)
        ok = n >= w[0] if isinstance(w, tuple) else n == w
        if not ok:
            bad.append(f"{name}={n} (want {w})")
    if bad:
        raise AssertionError(f"{stats['solver']} launch counts: "
                             + ", ".join(bad))


def divergence_is_stiffness_accel(stats):
    """DFSPH runs stiffness_accel once for every divergence pass, both
    through the particle-list kernel."""
    la = stats["launches"]
    if la["particle_divergence"] != la["particle_stiffness_accel"]:
        raise AssertionError(f"particle_divergence "
                             f"{la['particle_divergence']} != "
                             f"particle_stiffness_accel "
                             f"{la['particle_stiffness_accel']}")


def slice_line(stats, card):
    return (f"{stats['fluid']} fluid + {stats['boundary']} boundary, "
            f"{stats['frames']} frames at dt {stats['dt']}: K={stats['K']} "
            f"box={tuple(stats['box'])} retries={stats['retries']} "
            f"dropped_frames=0 mean_y {stats['mean_y'][0]:.4f}->"
            f"{stats['mean_y'][1]:.4f} launches="
            f"{ {k: v for k, v in stats['launches'].items() if v} } | "
            f"{stats['ms_per_frame']:.3f} ms/frame (CUDA events; step() "
            f"{stats['ms_per_frame_step']:.3f}, run_scan "
            f"{stats['ms_per_frame_run_scan']:.3f}) wall "
            f"{stats['wall_s']:.1f} s | {card}")


def ptxas_report(log_text):
    """-> {mangled kernel entry: (registers, spill bytes, static shared
    bytes)} from ptxas -v; the entry's name holds its kernel and pass
    functor."""
    out, entry, spill = {}, None, 0
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            sm = re.search(r"(\d+) bytes smem", ln)
            out[entry] = (int(m.group(1)), spill,
                          int(sm.group(1)) if sm else 0)
            entry = None
    return out


def functor(name):
    """pass name -> its functor in csrc/column_pass.cu (density_visc ->
    DensityViscPass)."""
    return "".join(w.capitalize() for w in name.split("_")) + "Pass"


def ptxas_entry(ptxas, kernel, name, fluid_only, lanes=None,
                transpose=None, unroll=None):
    """The one ptxas entry of ``kernel`` on pass ``name``'s functor,
    wrapped in FluidOnly or not, at group width ``lanes`` and reduction
    (``transpose``, the template's bool) for the particle-list kernel, and
    also at ``unroll`` for the record kernel -> (registers, spill bytes,
    smem)."""
    f = functor(name)
    tail = None if lanes is None else f"ELi{lanes}ELb{int(transpose)}E"
    if unroll is not None:
        tail += f"Li{unroll}E"
    hits = [v for k, v in ptxas.items()
            if f"{len(kernel)}{kernel}" in k and f"{len(f)}{f}" in k
            and ("9FluidOnly" in k) == fluid_only
            and (tail is None or tail in k)]
    if len(hits) != 1:
        raise AssertionError(f"ptxas report has {len(hits)} entries for "
                             f"{kernel}<{f}> (fluid only: {fluid_only}, "
                             f"lanes {lanes}, transpose {transpose})")
    return hits[0]


def pair_counts(pp, torch, fl, src, dims, h):
    """-> (candidate pairs, pairs inside the support) of the one-sided
    27-offset sum over the i slots of fl with j slots from src (fl itself,
    or the boundary grid on the same cells): every real i slot against
    every real j slot of its 27 neighbour cells, as the kernels walk them;
    the support test is the kernels' in_support on the float32 distance."""
    from cpp_fluid_particles_tpu_torch.ops.grid import POS_PAD
    p = dims.flat_p
    w = dims.g - 2 * p
    xi = fl[:3, :, p:p + w]
    i_real = xi[0] < POS_PAD / 2
    n_i = i_real.sum(0, dtype=torch.float64)
    cand = sup = 0
    for d in (pp._flat_offsets(dims) + p).tolist():
        xj = src[:3, :, d:d + w]
        j_real = xj[0] < POS_PAD / 2
        cand += int((n_i * j_real.sum(0, dtype=torch.float64)).sum())
        dx, dy, dz = (xi[a][:, None, :] - xj[a][None, :, :]
                      for a in range(3))
        r = torch.sqrt(dx * dx + dy * dy + dz * dz)
        ok = ((2.0 * r / h <= 2.0) | (r <= h)) & i_real[:, None, :] \
            & j_real[None, :, :]
        sup += int(ok.sum())
    return cand, sup


def occupancy(src):
    """(real slots, cells not full) of the operand grid src (rows, K, G):
    a slot loop reads each real slot and probes the first padding slot of
    each cell that is not full, where it learns the cell's occupancy (ranks
    fill a cell from slot 0)."""
    from cpp_fluid_particles_tpu_torch.ops.grid import POS_PAD
    real = (src[0] < POS_PAD / 2).sum(0)
    return int(real.sum()), int((real < src.shape[1]).sum())


def operand_bytes(src):
    """The bytes a pass must read of the operand grid src (rows, K, G):
    every row of each real slot, and row 0 of each probed padding slot
    (``occupancy``)."""
    real, probes = occupancy(src)
    return 4 * (src.shape[0] * real + probes)


def pass_bound(pp, torch, name, fl, bd, dims, dims_b, cfg, n_out):
    """The least time for pass ``name`` on these operands -> a record:
    bytes (the real slots of fl and bd with one occupancy probe per cell,
    ``operand_bytes``, and the whole (n_out, K, G) output, each once) over
    PEAK_BYTES against operations (GEOM_FLOPS per candidate pair,
    PAIR_FLOPS per pair in support) over PEAK_F32. bd None: the fluid term
    alone."""
    f_fluid, f_bd = PAIR_FLOPS[name]
    cand, sup = pair_counts(pp, torch, fl, fl, dims, cfg.radius)
    flops = GEOM_FLOPS * cand + f_fluid * sup
    nbytes = operand_bytes(fl) + n_out * dims.k * dims.g * 4
    rec = {"pairs": cand, "pairs_in_support": sup}
    if bd is not None:
        cb, sb = pair_counts(pp, torch, fl, bd, dims, cfg.radius)
        flops += GEOM_FLOPS * cb + f_bd * sb
        nbytes += operand_bytes(bd)
        rec.update(boundary_pairs=cb, boundary_pairs_in_support=sb)
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    rec.update(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops > t_bytes else "bytes")
    return rec


def rung(lanes, red, order=None):
    """A ladder key: "<reduction> W<lanes>" on the list the path gives the
    pass, "<reduction> W<lanes> <order>" on the same slots in the other
    order ("work": cell-major, ``BoxIndex.work``; "slots": the particles'
    order, ``BoxIndex.slots``)."""
    return f"{red} W{lanes}" + ("" if order is None else f" {order}")


def record_rung(lanes, red, unroll, order=None, walk=False):
    """A ladder key of the record kernel: "record <reduction> W<lanes>
    U<unroll>[ <order>]", its pack included; "walk ..." the walk alone, on
    records packed before the timing."""
    return (f"{'walk' if walk else 'record'} {red} W{lanes} U{unroll}"
            + ("" if order is None else f" {order}"))


def record_rungs(name, fl, bd, islots, alt, dims, dims_b, cfg, cc):
    """The record kernel's rungs of pass ``name``: at each (group width,
    reduction) of ``cc.variants(name)`` at its default unroll, at its
    default (width, reduction) at the other unrolls, each with the pack
    included, on ``islots``; the default on ``alt``'s list where given;
    the pack alone; the walk alone at the default -> [(key, fn)]."""
    lanes, red, unroll = cc.RECORD_DEFAULTS[name]

    def record(lanes, red, unroll, lst, recs=None):
        return lambda: cc.record_pass_cuda(
            name, fl, bd, lst, dims, dims_b, cfg, lanes=lanes, reduction=red,
            unroll=unroll, records=recs)
    out = [(record_rung(w, r, unroll), record(w, r, unroll, islots))
           for r in cc.REDUCTIONS for w in sorted(cc.LANES)
           if (w, r) in cc.variants(name)]
    out += [(record_rung(lanes, red, u), record(lanes, red, u, islots))
            for u in cc.UNROLLS if u != unroll]
    if alt is not None:
        out.append((record_rung(lanes, red, unroll, alt[0]),
                    record(lanes, red, unroll, alt[1])))
    recs = cc.pack_records(name, fl, bd, dims, dims_b, cfg)
    out.append(("pack", lambda: cc.pack_records(name, fl, bd, dims, dims_b,
                                                cfg)))
    out.append((record_rung(lanes, red, unroll, walk=True),
                record(lanes, red, unroll, islots, recs)))
    return out


def time_ladder(name, fl, bd, islots, alt, dims, dims_b, cfg, cc):
    """The particle-list kernel at each (group width, reduction) of
    ``cc.variants(name)`` beside the column kernel, in turns within this
    call: column; the butterfly at W 8, 16, 32 and the transpose at W 8,
    16, 32 (those the pass takes) on ``islots``, the list its path gives
    it; the default variant on ``alt`` = (the other order's name, its
    list), the same slots in the other order, where given; the same
    backwards; column. Each rung is timed twice in a row, by CUDA events
    around 50 calls (``time_ms``: what a caller that enqueues call after
    call sees, the host's work included where the device finishes first)
    and by one replay of a CUDA graph of 50 calls (``time_graph_ms``: the
    device's time alone) -> ({"column": [two runs], rung(...): [two
    runs]}, the same of graph ms). A pass of ``cc.RECORD_IDS`` also takes
    the record kernel's rungs (``record_rungs``) after the particle-list
    kernel's."""
    from cpp_fluid_particles_tpu_torch.utils.check import (time_graph_ms,
                                                           time_ms)

    def column():
        cc.column_pass_cuda(name, fl, bd, dims, dims_b, cfg)

    def particle(lanes, red, lst):
        return lambda: cc.particle_pass_cuda(name, fl, bd, lst, dims,
                                             dims_b, cfg, lanes=lanes,
                                             reduction=red)
    rungs = [(rung(lanes, red), particle(lanes, red, islots))
             for red in cc.REDUCTIONS for lanes in sorted(cc.LANES)
             if (lanes, red) in cc.variants(name)]
    if alt is not None:
        lanes, red = cc.default_lanes(name), cc.default_reduction(name)
        rungs.append((rung(lanes, red, alt[0]), particle(lanes, red,
                                                         alt[1])))
    if name in cc.RECORD_IDS:
        rungs += record_rungs(name, fl, bd, islots, alt, dims, dims_b, cfg,
                              cc)
    runs = {"column": [time_ms(column, 50)]}
    graph = {"column": [time_graph_ms(column, 50)]}
    for key, fn in rungs + rungs[::-1]:
        runs.setdefault(key, []).append(time_ms(fn, 50))
        graph.setdefault(key, []).append(time_graph_ms(fn, 50))
    runs["column"].append(time_ms(column, 50))
    graph["column"].append(time_graph_ms(column, 50))
    return runs, graph


def time_passes(calls, cfg, pp, cc, torch, card, times, orders=None,
                solver=None):
    """Phase 6 on the captured calls; ``orders(islots)`` -> (the order
    islots is in, the other order's name, the same slots in that order),
    or None where it does not know them. A pass is timed on the first
    state that gives it, kept as ``times[name]``; a pass of
    ``cc.RECORD_IDS`` also on each later one, as ``times[name@solver]``
    (surface: DFSPH's state, then PBD's)."""
    from cpp_fluid_particles_tpu_torch.utils.check import time_ms
    for name, fl, bd, dims, dims_b, islots in calls:
        tkey = name
        if name in times:
            if name not in cc.RECORD_IDS:
                continue
            tkey = f"{name}@{solver}"

        def kern():
            cc.column_pass_cuda(name, fl, bd, dims, dims_b, cfg)

        def plain():
            pp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)
        # plain, kernel, kernel, plain: compared within one call
        p1 = time_ms(plain, 5)
        k1 = time_ms(kern, 50)
        k2 = time_ms(kern, 50)
        p2 = time_ms(plain, 5)
        kb = dims_b.k if dims_b is not None else 0
        times[tkey] = dict({"ms": min(k1, k2), "plain_ms": min(p1, p2),
                            "runs_ms": [p1, k1, k2, p2],
                            "grid": [dims.gx, dims.gy, dims.gz],
                            "K": dims.k, "Kb": kb},
                           **pass_bound(pp, torch, name, fl, bd, dims,
                                        dims_b, cfg,
                                        pp.PASSES[name].n_out))
        t = times[tkey]
        log("timing", f"{tkey} K={dims.k} Kb={kb} grid={dims.gx}x{dims.gy}x"
            f"{dims.gz}: kernel {min(k1, k2):.4f} ms, plain "
            f"{min(p1, p2):.4f} ms (plain,kernel,kernel,plain = "
            f"{p1:.4f},{k1:.4f},{k2:.4f},{p2:.4f}); bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({t['bytes']} B, "
            f"{t['flops']} FLOP, {t['pairs']} pairs, "
            f"{t['pairs_in_support']} in support) | {card}")
        if name not in pp.PARTICLE_PASSES:
            continue
        got = orders(islots) if orders is not None else None
        order, alt = (got[0], got[1:]) if got is not None else (None, None)
        runs, graph = time_ladder(name, fl, bd, islots, alt, dims, dims_b,
                                  cfg, cc)
        best = {w: min(r) for w, r in runs.items()}
        gbest = {w: min(r) for w, r in graph.items()}
        lanes, red = cc.default_lanes(name), cc.default_reduction(name)
        t.update(column_kernel_ms=best["column"],
                 column_kernel_graph_ms=gbest["column"], lanes=lanes,
                 reduction=red, particle_ms=best[rung(lanes, red)],
                 graph_ms=gbest[rung(lanes, red)], order=order,
                 ladder=runs, ladder_graph=graph)
        if alt is not None:
            t["other_order_graph_ms"] = gbest[rung(lanes, red, alt[0])]
        if name in cc.RECORD_IDS:
            t.update(record_times(name, fl, bd, dims, dims_b, cfg, alt, best,
                                  gbest, cc))
            key = record_rung(t["record_lanes"], t["record_reduction"],
                              t["record_unroll"])
            wins = [a < b for a, b in zip(graph[key],
                                          graph[rung(lanes, red)])]
            t["record_wins_both_passes"] = all(wins)
            pk = t["pack"]
            log("timing", f"{tkey} record kernel at its default {key} "
                f"(pack included) against the particle-list kernel's "
                f"{rung(lanes, red)}, graph ms per ladder pass: "
                + ", ".join(f"{a:.4f} vs {b:.4f}" for a, b in zip(
                    graph[key], graph[rung(lanes, red)]))
                + f" (faster in both: {'yes' if all(wins) else 'no'}); "
                f"walk alone {t['walk_graph_ms']:.4f}; pack "
                f"{pk['ms']:.4f} / {pk['graph_ms']:.4f} ms (events / graph), "
                f"plain {pk['plain_ms']:.4f}, bound {pk['bound_ms']:.4f} by "
                f"{pk['bound_by']} ({pk['bytes']} B) | {card}")
        on = f" on the path's list ({order})" if order else ""
        then = f", the default on {alt[0]}" if alt is not None else ""
        log("timing", f"{tkey} ladder N={islots.shape[0]} K={dims.k} Kb={kb}"
            f" (column kernel; particle-list kernel at each variant{on}, "
            f"butterfly first{then}, and back; column kernel; best of two, "
            f"events / graph): "
            + "; ".join(f"{w} {best[w]:.4f} / {gbest[w]:.4f} ms"
                        for w in runs)
            + " (runs " + ", ".join(
                f"{w}: " + "/".join(f"{x:.4f}" for x in r) + " | "
                + "/".join(f"{x:.4f}" for x in graph[w])
                for w, r in runs.items())
            + f"); default {red} W={lanes}; plain "
            f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms by "
            f"{t['bound_by']} ({t['pairs']} pairs, {t['pairs_in_support']} "
            f"in support) | {card}")


def record_times(name, fl, bd, dims, dims_b, cfg, alt, best, gbest, cc):
    """The record kernel's numbers of pass ``name`` from its ladder rungs,
    and its pack's beside the pack's plain version (best of two runs of 5
    calls, events) and the pack's bound on the bytes the walk needs of it:
    the operand's real slots and probes read once (``operand_bytes``), and
    written once the {x, y, z, m} record of each real slot and probed
    padding slot and the j side of each real slot, the same for the
    boundary's records; the j side's operations per real slot -> a
    record."""
    from cpp_fluid_particles_tpu_torch.utils.check import time_ms
    lanes, red, unroll = cc.RECORD_DEFAULTS[name]
    key = record_rung(lanes, red, unroll)
    plain = [time_ms(lambda: cc.pack_records_plain(name, fl, bd, cfg), 5)
             for _ in range(2)]
    real, probes = occupancy(fl)
    nbytes = operand_bytes(fl) + 16 * (real + probes) \
        + (4 if name == "surface" else 8) * real
    if bd is not None:
        nbytes += operand_bytes(bd) + 16 * sum(occupancy(bd))
    flops = (5 if name == "surface" else 8) * real
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    rec = {"record_lanes": lanes, "record_reduction": red,
           "record_unroll": unroll, "record_ms": best[key],
           "record_graph_ms": gbest[key],
           "walk_graph_ms": gbest[record_rung(lanes, red, unroll,
                                              walk=True)],
           "pack": {"ms": best["pack"], "graph_ms": gbest["pack"],
                    "plain_ms": min(plain), "bytes": nbytes, "flops": flops,
                    "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops > t_bytes
                    else "bytes"}}
    if alt is not None:
        rec["record_other_order_graph_ms"] = gbest[
            record_rung(lanes, red, unroll, alt[0])]
    return rec


class _Stop(Exception):
    pass


def operands(sim, ds, pp, bx, torch, name, dt) -> dict:
    """The operands of pass ``name``'s first call in one step from
    ``sim``'s state (every pass before it runs on the card as the steps run
    it), with the step's slot list in cell-major order (``work``) and the
    same slots in the particles' order (``slots``)."""
    full, full_b = sim._dims()
    got = {}

    def first(n, fl, bd, dims, dims_b, cfg, islots=None):
        if n == name:
            got.update(fl=fl, bd=bd, dims=dims, dims_b=dims_b, work=islots)
            raise _Stop
        return pp.column_pass(n, fl, bd, dims, dims_b, cfg, islots=islots)
    try:
        ds.DENSE_STEPS[sim.solver_name](sim.state, sim.carry, sim.scene,
                                        sim.cfg, dt, full, full_b, sim.box,
                                        executor=first)
    except _Stop:
        pass
    idx = bx.build_box_index(sim.state.pos, sim.cfg, full, got["dims"])
    if not torch.equal(idx.work, got["work"]):
        raise AssertionError(f"{name}: the step's slot list is not the "
                             "index's cell-major list")
    got["slots"] = idx.slots
    return got


def million_divergence(cfp, ds, pp, cc, torch, card):
    """Phase 6 at scale: the first divergence pass of a DFSPH step from the
    1M recipe's state after its warm-up frame (``scaled_dam_scene``, fast
    mode, one device) at the pass's default variant, against the plain
    executor and timed in turns on the work list and on the slots in the
    particles' order (work, slots, slots, work; events and graph) -> a
    record."""
    from cpp_fluid_particles_tpu_torch.ops import box as bx
    from cpp_fluid_particles_tpu_torch.utils.check import (
        row_errors, time_graph_ms, time_ms)
    t0 = time.perf_counter()
    cfg, pos = cfp.scaled_dam_scene(1_000_000)
    sim = cfp.Simulation(solver="dfsph", cfg=cfg, fluid_pos=pos,
                         device="cuda")
    name = "divergence"
    op = operands(sim, ds, pp, bx, torch, name, cfp.BENCH_DT["dfsph"])
    fl, bd, dims, dims_b = (op[k] for k in ("fl", "bd", "dims", "dims_b"))
    want = pp.column_pass_plain(name, fl, bd, dims, dims_b, cfg)
    lanes, red = cc.default_lanes(name), cc.default_reduction(name)
    rec = {"n": op["work"].shape[0], "K": dims.k, "Kb": dims_b.k,
           "grid": [dims.gx, dims.gy, dims.gz], "lanes": lanes,
           "reduction": red}
    fns = {}
    order = ("work", "slots")
    for lst in order:
        fns[lst] = (lambda lst=lst: cc.particle_pass_cuda(
            name, fl, bd, op[lst], dims, dims_b, cfg, lanes=lanes,
            reduction=red))
        got = launch_twice(f"1M {name} on {lst}", fns[lst], torch)
        rec[f"{lst}_max_abs_err"], rec[f"{lst}_max_rel_err"] = \
            row_errors(f"1M {name} on {lst}", got, want)
    for lst in order + order[::-1]:
        rec.setdefault(f"{lst}_ms", []).append(time_ms(fns[lst], 20))
        rec.setdefault(f"{lst}_graph_ms", []).append(
            time_graph_ms(fns[lst], 20))
    rec.update(pass_bound(pp, torch, name, fl, bd, dims, dims_b, cfg, 1))
    rec["wall_s"] = time.perf_counter() - t0
    log("timing", f"{name} at the 1M recipe's state after its warm-up frame "
        f"(N={rec['n']}, K={dims.k}, Kb={dims_b.k}, grid {dims.gx}x{dims.gy}"
        f"x{dims.gz}, {red} W={lanes}; the work list, the slots in the "
        f"particles' order, and back; events | graph ms): " + "; ".join(
            f"{lst} " + "/".join(f"{x:.4f}" for x in rec[f"{lst}_ms"])
            + " | " + "/".join(f"{x:.4f}" for x in rec[f"{lst}_graph_ms"])
            + f", vs plain max_err/row_max {rec[f'{lst}_max_rel_err']:.3e}"
            for lst in order)
        + f"; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
        f"({rec['pairs']} pairs, {rec['pairs_in_support']} in support); "
        f"{rec['wall_s']:.1f} s | {card}")
    return rec


def flat_phase(cfg, cc, pp, torch, card):
    """Phase 7: the flat prototype's entry point, its functions called as
    its main() calls them -> a record."""
    from cpp_fluid_particles_tpu_torch.exp import flat_pallas_proto as fp
    pos, vel = fp.dam_state("cuda")
    fl, dims = fp.build_grid(pos, vel, cfg)     # raises on any overflow
    cc.reset_launch_counts()
    outs = fp.run(fl, dims, cfg)
    torch.cuda.synchronize()
    launched = {k: n for k, n in cc.LAUNCHES.items() if n}
    if launched != {f"flat_{body}": 1 for body in fp.BODIES}:
        raise AssertionError(f"flat path launches: {launched}")
    log("flat", f"n={pos.shape[0]} K={dims.k} overflow=0 G={dims.g} "
        f"P={dims.flat_p}: the state after {fp.STATE_FRAMES} WCSPH frames "
        f"of the dam; path launches {launched}")
    bodies = {}
    for body, out in outs.items():
        rec = fp.compare(body, fl, dims, cfg, out)
        rec.update(fp.time_body(body, fl, dims, cfg))
        name = pp.FLAT_BODIES[body]
        rec.update(pass_bound(pp, torch, name, fp.operand(body, fl), None,
                              dims, None, cfg, out.shape[0]))
        rec["launches"] = launched[f"flat_{body}"]
        rec["bricks_ladder"] = fp.time_bricks(body, fl, dims, cfg, out)
        bodies[body] = rec
        log("flat", f"{body} ({name}, fluid only) K={dims.k} G={dims.g} "
            f"brick={tuple(rec['brick'])} shared={rec['shared_bytes']} B, "
            f"{rec['busy_bricks']} of {rec['bricks']} bricks hold fluid: "
            f"vs plain max_abs_err={rec['max_abs_err']:.3e} "
            f"max_err/row_max={rec['max_rel_err']:.3e}, vs untiled "
            f"max_err/row_max={rec['untiled_max_rel_err']:.3e} (bitwise "
            f"{'equal' if rec['bitwise_equal_untiled'] else 'not equal'}), "
            f"bitwise_repeat=yes | tiled {rec['ms']:.4f} ms, untiled "
            f"{rec['untiled_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms "
            f"(plain,untiled,tiled,tiled,untiled,plain = "
            + ",".join(f"{t:.4f}" for t in rec["runs_ms"])
            + f"); bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
            f"({rec['bytes']} B, {rec['flops']} FLOP, {rec['pairs']} pairs, "
            f"{rec['pairs_in_support']} in support) | {card}")
        log("flat", f"{body} K={dims.k} tiled kernel on each brick that "
            f"fits, bitwise equal, best of two runs (in the order of the "
            f"bricks and back): {fp.ladder_line(rec['bricks_ladder'])} | "
            f"{card}")
    return {"n": pos.shape[0], "K": dims.k, "G": dims.g, "P": dims.flat_p,
            "launches": launched, "bodies": bodies}


def gif_frame_count(data: bytes) -> int:
    """Image descriptors in a GIF89a, walked block by block."""
    if data[:6] != b"GIF89a":
        raise AssertionError("not a GIF89a")
    i = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)
    n = 0
    while data[i] != 0x3B:
        if data[i] == 0x21:          # extension: introducer, label
            i += 2
        elif data[i] == 0x2C:        # image: descriptor, LZW code size
            n += 1
            i += 11
        else:
            raise AssertionError(f"GIF block {data[i]:#x} at {i}")
        while data[i]:               # data sub-blocks up to the 0 length
            i += data[i] + 1
        i += 1
    return n


def app_run(cfp, ds, cc, torch, argv):
    """``simulate.main(argv)`` on the card, as a user runs the CLI, with
    the launch counts reset just before it and read just after; its
    make_sim wrapped so that the Simulation it builds is kept and its
    solver's step tallied -> (sim, args, stats)."""
    from cpp_fluid_particles_tpu_torch import simulate
    made = []
    make_sim = simulate.make_sim

    def kept(args):
        name = cfp.resolve_solver(args.solver)
        tl = Tally(ds, name)
        sim = build_tallied(ds, name, tl, lambda: make_sim(args))
        made.append((sim, tl, len(tl.frames)))
        return sim

    simulate.make_sim = kept
    try:
        cc.reset_launch_counts()
        t0 = time.perf_counter()
        rc = simulate.main(argv)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(cc.LAUNCHES)
    finally:
        simulate.make_sim = make_sim
    args = simulate.build_argparser().parse_args(argv)
    if rc != 0:
        raise AssertionError(f"simulate {' '.join(argv)} returned {rc}")
    (sim, tl, ctor_frames), = made
    if sim.device.type != "cuda":
        raise AssertionError(f"the CLI ran on {sim.device}")
    check_final(sim, args.steps, torch)
    st = {"solver": sim.solver_name, "argv": argv, "frames": sim.frame,
          "fluid": sim.fluid_size, "K": sim.max_per_cell,
          "box": list(sim.box), "retries": sim.retries,
          "dropped_frames": 0, "launches": launches,
          "rerun_frames": len(tl.frames), "ctor_frames": ctor_frames,
          "wall_s": wall_s, "wall_ms_per_frame": wall_s * 1e3 / sim.frame,
          "step_ms_per_frame": sim.total_ms / sim.frame}
    for key in ITER_KEYS + ("host_syncs",):
        if key in tl.frames[0]:
            st[key] = tl.column(key, torch)
    return sim, args, st


def render_ops(fn, torch, calls=5, top=6):
    """Device time of fn (a render) by torch op, from torch.profiler over
    ``calls`` calls after a warm-up -> [(op, ms per call)], the ``top``
    largest, and the total. An ``aten::`` op's self device time is that
    of the kernels it launched; the kernels' own entries are left out, so
    nothing counts twice."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / calls)
                   for e in prof.key_averages()
                   if e.key.startswith("aten::")
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    return rows[:top], sum(ms for _, ms in rows)


def app_phase(cfp, ds, cc, torch, card):
    """Phase 8: the README's first command through the port's CLI on the
    card: 100 frames of the default fast PBD dam rendered every 4th frame
    at 700 px into a GIF, and 50 parity WCSPH frames into a PNG; the
    launch identities of each path, the card's render of the final state
    against the CPU's (``utils.check.render_errors``), and the render's
    ms per call -> a record."""
    from cpp_fluid_particles_tpu_torch.runtime import native
    from cpp_fluid_particles_tpu_torch.simulate import make_camera
    from cpp_fluid_particles_tpu_torch.utils.check import (render_errors,
                                                           time_ms)
    from cpp_fluid_particles_tpu_torch.utils.render import (draw_cube_edges,
                                                            render)
    out_dir = ROOT / "chiprun_out" / "app"
    out_dir.mkdir(parents=True, exist_ok=True)
    gif, png = out_dir / "dam.gif", out_dir / "wcsph_parity.png"
    runs = {}
    for tag, argv in (
            ("pbd_gif", ["--steps", str(APP_STEPS), "--render-every",
                         str(APP_EVERY), "--size", "700", "--gif", str(gif),
                         "--quiet"]),
            ("wcsph_png", ["--solver", "wcsph", "--parity", "--steps",
                           str(APP_PNG_STEPS), "--png", str(png),
                           "--quiet"])):
        sim, args, st = app_run(cfp, ds, cc, torch, argv)
        if tag == "pbd_gif":
            if sim.cfg != cfp.dam_break_config():
                raise AssertionError(f"the CLI built {sim.cfg}")
            n = gif_frame_count(gif.read_bytes())
            if n != APP_STEPS // APP_EVERY:
                raise AssertionError(f"GIF has {n} frames")
            st["gif_frames"], st["gif_bytes"] = n, gif.stat().st_size
            tail = pbd_checks(st, sim.cfg)
        else:
            if png.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("no PNG header")
            n = st["rerun_frames"]
            expect_launches(st, dict(launched("surface_pressure", n),
                                     particle_density_colorgrad_visc=n))
            tail = ""
        drop_columns(st)
        # the card's render of the final state against the CPU's
        cam = make_camera(args)
        pos, rho = sim.state.pos, sim.state.density
        cube = draw_cube_edges(device="cuda")
        img = render(pos, rho, cam, *cube)
        share, rest = render_errors(f"app {tag} card vs cpu", img, render(
            pos.cpu(), rho.cpu(), cam, *draw_cube_edges()))
        draw = lambda: render(pos, rho, cam, *cube)  # noqa: E731
        ops, busy = render_ops(draw, torch)
        st.update(render_ms=time_ms(draw, 20), render_px=cam.width,
                  render_outlier_share=share, render_max_err_rest=rest,
                  render_device_ms=busy, render_top_ops=ops)
        runs[tag] = st
        log("app", f"simulate {' '.join(argv)}: {st['fluid']} fluid, "
            f"{st['frames']} frames, K={st['K']} box={tuple(st['box'])} "
            f"retries={st['retries']} dropped_frames=0 launches="
            f"{ {k: v for k, v in st['launches'].items() if v} }{tail} | "
            f"card vs cpu render: {share:.4%} of pixels over 1e-3, others "
            f"within {rest:.3e} | {card}")
        del sim
    encoder = "native" if native.available() else "python"
    for tag, st in runs.items():
        log("app", f"{tag}: render {st['render_ms']:.3f} ms per call at "
            f"{st['render_px']} px (CUDA events, 20 calls), device "
            f"{st['render_device_ms']:.3f} ms by op (torch.profiler, 5 "
            "calls): " + ", ".join(f"{k} {ms:.3f}"
                                   for k, ms in st['render_top_ops'])
            + "; CLI "
            f"{st['wall_ms_per_frame']:.3f} ms/frame wall (steps, renders, "
            f"fetches and image writing; {st['wall_s']:.2f} s), steps "
            f"{st['step_ms_per_frame']:.3f} ms/frame (CUDA events); GIF "
            f"encoder {encoder} | {card}")
    return {"runs": runs, "gif_encoder": encoder}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_ranks(tag, cases, ranks, device, backend, out_dir, data_dir,
               extra=()):
    """``exp/mesh_run.py`` on ``ranks`` processes under the environment
    contract (ranks 0: one process without a mesh) -> (each rank's
    results, wall seconds). ``device(rank)`` is the rank's device,
    ``extra`` more arguments of the entry point (``--mesh2d``); each
    rank's log goes to ``out_dir``, its results (tens of MB at 1M) to
    ``data_dir``. Every process is stopped before this returns; a rank
    that fails stops all."""
    from cpp_fluid_particles_tpu_torch.exp import mesh_run
    n, port, procs = max(ranks, 1), free_port(), []
    t0 = time.perf_counter()
    try:
        for r in range(n):
            env = dict(os.environ, PYTHONPATH=str(ROOT),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(n), RANK=str(r), LOCAL_RANK=str(r))
            argv = [sys.executable, "-m",
                    "cpp_fluid_particles_tpu_torch.exp.mesh_run", "--out",
                    str(data_dir / f"{tag}_{r}.npz"), "--device", device(r)]
            argv += (["--single"] if ranks == 0
                     else ["--backend", backend, *extra])
            with open(out_dir / f"{tag}_{r}.log", "w") as f:
                procs.append(subprocess.Popen(
                    argv + list(cases), env=env, cwd=str(ROOT), stdout=f,
                    stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() - t0 > MESH_TIMEOUT:
                raise AssertionError(f"[mesh] {tag}: no end within "
                                     f"{MESH_TIMEOUT} s")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (out_dir / f"{tag}_{r}.log").read_text()[-4000:]
            raise AssertionError(f"[mesh] {tag} rank {r} exited "
                                 f"{p.returncode}:\n{tail}")
    return [mesh_run.load(str(data_dir / f"{tag}_{r}.npz"))
            for r in range(n)], wall


def same_as_single(ref, got, tag):
    """A rank's result of a case against the single-device one: bitwise
    state, equal metrics every frame, equal retries and capacity."""
    import numpy as np
    m, want = got["meta"], ref["meta"]
    for key in ("pos", "vel", "density"):
        a = np.ascontiguousarray(got[key]).view(np.int32)
        b = np.ascontiguousarray(ref[key]).view(np.int32)
        if not np.array_equal(a, b):
            raise AssertionError(
                f"[mesh] {tag} {m['case']} rank {m['rank']}: {key} differs "
                f"from the single-device run in {int((a != b).sum())} words")
    for key in ("metrics", "retries", "capacity", "dropped_frames"):
        if m[key] != want[key]:
            raise AssertionError(f"[mesh] {tag} {m['case']} rank "
                                 f"{m['rank']}: {key} {m[key]} != "
                                 f"single-device {want[key]}")


def mesh_launches(res, tag, ref=None):
    """Every kernel of the case's path launched on this rank, each as often
    as in the single-device run ``ref`` where given; no column kernel."""
    m = res["meta"]
    solver = m["case"].split(":")[0].split("-")[0]
    missing = [k for k in MESH_KERNELS[solver] if not m["launches"].get(k)]
    column = {k: v for k, v in m["launches"].items()
              if not k.startswith(("particle_", "pack_", "record_")) and v}
    if missing or column:
        raise AssertionError(f"[mesh] {tag} {m['case']} rank {m['rank']}: "
                             f"not launched {missing}, column kernel "
                             f"{column}")
    if ref is not None:
        want = {k: v for k, v in ref["meta"]["launches"].items() if v}
        got = {k: v for k, v in m["launches"].items() if v}
        if got != want:
            raise AssertionError(f"[mesh] {tag} {m['case']} rank "
                                 f"{m['rank']}: launches {got} != "
                                 f"single-device {want}")


def block_text(m, box):
    """The rank's block of a box of size ``box``, as the mesh split it."""
    from cpp_fluid_particles_tpu_torch.parallel.mesh import plane_split
    if not m["backend"]:
        return "the whole box"
    nx, nz = m["mesh"]
    ix, iz = divmod(m["rank"], nz)
    x0, x1 = plane_split(box[0], nx)[ix]
    if nz == 1:
        return f"planes {(x0, x1)} of {box[0]}"
    z0, z1 = plane_split(box[2], nz)[iz]
    return f"block x {(x0, x1)} z {(z0, z1)} of {box[0]} x {box[2]}"


def mesh_line(tag, res, note=""):
    """One rank's line: scene, capacity, block, launches, collectives per
    frame run (exchanges per axis), iterations, ms/frame."""
    m = res["meta"]
    runs = 1 + m["frames"] + m["retries"]   # warm-up and re-runs included
    k, box = m["capacity"][-1]
    h = m["halo"]
    launches = {key.replace("particle_", "", 1): v for key, v in
                sorted(m["launches"].items()) if v}
    iters = {key: [f.get(key) for f in m["metrics"]]
             for key in ITER_KEYS if key in m["metrics"][0]}
    axes = ", ".join(
        f"{a} {h.get(f'exchanges_{a}', 0) / runs:.2f} "
        f"({h.get(f'exchange_bytes_{a}', 0) / runs / 1e6:.3f} MB)"
        for a in "xz")
    return (f"{tag} {m['case']} rank {m['rank']}/{m['ranks']} "
            f"({m['backend'] or 'one device'} on {m['device']}, mesh "
            f"{m['mesh']}): "
            f"{m['fluid']:,} fluid + {m['boundary']:,} boundary, K {k}, box "
            f"{box}, {block_text(m, box)}, retries {m['retries']}; "
            f"launches {launches}; per frame run: exchanges "
            f"{h.get('exchanges', 0) / runs:.2f} "
            f"({h.get('exchange_bytes', 0) / runs / 1e6:.3f} MB sent; by "
            f"axis {axes}), "
            f"all-reduces {h.get('all_reduce', 0) / runs:.2f} "
            f"({h.get('all_reduce_bytes', 0) / runs / 1e6:.3f} MB), "
            f"all-gathers {h.get('all_gather', 0) / runs:.2f} "
            f"({h.get('all_gather_bytes', 0) / runs / 1e6:.3f} MB); staged "
            f"through host memory: {m['staged'] or 'nothing'}; iterations "
            f"{iters}; {sum(m['ms']) / m['frames']:.3f} ms/frame (CUDA "
            f"events{note}); {m['wall_s']:.1f} s in the process")


def mesh_phase(torch, card):
    """Phase 9: the mesh runs (a) to (e) against the single-device run of
    the same cases."""
    out_dir = ROOT / "chiprun_out" / "mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as data:
        record = _mesh_phase(torch, card, out_dir, Path(data))
    (out_dir / "phase.json").write_text(json.dumps(record, indent=1))
    return record


def _mesh_phase(torch, card, out_dir, data_dir):
    t0 = time.perf_counter()
    cases = (MESH_1M,) + MESH_DAM
    (ref,), wall = mesh_ranks("single", cases, 0, lambda r: "cuda:0", None,
                              out_dir, data_dir)
    record = {"single": {"wall_s": wall, "meta": [r["meta"] for r in ref]}}
    for res in ref:
        mesh_launches(res, "single")
        log("mesh", mesh_line("single", res))
    log("mesh", f"single-device runs: {wall:.1f} s wall | {card}")
    ngpu = torch.cuda.device_count()
    nx, nz = (int(a) for a in MESH_2D.split("x"))
    mesh2d = ("--mesh2d", MESH_2D)
    runs = [("a", cases, 2, lambda r: "cuda:0", "gloo", (),
             "; 2 ranks sharing one card: not a scaling figure"),
            ("b", (MESH_1M,), 1, lambda r: "cuda", "nccl", (), ""),
            ("d", (MESH_1M, "pbd:dam:100"), nx * nz, lambda r: "cuda:0",
             "gloo", mesh2d,
             f"; {nx * nz} ranks sharing one card: not a scaling figure")]
    if ngpu > 1:
        runs.append(("c", (MESH_1M,), ngpu, lambda r: "cuda", "nccl", (),
                     f"; {ngpu} ranks, one per GPU"))
    if ngpu >= nx * nz:
        runs.append(("e", (MESH_1M,), nx * nz, lambda r: "cuda", "nccl",
                     mesh2d, f"; {nx * nz} ranks, one per GPU"))
    for tag, cs, ranks, device, backend, extra, note in runs:
        got, wall = mesh_ranks(tag, cs, ranks, device, backend, out_dir,
                               data_dir, extra)
        for rank_res in got:
            for res in rank_res:
                single = ref[cases.index(res["meta"]["case"])]
                same_as_single(single, res, tag)
                mesh_launches(res, tag, single)
                h = res["meta"]["halo"]
                if not extra and h.get("exchanges_z"):
                    raise AssertionError(f"[mesh] ({tag}) a 1-D mesh made "
                                         f"z exchanges: {h}")
                log("mesh", mesh_line(f"({tag})", res, note) + " | bitwise "
                    "equal to the single-device run, metrics and launches "
                    "equal")
        log("mesh", f"({tag}) {ranks} rank(s) over {backend}"
            f"{' as a ' + MESH_2D + ' mesh' if extra else ''}: {wall:.1f} s "
            f"wall | {card}")
        record[tag] = {"wall_s": wall,
                       "meta": [[r["meta"] for r in rank_res]
                                for rank_res in got]}
    if ngpu <= 1:
        log("mesh", f"(c) one rank per GPU over NCCL did not run: "
            f"{ngpu} GPU visible, and NCCL refuses two ranks on one GPU")
    if ngpu < nx * nz:
        log("mesh", f"(e) the {MESH_2D} mesh over NCCL, one rank per GPU, "
            f"did not run: {ngpu} GPU(s) visible, it needs {nx * nz}")
    record["c_ran"] = ngpu > 1
    record["e_ran"] = ngpu >= nx * nz
    record["wall_s"] = time.perf_counter() - t0
    log("mesh", f"phase wall {record['wall_s']:.1f} s | {card}")
    return record


def kernel_row(name, paths, owner, errs, times, pp, cc):
    """The kernels-table row of pass ``name``. The PARTICLE_PASSES give
    the particle-list kernel, which their paths run: its launches, errors,
    and event and graph ms at the pass's default width and reduction
    (``cc.default_lanes``, ``cc.default_reduction``) on the list its path
    gives it, with the column kernel's ms, the width, the reduction, the
    list's order and, where the ladder had them, the graph ms on the same
    slots in the other order beside them."""
    t = times[name]
    row = {"name": name, "route": "cuda", "source": KERNEL_SRC,
           "replaces": TPU_KERNEL, "launches": 0,
           "max_abs_err": errs[name]["max_abs_err"], "ms": t["ms"],
           "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "library_ms": None}
    key = name
    if name in pp.PARTICLE_PASSES:
        key = f"particle_{name}"
        row.update(max_abs_err=errs[key]["max_abs_err"],
                   ms=t["particle_ms"], graph_ms=t["graph_ms"],
                   column_kernel_ms=t["column_kernel_ms"], lanes=t["lanes"],
                   reduction=t["reduction"])
        if t["order"] is not None:
            row["order"] = t["order"]
        if "other_order_graph_ms" in t:
            row["other_order_graph_ms"] = t["other_order_graph_ms"]
    if name in cc.RECORD_IDS:
        # the path's kernel is the record kernel, its pack included; the
        # particle-list kernel's default beside it
        key = f"record_{name}"
        row.update(max_abs_err=errs[key]["max_abs_err"], ms=t["record_ms"],
                   graph_ms=t["record_graph_ms"],
                   particle_ms=t["particle_ms"],
                   particle_graph_ms=t["graph_ms"],
                   walk_graph_ms=t["walk_graph_ms"],
                   pack_graph_ms=t["pack"]["graph_ms"],
                   lanes=t["record_lanes"], reduction=t["record_reduction"],
                   unroll=t["record_unroll"],
                   wins_both_passes=t["record_wins_both_passes"])
        if "record_other_order_graph_ms" in t:
            row["other_order_graph_ms"] = t["record_other_order_graph_ms"]
    if name in STATE:
        row["state"] = STATE[name]
    if name == "density":
        row["b_mass_max_rel_err"] = errs["b_mass"]["max_rel_err"]
    if name in OFF_PATH:
        row["note"] = OFF_PATH[name]
    else:
        row["launches"] = paths[owner.get(name, "dfsph")]["launches"][key]
    return row


def pack_row(name, paths, owner, errs, times):
    """The kernels-table row of pass ``name``'s pack kernel, which its path
    launches once per call of the record kernel."""
    pk = times[name]["pack"]
    return {"name": f"pack_{name}", "route": "cuda", "source": KERNEL_SRC,
            "replaces": TPU_KERNEL,
            "launches": paths[owner.get(name, "dfsph")]["launches"][
                f"pack_{name}"],
            "max_abs_err": errs[f"pack_{name}"]["max_abs_err"],
            "ms": pk["ms"], "graph_ms": pk["graph_ms"],
            "plain_ms": pk["plain_ms"], "bound_ms": pk["bound_ms"],
            "bound_by": pk["bound_by"], "library_ms": None,
            "note": f"the records {name}'s record kernel walks, packed once "
                    "per call"}


def main(argv) -> int:
    import torch
    if argv not in ([], ["--mesh"]):
        print("usage: python3 chip_smoke.py [--mesh]", file=sys.stderr)
        return 2
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
    build_log = lib.with_suffix(".log").read_text()
    ptxas = ptxas_report(build_log)
    regs = {}
    for name in cc.PASS_IDS:
        r, sp, _ = ptxas_entry(ptxas, "column_pass_kernel", name, False)
        regs[name] = {"registers": r, "spill_bytes": sp}
    for name in pp.PARTICLE_PASSES:
        for lanes, red in sorted(cc.variants(name),
                                 key=lambda v: (v[1], v[0])):
            r, sp, _ = ptxas_entry(ptxas, "particle_pass_kernel", name,
                                   False, lanes, red == "transpose")
            regs[f"particle_{name}_W{lanes}_{red}"] = {
                "registers": r, "spill_bytes": sp}
    for name in cc.RECORD_IDS:
        r, sp, _ = ptxas_entry(ptxas, "pack_kernel", name, False)
        regs[f"pack_{name}"] = {"registers": r, "spill_bytes": sp}
        for lanes, red in sorted(cc.variants(name),
                                 key=lambda v: (v[1], v[0])):
            for unroll in cc.UNROLLS:
                r, sp, _ = ptxas_entry(ptxas, "record_pass_kernel", name,
                                       False, lanes, red == "transpose",
                                       unroll)
                regs[f"record_{name}_W{lanes}_{red}_U{unroll}"] = {
                    "registers": r, "spill_bytes": sp}
    flat_regs = {}
    for body, name in pp.FLAT_BODIES.items():
        rows = pp.PASSES[name].fi
        for tiled, kernel in ((True, "flat_pass_kernel"),
                              (False, "column_pass_kernel")):
            r, sp, smem = ptxas_entry(ptxas, kernel, name, True)
            flat_regs[f"{'flat' if tiled else 'untiled'}_{body}"] = {
                "registers": r, "spill_bytes": sp, "static_smem": smem,
                "dynamic_smem_k24": (cc.flat_brick(rows, 24)[1]
                                     if tiled else 0)}
    record["build_s"], record["ptxas"] = build_s, dict(regs, **flat_regs)
    log("build", f"{KERNEL_SRC} -> {lib.name} in {build_s:.1f} s; "
        "registers/spill bytes: " + "; ".join(
            f"{n} {r['registers']}/{r['spill_bytes']}"
            for n, r in regs.items())
        + " | fluid-only instances, registers/spill bytes/static shared + "
        "dynamic shared at K 24: " + "; ".join(
            f"{n} {r['registers']}/{r['spill_bytes']}/{r['static_smem']}"
            f"+{r['dynamic_smem_k24']}" for n, r in flat_regs.items()))
    if argv == ["--mesh"]:
        mesh_phase(torch, card)
        print(card, flush=True)
        return 0

    cfg = cfp.dam_break_config(mode="parity")
    errs, times, paths, failed = {}, {}, {}, []

    def guard(what, fn):
        """fn() -> its value; a failure is logged and kept, and the phases
        after it still run, so one failure does not hide another."""
        try:
            return fn()
        except Exception:
            traceback.print_exc()
            last = traceback.format_exc().strip().splitlines()[-1]
            log("fail", f"{what}: {last}")
            failed.append(what)
            return None

    for solver, phase in (("wcsph", "slice"), ("dfsph", "dfsph"),
                          ("pbd", "pbd")):
        dt = cfp.BENCH_DT[solver]
        guard(f"{solver} at frame 0 (phases 3-4)", functools.partial(
            frame0_phase, cfp, ds, pp, cc, torch, cfg, solver, dt, errs))
        res = guard(f"{solver} path (phase {phase})", functools.partial(
            path_phase, cfp, ds, cc, torch, cfg, solver, phase, dt, card))
        if res is None:
            continue
        sim, paths[solver] = res
        guard(f"{solver} at frame {FRAMES} (phases 3, 6)", functools.partial(
            final_phase, sim, ds, pp, cc, torch, cfg, solver, dt, card, errs,
            times))
        del sim, res

    # 6 at scale: divergence at the 1M recipe's state
    record["divergence_1m"] = guard("divergence at 1M (phase 6)",
                                    functools.partial(
                                        million_divergence, cfp, ds, pp, cc,
                                        torch, card))

    # 5d. the default: Simulation(device="cuda"), PBD in fast mode
    st = guard("pbd_default (phase 5d)", functools.partial(
        default_phase, cfp, ds, cc, torch, card))
    if st is not None:
        paths["pbd_default"] = st

    # 5e. the surface-off instances on their own paths
    off = surface_off(cfg)
    for solver in ("wcsph", "dfsph", "pbd"):
        st = guard(f"{solver} surface off (phase 5e)", functools.partial(
            off_phase, cfp, ds, cc, torch, off, solver, card))
        if st is not None:
            paths[f"{solver}_surface_off"] = st

    # 7. flat: the prototype's entry point on the 150-frame WCSPH dam
    record["flat"] = flat = guard("flat (phase 7)", functools.partial(
        flat_phase, cfg, cc, pp, torch, card))

    # 8. app: the simulate CLI on the card
    record["app"] = guard("app (phase 8)", functools.partial(
        app_phase, cfp, ds, cc, torch, card))

    # 9. mesh: the README's multi-GPU recipe through Simulation(mesh=...)
    record["mesh"] = guard("mesh (phase 9)", functools.partial(
        mesh_phase, torch, card))

    record["paths"], record["times"], record["errors"] = paths, times, errs
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "column_pass_build.log").write_text(build_log)
    if failed:
        record["failed"] = failed
        (out_dir / "chip_smoke.json").write_text(
            json.dumps(record, indent=1, default=str))
        log("fail", f"{len(failed)} phase(s) failed: {'; '.join(failed)}")
        print(card, flush=True)
        return 1
    owner = {"density": "wcsph", "density_colorgrad_visc": "wcsph",
             "surface_pressure": "wcsph", "density_visc": "wcsph_surface_off",
             "pressure_force": "wcsph_surface_off",
             "density_alpha": "dfsph_surface_off", "pbd_lambda": "pbd",
             "xsph_colorgrad": "pbd", "xsph": "pbd_surface_off"}
    table = {"kernels": [kernel_row(name, paths, owner, errs, times, pp,
                                    cc)
                         for name in cc.PASS_IDS]
        + [pack_row(name, paths, owner, errs, times)
           for name in cc.RECORD_IDS]
        + [{"name": f"flat_{body}", "route": "cuda", "source": KERNEL_SRC,
            "replaces": FLAT_TPU_KERNEL, "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "untiled_ms": rec["untiled_ms"]}
           for body, rec in flat["bodies"].items()]}
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(dict(record, table=table), indent=1))
    print(json.dumps(table), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def frame0_phase(cfp, ds, pp, cc, torch, cfg, solver, dt, errs):
    """Phases 3 and 4 at frame 0 (the state after the constructor's
    warm-up): every pass against plain, then one step against plain (for
    WCSPH and DFSPH also with surface effects off)."""
    probe = cfp.Simulation(solver=solver, cfg=cfg, device="cuda")
    compare_passes(f"{solver} frame0", capture(probe, ds, pp, dt), cfg, pp,
                   cc, torch, errs)
    if solver == "wcsph":
        scene_mass_vs_plain(probe, ds, pp, torch, errs)
    step_vs_plain(probe, ds, pp, torch, dt)
    if solver != "pbd":
        step_vs_plain(probe, ds, pp, torch, dt, cfg=surface_off(cfg))


def path_phase(cfp, ds, cc, torch, cfg, solver, phase, dt, card):
    """Phases 5, 5b and 5c: the solver's 300-frame path with its launch
    identities -> (sim, stats)."""
    sim, st = drive(cfp, ds, cc, torch, cfg, solver, dt, FRAMES,
                    tally=(solver != "wcsph"))
    frames_run = st["rerun_frames"]
    if solver == "wcsph":
        # each frame run (warm-up, retries included) launches both WCSPH
        # passes once, each through the particle-list kernel, plus the
        # scene build's particle_density launch
        expect_launches(st, dict(launched("surface_pressure", frames_run),
                                 particle_density_colorgrad_visc=frames_run))
        log(phase, slice_line(st, card))
    elif solver == "dfsph":
        # per frame run: one density_alpha_colorgrad, viscosity and
        # surface through the particle-list kernel; divergence ==
        # stiffness_accel (the divergence warm start is on; the
        # particle-list kernel runs both), at least 5 (1 + 1 + >= 1
        # divergence iterations and 1 + 1 + >= 2 density iterations of
        # each); the column kernel launches nothing
        expect_launches(st, dict(launched("surface", frames_run),
                                 particle_density_alpha_colorgrad=frames_run,
                                 particle_viscosity=frames_run,
                                 particle_divergence=(5 * frames_run, None),
                                 particle_stiffness_accel=(5 * frames_run,
                                                           None)))
        divergence_is_stiffness_accel(st)
        cap = cfg.dfsph_max_iter
        di, ni = st["divergence_iters"], st["density_iters"]
        if not (min(di) >= 1 and max(di) <= cap and min(ni) >= 2
                and max(ni) <= cap):
            raise AssertionError(f"iterations out of bounds: divergence "
                                 f"{min(di)}-{max(di)}, density "
                                 f"{min(ni)}-{max(ni)}, cap {cap}")
        # over the frames run after the constructor's warm-up
        after = slice(st["ctor_frames"], None)
        di, ni, hs = di[after], ni[after], st["host_syncs"][after]
        st["mean_iters"] = [sum(di) / len(di), sum(ni) / len(ni)]
        st["host_syncs_per_frame"] = sum(hs) / len(hs)
        log(phase, slice_line(st, card) + f" | per frame run: "
            f"divergence iters {st['mean_iters'][0]:.2f} "
            f"({min(di)}-{max(di)}), density iters "
            f"{st['mean_iters'][1]:.2f} ({min(ni)}-{max(ni)}), Jacobi "
            f"host syncs {st['host_syncs_per_frame']:.2f} (plus one "
            f"capacity fetch per chunk)")
    else:
        log(phase, slice_line(st, card) + pbd_checks(st, cfg))
    drop_columns(st)
    return sim, st


def final_phase(sim, ds, pp, cc, torch, cfg, solver, dt, card, errs,
                times):
    """Phases 3 (after the run) and 6 at the path's final shapes; the
    ladder also runs each pass whose slot list is the box index's of this
    state on the index's slots in the other order."""
    from cpp_fluid_particles_tpu_torch.ops import box as bx
    from cpp_fluid_particles_tpu_torch.ops.dense import DenseDims
    calls = capture(sim, ds, pp, dt)
    compare_passes(f"{solver} frame{FRAMES}", calls, cfg, pp, cc, torch,
                   errs)
    dims, _ = sim._dims()
    idx = bx.build_box_index(sim.state.pos, sim.cfg, dims,
                             DenseDims(*sim.box, dims.k))

    def orders(islots):
        if torch.equal(islots, idx.work):
            return "work", "slots", idx.slots
        if torch.equal(islots, idx.slots):
            return "slots", "work", idx.work
        return None
    time_passes(calls, cfg, pp, cc, torch, card, times, orders, solver)


def default_phase(cfp, ds, cc, torch, card):
    """Phase 5d: ``Simulation(device="cuda")`` as a user builds it, PBD in
    fast mode -> stats."""
    sim, st = drive(cfp, ds, cc, torch, None, None, cfp.BENCH_DT["pbd"],
                    FRAMES, tally=True)
    if sim.solver_name != "pbd" or sim.cfg != cfp.dam_break_config():
        raise AssertionError(f"Simulation() built {sim.solver_name} with "
                             f"{sim.cfg}")
    log("pbd_default", slice_line(st, card) + pbd_checks(st, sim.cfg))
    drop_columns(st)
    return st


def off_phase(cfp, ds, cc, torch, off, solver, card):
    """Phase 5e for one solver: a short surface-off run -> stats."""
    sim, st = drive(cfp, ds, cc, torch, off, solver, cfp.BENCH_DT[solver],
                    OFF_FRAMES, tally=(solver == "pbd"))
    n, tail = st["rerun_frames"], ""
    if solver == "wcsph":
        expect_launches(st, {"particle_density_visc": n,
                             "particle_pressure_force": n})
    elif solver == "dfsph":
        expect_launches(st, {"particle_density_alpha": n,
                             "particle_viscosity": n,
                             "particle_divergence": (5 * n, None),
                             "particle_stiffness_accel": (5 * n, None)})
        divergence_is_stiffness_accel(st)
    else:
        tail = pbd_checks(st, off, off=True)
        drop_columns(st)
    log("off", f"{solver} surface off: " + slice_line(st, card) + tail)
    return st


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
