"""One pass's kernels timed on operands frozen from a dam state, so that two
trees of the port can be held against each other on the same inputs.

    python -m cpp_fluid_particles_tpu_torch.exp.pass_state save \\
        --out DIR [--frames 300] [--device cuda|cpu]
    python -m cpp_fluid_particles_tpu_torch.exp.pass_state time \\
        --state DIR [--turns 4] [--reps 50] [--tag NAME] [--out DIR]

``save`` runs each solver of ``CASES`` on the 20,736-particle parity dam
at the reference's dt (``BENCH_DT``) for ``--frames`` frames, then runs
one more step up to its case's pass and writes that pass's operands as
the step hands them (the grids after the passes before it, the slot list
in the step's order, the shapes and the config) to
``DIR/<solver>_<pass>.npz``. Trajectories of two trees part within a few
hundred frames (other bits, other solver iterations, other K), so their
frame profiles do not compare; these operands do.

``time`` loads every case of ``DIR`` onto the card and runs the tree's
kernels of the pass: the particle-list kernel (``particle_pass_cuda``) at
its default and at each other (width, reduction) it takes, and, where the
tree has it for the pass, the record kernel with its pack
(``record_pass_cuda``) at its default. It holds each against the plain
executor (max abs error) and the record kernel bitwise against the
particle-list kernel at the same (width, reduction), then times them in
turns (in order, then backwards, ...), each turn by one replay of a CUDA
graph of ``--reps`` calls (``time_graph_ms``, the device alone) and by
CUDA events around ``--reps`` calls (``time_ms``, the host's enqueueing
included where the device finishes first). One line and one JSON record
per case; all of them in ``DIR/pass_state_<tag>.json``. Run it from
another tree's root with this file copied into that tree to time its
kernels on the same operands.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..config import BENCH_DT, SimConfig, dam_break_config
from ..ops.dense import DenseDims

# (solver, pass): the two passes of the record kernel, surface on both
# solvers that run it
CASES = (("wcsph", "surface_pressure"), ("dfsph", "surface"),
         ("pbd", "surface"))
CHUNK = 25


class _Stop(Exception):
    pass


def capture(sim, name: str, dt: float) -> dict:
    """The operands of pass ``name``'s first call in one step of ``sim``
    from its state, every pass before it run as the step runs it; the
    state is left as it was -> {name, fl, bd, islots, dims, dims_b, cfg}."""
    from ..models.dense_step import DENSE_STEPS
    from ..ops.passes import column_pass
    full, full_b = sim._dims()
    got = {}

    def first(n, fl, bd, dims, dims_b, cfg, islots=None):
        if n == name:
            got.update(name=n, fl=fl, bd=bd, islots=islots, dims=dims,
                       dims_b=dims_b, cfg=cfg)
            raise _Stop
        return column_pass(n, fl, bd, dims, dims_b, cfg, islots=islots)
    try:
        DENSE_STEPS[sim.solver_name](sim.state, sim.carry, sim.scene,
                                     sim.cfg, dt, full, full_b, sim.box,
                                     executor=first)
    except _Stop:
        pass
    if not got:
        raise ValueError(f"a {sim.solver_name} step runs no {name} pass")
    return got


def save_case(path, case: dict) -> None:
    """Write ``capture``'s operands to the npz ``path``."""
    meta = {"name": case["name"], "dims": list(case["dims"]),
            "dims_b": (None if case["dims_b"] is None
                       else list(case["dims_b"])),
            "cfg": dataclasses.asdict(case["cfg"])}
    arrays = {k: case[k].cpu().numpy() for k in ("fl", "bd", "islots")
              if case[k] is not None}
    np.savez(path, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                          np.uint8), **arrays)


def load_case(path, device) -> dict:
    """``save_case``'s operands on ``device``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: torch.as_tensor(z[k], device=device) for k in z.files
                  if k != "__meta__"}
    cfg = dict(meta["cfg"])
    for key in ("space_size", "gravity"):
        cfg[key] = tuple(cfg[key])
    return {"name": meta["name"], "fl": arrays["fl"],
            "bd": arrays.get("bd"), "islots": arrays["islots"],
            "dims": DenseDims(*meta["dims"]),
            "dims_b": (None if meta["dims_b"] is None
                       else DenseDims(*meta["dims_b"])),
            "cfg": SimConfig(**cfg)}


def save(out: Path, frames: int, device: str) -> None:
    from ..simulation import Simulation
    out.mkdir(parents=True, exist_ok=True)
    for solver, name in CASES:
        dt = BENCH_DT[solver]
        sim = Simulation(solver=solver, cfg=dam_break_config("parity"),
                         device=device)
        while sim.frame < frames:
            sim.run_scan(min(CHUNK, frames - sim.frame), dt)
        case = capture(sim, name, dt)
        save_case(out / f"{solver}_{name}.npz", case)
        print(f"[pass_state] saved {solver} {name} after {sim.frame} "
              f"frames: K {case['dims'].k}, {case['islots'].shape[0]} "
              f"listed", flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_case(case: dict, turns: int, reps: int) -> dict:
    """The tree's kernels of the case's pass against the plain executor,
    timed in turns -> a record. Kernels: "particle", the particle-list
    kernel at its default; "particle <reduction> W<lanes>", the same at
    each other (width, reduction) it takes; "record", the record kernel at
    its default, pack included, held bitwise to the particle-list kernel
    at the same (width, reduction)."""
    from ..ops import column_pass_cuda as cc
    from ..ops.passes import column_pass_plain
    from ..utils.check import time_graph_ms, time_ms
    name, fl, bd, islots = (case[k] for k in ("name", "fl", "bd", "islots"))
    dims, dims_b, cfg = case["dims"], case["dims_b"], case["cfg"]

    def particle(lanes, red):
        return lambda: cc.particle_pass_cuda(name, fl, bd, islots, dims,
                                             dims_b, cfg, lanes=lanes,
                                             reduction=red)
    default = (cc.default_lanes(name), cc.default_reduction(name))
    key = {default: "particle"}
    kernels = {"particle": particle(*default)}
    for lanes, red in cc.variants(name):
        if (lanes, red) != default:
            key[lanes, red] = f"particle {red} W{lanes}"
            kernels[key[lanes, red]] = particle(lanes, red)
    if name in getattr(cc, "RECORD_IDS", ()):
        kernels["record"] = lambda: cc.record_pass_cuda(
            name, fl, bd, islots, dims, dims_b, cfg)
    want = column_pass_plain(name, fl, bd, dims, dims_b, cfg)
    outs = {k: fn() for k, fn in kernels.items()}
    rec = {"pass": name, "K": dims.k, "listed": int(islots.shape[0]),
           "default": list(default),
           "max_abs_err": {k: float((o - want).abs().max())
                           for k, o in outs.items()}}
    if "record" in outs:
        same = key[cc.RECORD_DEFAULTS[name][:2]]
        rec["record_bitwise"] = [same, bool(torch.equal(outs["record"],
                                                        outs[same]))]
    graph = {k: [] for k in kernels}
    events = {k: [] for k in kernels}
    order = list(kernels)
    for turn in range(turns):
        for k in (order if turn % 2 == 0 else order[::-1]):
            graph[k].append(time_graph_ms(kernels[k], reps))
            events[k].append(time_ms(kernels[k], reps))
    rec.update(graph_ms=graph, events_ms=events)
    return rec


def time_all(state: Path, turns: int, reps: int, tag: str,
             out: Path) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("pass_state time needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    smi = card()
    records = []
    for path in sorted(state.glob("*.npz")):
        rec = time_case(load_case(path, "cuda"), turns, reps)
        rec.update(case=path.stem, tag=tag, card=smi)
        records.append(rec)
        print(f"[pass_state] {tag} {path.stem} K {rec['K']}, default "
              f"{rec['default'][1]} W{rec['default'][0]}: "
              + "; ".join(f"{k} graph ms "
                          + "/".join(f"{x:.4f}" for x in rec["graph_ms"][k])
                          + " events ms "
                          + "/".join(f"{x:.4f}" for x in rec["events_ms"][k])
                          + f" max abs err {rec['max_abs_err'][k]:.3g}"
                          for k in rec["graph_ms"])
              + ("" if "record_bitwise" not in rec else
                 f"; record bitwise {rec['record_bitwise'][0]}: "
                 f"{rec['record_bitwise'][1]}") + f" | {smi}",
              flush=True)
        print(json.dumps(rec), flush=True)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"pass_state_{tag}.json").write_text(json.dumps(records,
                                                           indent=1))


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("--out", required=True)
    s.add_argument("--frames", type=int, default=300)
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    t = sub.add_parser("time")
    t.add_argument("--state", required=True)
    t.add_argument("--turns", type=int, default=4)
    t.add_argument("--reps", type=int, default=50)
    t.add_argument("--tag", default="tree")
    t.add_argument("--out", default="chiprun_out")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.cmd == "save":
        save(Path(args.out), args.frames, args.device)
    else:
        time_all(Path(args.state), args.turns, args.reps, args.tag,
                 Path(args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
