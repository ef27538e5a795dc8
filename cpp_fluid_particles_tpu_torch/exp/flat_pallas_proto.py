"""The flat-grid prototype's entry point on the port: its three fluid-only
bodies over the lane-major grid of a dam state, kernel against plain.

Port of exp/flat_pallas_proto.py:129-228. That script reads a WCSPH dam
state, builds the full-domain flat ghosted grid at K = 24 over [pos3, mass,
vel3], and holds its Pallas kernel ``flat_pallas_pass`` against the plain
27-offset loop (``xla27``) for the bodies density, sa and dcv, then times
both. Here the kernel is the brick-tiled CUDA kernel
(``ops/column_pass_cuda.flat_pass_cuda``), held against the plain executor
and against the untiled kernel on the same functor, and the three are timed
with CUDA events, the tiled kernel also on each brick that fits. Run from
the repository root:

    python -m cpp_fluid_particles_tpu_torch.exp.flat_pallas_proto \\
        [--state npz] [--device cuda|cpu]

With no ``--state`` (an npz with ``pos`` and ``vel``, as
exp/zsplit_bench.py writes) the state is made as exp/zsplit_bench.py makes
it: 150 WCSPH frames of the parity dam at ``BENCH_DT["wcsph"]``. The device
defaults to "cuda" and there is no fallback; on "cpu" the bodies run
through the plain executor only, untimed.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import BENCH_DT, SimConfig, dam_break_config
from ..ops.dense import DenseDims, build_dense_index, dims_for, fill_dense
from ..ops.grid import POS_PAD
from ..ops.passes import (FLAT_BODIES, PASSES, column_pass_plain,
                          flat_pallas_pass)
from ..simulation import Simulation
from ..utils.check import row_errors, time_ms

K = 24                  # slots per cell, as the prototype (:136)
BODIES = tuple(FLAT_BODIES)
STATE_FRAMES = 150      # exp/zsplit_bench.py:59-66: 6 chunks of 25
CHUNK = 25


def dam_state(device):
    """-> (pos, vel) after 150 WCSPH frames of the parity dam."""
    sim = Simulation(solver="wcsph", cfg=dam_break_config(mode="parity"),
                     device=device)
    for _ in range(STATE_FRAMES // CHUNK):
        sim.run_scan(CHUNK, BENCH_DT["wcsph"])
    return sim.state.pos, sim.state.vel


def load_state(path: str, device):
    """-> (pos, vel) from an npz with (N, 3) arrays ``pos`` and ``vel``."""
    with np.load(path) as d:
        pos, vel = (np.asarray(d[key], np.float32) for key in ("pos", "vel"))
    return (torch.as_tensor(pos, device=device),
            torch.as_tensor(vel, device=device))


def build_grid(pos, vel, cfg: SimConfig, k: int = K):
    """The prototype's grid (:133-143): the full-domain index at k slots
    per cell and one fill of [pos3, mass, vel3] -> (fl (7, k, G), dims).
    Raises ValueError when a cell holds more than k particles: none is
    dropped."""
    dims = dims_for(cfg, k)
    idx = build_dense_index(pos, cfg, dims)
    overflow = int(idx.overflow)
    if overflow:
        raise ValueError(f"{overflow} particles do not fit K={k} slots "
                         f"(fullest cell {int(idx.max_occupancy)})")
    mass = torch.full((pos.shape[0],), cfg.m0, dtype=torch.float32,
                      device=pos.device)
    fl = fill_dense(idx, [pos[:, 0], pos[:, 1], pos[:, 2], mass,
                          vel[:, 0], vel[:, 1], vel[:, 2]],
                    [POS_PAD] * 3 + [0.0] * 4, dims)
    return fl, dims


def operand(body: str, fl: torch.Tensor) -> torch.Tensor:
    """The leading rows of fl that ``body`` reads: [pos3, mass] for
    density, [pos3, mass, vel_x] for sa (vel_x stands in for s, as the
    prototype's sa_terms reads row 4), all seven for dcv."""
    return fl[:PASSES[FLAT_BODIES[body]].fi]


def run(fl: torch.Tensor, dims: DenseDims, cfg: SimConfig):
    """Each body through ``flat_pallas_pass`` -> {body: (n_out, K, G)}."""
    return {body: flat_pallas_pass(body, operand(body, fl), dims, cfg)
            for body in BODIES}


def check_output(body: str, out: torch.Tensor, fl: torch.Tensor,
                 dims: DenseDims) -> None:
    """Finite, and exactly zero on the first and last flat_p cells and on
    every empty slot."""
    p = dims.flat_p
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{body}: non-finite output")
    if bool(out[:, :, :p].any()) or bool(out[:, :, -p:].any()):
        raise AssertionError(f"{body}: non-zero output on the ghost ends")
    if bool(out[:, fl[0] >= POS_PAD / 2].any()):
        raise AssertionError(f"{body}: non-zero output on an empty slot")


def busy_bricks(fl: torch.Tensor, dims: DenseDims, brick) -> tuple:
    """-> (bricks holding a real slot, bricks): the blocks of the tiled
    kernel that have pairs to sum, of all it launches."""
    occ = (fl[0] < POS_PAD / 2).any(0).reshape(dims.gx, dims.gy, dims.gz)
    n = [-(-g // b) for g, b in zip(occ.shape, brick)]
    occ = torch.nn.functional.pad(
        occ, [0, n[2] * brick[2] - dims.gz, 0, n[1] * brick[1] - dims.gy,
              0, n[0] * brick[0] - dims.gx])
    busy = occ.reshape(n[0], brick[0], n[1], brick[1], n[2], brick[2])
    return int(busy.any(5).any(3).any(1).sum()), n[0] * n[1] * n[2]


def compare(body: str, fl: torch.Tensor, dims: DenseDims, cfg: SimConfig,
            tiled: torch.Tensor):
    """On the card: ``tiled`` (a tiled launch's output) against a second
    tiled launch (bitwise), the untiled kernel and the plain executor (per
    row within ``utils.check.PASS_BAR``); each launch must count once -> a
    record."""
    from ..ops import column_pass_cuda as cc
    x = operand(body, fl)
    before = dict(cc.LAUNCHES)
    again = cc.flat_pass_cuda(body, x, dims, cfg)
    untiled = cc.flat_pass_cuda(body, x, dims, cfg, tiled=False)
    torch.cuda.synchronize()
    made = {f"flat_{body}": 1, f"untiled_{body}": 1}
    counted = {k: n - before[k] for k, n in cc.LAUNCHES.items()
               if n != before[k]}
    if counted != made:
        raise AssertionError(f"{body}: launches counted {counted}, made "
                             f"{made}")
    if not torch.equal(tiled, again):
        raise AssertionError(f"{body}: two tiled launches differ")
    plain = column_pass_plain(FLAT_BODIES[body], x, None, dims, None, cfg,
                              fluid_only=True)
    check_output(body, tiled, fl, dims)
    err, rel = row_errors(f"{body} tiled vs plain", tiled, plain)
    err_u, rel_u = row_errors(f"{body} tiled vs untiled", tiled, untiled)
    brick, nbytes = cc.flat_brick(x.shape[0], dims.k)
    busy, bricks = busy_bricks(fl, dims, brick)
    return {"brick": list(brick), "shared_bytes": nbytes,
            "busy_bricks": busy, "bricks": bricks,
            "max_abs_err": err, "max_rel_err": rel,
            "untiled_max_abs_err": err_u, "untiled_max_rel_err": rel_u,
            "bitwise_equal_untiled": bool(torch.equal(tiled, untiled))}


def time_body(body: str, fl: torch.Tensor, dims: DenseDims, cfg: SimConfig):
    """Tiled kernel, untiled kernel and plain executor, in the order plain,
    untiled, tiled, tiled, untiled, plain; each the best of its two runs
    -> {"ms", "untiled_ms", "plain_ms", "runs_ms"}."""
    from ..ops import column_pass_cuda as cc
    x = operand(body, fl)
    fns = {"tiled": lambda: cc.flat_pass_cuda(body, x, dims, cfg),
           "untiled": lambda: cc.flat_pass_cuda(body, x, dims, cfg,
                                                tiled=False),
           "plain": lambda: column_pass_plain(
               FLAT_BODIES[body], x, None, dims, None, cfg, fluid_only=True)}
    reps = {"tiled": 50, "untiled": 50, "plain": 5}
    order = ("plain", "untiled", "tiled", "tiled", "untiled", "plain")
    runs = [(kind, time_ms(fns[kind], reps[kind])) for kind in order]
    best = {kind: min(ms for k, ms in runs if k == kind) for kind in fns}
    return {"ms": best["tiled"], "untiled_ms": best["untiled"],
            "plain_ms": best["plain"], "runs_ms": [ms for _, ms in runs]}


def time_bricks(body: str, fl: torch.Tensor, dims: DenseDims,
                cfg: SimConfig, tiled: torch.Tensor):
    """On the card: the tiled kernel on every brick of BRICKS that fits this
    K, each output bitwise equal to ``tiled`` (the brick changes no order of
    summation), timed in the order of BRICKS and back, each the best of its
    two runs -> [{"brick", "shared_bytes", "busy_bricks", "bricks", "ms",
    "runs_ms"}]."""
    from ..ops import column_pass_cuda as cc
    x = operand(body, fl)
    fits = [b for b in cc.BRICKS
            if cc.brick_bytes(x.shape[0], dims.k, b) <= cc.SHARED_LIMIT]
    for b in fits:
        if not torch.equal(cc.flat_pass_cuda(body, x, dims, cfg, brick=b),
                           tiled):
            raise AssertionError(f"{body}: brick {b} differs from the "
                                 f"default brick's output")
    runs = {b: [] for b in fits}
    for b in fits + fits[::-1]:
        runs[b].append(time_ms(
            lambda: cc.flat_pass_cuda(body, x, dims, cfg, brick=b), 50))
    out = []
    for b in fits:
        busy, bricks = busy_bricks(fl, dims, b)
        out.append({"brick": list(b),
                    "shared_bytes": cc.brick_bytes(x.shape[0], dims.k, b),
                    "busy_bricks": busy, "bricks": bricks,
                    "ms": min(runs[b]), "runs_ms": runs[b]})
    return out


def ladder_line(ladder) -> str:
    return "; ".join(
        f"{tuple(r['brick'])} {r['shared_bytes']} B, {r['busy_bricks']} of "
        f"{r['bricks']} bricks hold fluid: {r['ms']:.4f} ms" for r in ladder)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cpp_fluid_particles_tpu_torch.exp.flat_pallas_proto",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--state", help="npz with pos and vel (default: 150 "
                    "WCSPH frames of the parity dam)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs an NVIDIA GPU "
                           "(torch.cuda.is_available() is False)")
    cfg = dam_break_config(mode="parity")
    pos, vel = (load_state(args.state, device) if args.state
                else dam_state(device))
    fl, dims = build_grid(pos, vel, cfg, K)
    print(f"n={pos.shape[0]} K={dims.k} overflow=0 G={dims.g} "
          f"P={dims.flat_p} device={device}", flush=True)
    outs = run(fl, dims, cfg)
    for body, out in outs.items():
        check_output(body, out, fl, dims)
        if device.type == "cpu":
            print(f"{body}: plain executor (the CPU runs no kernel and is "
                  f"not timed): {out.shape[0]} rows, max |out| "
                  f"{float(out.abs().max()):.4e}", flush=True)
            continue
        rec = compare(body, fl, dims, cfg, out)
        rec.update(time_body(body, fl, dims, cfg))
        print(f"{body}: brick={tuple(rec['brick'])} shared="
              f"{rec['shared_bytes']} B, {rec['busy_bricks']} of "
              f"{rec['bricks']} bricks hold fluid | vs plain max_abs_err="
              f"{rec['max_abs_err']:.3e} max_err/row_max="
              f"{rec['max_rel_err']:.3e} | vs untiled max_err/row_max="
              f"{rec['untiled_max_rel_err']:.3e} | bitwise_repeat=yes | "
              f"tiled {rec['ms']:.4f} ms, untiled {rec['untiled_ms']:.4f} "
              f"ms, plain {rec['plain_ms']:.4f} ms on "
              f"{torch.cuda.get_device_name(device)}", flush=True)
        print(f"{body}: bricks, bitwise equal, best of two runs: "
              + ladder_line(time_bricks(body, fl, dims, cfg, out)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
