"""CLI application — the main.cpp equivalent.

Port of ``cpp_fluid_particles_tpu/simulate.py``, with the same flags plus
``--device`` (default ``cuda``; ``cpu`` runs the plain torch path and is
never chosen for the caller). Headless replacement for the reference's GLUT
app (src/main.cpp:354-391): steps the simulation, prints the same
per-frame stats line, and writes rendered frames (PNG / animated GIF)
instead of drawing to a window. An ``--interactive`` mode accepts the
reference's key commands on stdin (src/main.cpp:223-266): space pause
toggle / n single step / 1/2/3 restart with WCSPH/DFSPH/PBD / q quit /
r , . camera.

Usage:
  python -m cpp_fluid_particles_tpu_torch.simulate --solver dfsph \\
      --steps 600 --gif out.gif --render-every 4
"""

from __future__ import annotations

import argparse
import sys

from .config import dam_break_config
from .simulation import Simulation
from .utils import images
from .utils.metrics import StepTimer, physical_diagnostics, profiler_trace
from .utils.render import Camera, draw_cube_edges, render, renderer_palette


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cpp_fluid_particles_tpu_torch.simulate",
        description="GPU SPH dam-break simulator (PyTorch / CUDA)",
    )
    p.add_argument("--solver", default="pbd",
                   help="wcsph|dfsph|pbd or 1|2|3 (default pbd, like the "
                        "reference)")
    p.add_argument("--parity", action="store_true",
                   help="run the solvers in reference-parity mode (fixed-20 "
                        "PBD projection, plain Jacobi DFSPH) instead of the "
                        "validated fast default (PBD tolerance exit + "
                        "Chebyshev)")
    p.add_argument("--scene", default="dam", choices=("dam", "drop"),
                   help="dam: the reference's 36x24x24 dam break "
                        "(src/main.cpp:75-85); drop: a compact cube "
                        "falling onto a resting pool (state.drop_scene)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--dt", type=float, default=None,
                   help="timestep (default: config value 0.002)")
    p.add_argument("--gif", default=None, help="write animated GIF here")
    p.add_argument("--png", default=None,
                   help="write final frame PNG here")
    p.add_argument("--render-every", type=int, default=4)
    p.add_argument("--size", type=int, default=700, help="image size")
    p.add_argument("--rot", type=float, nargs=2, default=(20.0, -30.0),
                   metavar=("RX", "RY"))
    p.add_argument("--zoom", type=float, default=0.45)
    p.add_argument("--fps", type=float, default=25.0)
    p.add_argument("--checkpoint-out", default=None)
    p.add_argument("--checkpoint-in", default=None)
    p.add_argument("--interactive", action="store_true",
                   help="read key commands from stdin")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="real-time browser viewer on this port (the GLUT "
                        "window equivalent; 0 = auto-pick)")
    p.add_argument("--engine", default=None,
                   help="dense|xlab|xla|xla27|pallas|interpret|reference "
                        "(the port runs dense/xlab; the others raise)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the simulation and the renderer run (default "
                        "cuda; raises without a GPU, never falls back)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile", default=None,
                   help="torch.profiler trace directory (Chrome trace)")
    return p


def make_camera(args) -> Camera:
    return Camera(rot_x=args.rot[0], rot_y=args.rot[1], zoom=args.zoom,
                  width=args.size, height=args.size)


def make_sim(args) -> Simulation:
    """Build the Simulation for the selected scene/mode/engine/device
    (shared by the headless, interactive, and serve paths)."""
    mode = "parity" if args.parity else "fast"
    fluid_pos = None
    if args.scene == "drop":
        from .state import drop_scene
        cfg, fluid_pos = drop_scene(mode=mode)
    else:
        cfg = dam_break_config(mode=mode)
    if args.engine:
        cfg = cfg.replace(engine=args.engine)
    return Simulation(solver=args.solver, cfg=cfg, fluid_pos=fluid_pos,
                      device=args.device)


def run_headless(args) -> int:
    if args.checkpoint_in:
        from .utils.io import load_checkpoint
        sim = load_checkpoint(args.checkpoint_in, device=args.device)
    else:
        sim = make_sim(args)
    cam = make_camera(args)
    cube_pts, cube_cols = draw_cube_edges(device=sim.device)

    def draw():
        return render(sim.state.pos, sim.state.density, cam, cube_pts,
                      cube_cols).cpu().numpy()

    timer = StepTimer()
    frames = []

    rendering = bool(args.gif or args.png)
    chunk = max(1, args.render_every) if rendering else min(args.steps, 25)

    with profiler_trace(args.profile):
        done = 0
        while done < args.steps:
            n = min(chunk, args.steps - done)
            # frames between renders run as one chunk: one capacity fetch
            ms = sim.run_scan(n, args.dt) if n > 1 else sim.step(args.dt)
            done += n
            for _ in range(n):
                line = timer.record(ms)
            if not args.quiet:
                print(line, end="\r", flush=True)
            if rendering:
                frames.append(draw())
    if not args.quiet:
        print()
        diag = {k: v.item() for k, v in
                physical_diagnostics(sim.state, sim.cfg).items()}
        print(" ".join(f"{k}={v:.4g}" for k, v in diag.items()))

    if args.gif and frames:
        images.write_gif(args.gif, frames, fps=args.fps,
                         palette=renderer_palette())
        print(f"wrote {args.gif} ({len(frames)} frames)")
    if args.png:
        last = frames[-1] if frames else draw()
        images.write_png(args.png, last)
        print(f"wrote {args.png}")
    if args.checkpoint_out:
        from .utils.io import save_checkpoint
        save_checkpoint(args.checkpoint_out, sim)
        print(f"wrote {args.checkpoint_out}")
    return 0


INSTRUCTIONS = """Instructions
The color indicates the density of a particle.
Magenta means higher density, navy means lesser density.
Controls (type a key then Enter)
Space - Start/Pause
Key N - One Step Forward
Key Q - Quit
Key 1 - Restart Simulation Using SPH Solver
Key 2 - Restart Simulation Using DFSPH Solver
Key 3 - Restart Simulation Using PBD Solver
Key R - Reset Viewpoint
Key , - Zoom In
Key . - Zoom Out
m DX DY - Mouse-drag rotate by (DX, DY) pixels
"""


def run_interactive(args) -> int:
    """stdin-driven loop mirroring keyboardFunc (src/main.cpp:223-266);
    frames go to PNG files under ./frames/."""
    import os
    os.makedirs("frames", exist_ok=True)
    print(INSTRUCTIONS)
    sim = make_sim(args)
    cam = make_camera(args)
    cube_pts, cube_cols = draw_cube_edges(device=sim.device)
    timer = StepTimer()
    running = False
    frame_path = "frames/current.png"

    def draw():
        img = render(sim.state.pos, sim.state.density, cam, cube_pts,
                     cube_cols).cpu().numpy()
        images.write_png(frame_path, img)

    draw()
    print(f"view: {frame_path}")
    while True:
        if running:
            print(timer.record(sim.step()), end="\r", flush=True)
            draw()
        try:
            line = sys.stdin.readline()
        except KeyboardInterrupt:
            return 0
        if not line:
            return 0
        stripped = line.rstrip("\n")
        if stripped[:1] in ("m", "M"):
            # mouse-drag rotate (src/main.cpp:197-221): rot += d * 180/720
            try:
                dx, dy = (float(v) for v in stripped[1:].split())
                cam = cam._replace(rot_x=cam.rot_x + dy * 180.0 / 720.0,
                                   rot_y=cam.rot_y + dx * 180.0 / 720.0)
                draw()
            except ValueError:
                print("usage: m DX DY")
            continue
        for key in (stripped or " "):
            if key == " ":
                running = not running
            elif key in "nN":
                print(timer.record(sim.step()))
                draw()
            elif key in "123":
                sim.restart({"1": "wcsph", "2": "dfsph", "3": "pbd"}[key])
                timer = StepTimer()
                draw()
            elif key == ",":
                cam = cam._replace(zoom=cam.zoom * 1.2); draw()
            elif key == ".":
                cam = cam._replace(zoom=cam.zoom / 1.2); draw()
            elif key in "rR":
                cam = make_camera(args); draw()
            elif key in "qQ":
                return 0


def run_serve(args, frames_budget=None) -> int:
    """Browser-window mode (src/main.cpp:354-391 equivalent): the
    simulation loop on this thread, an HTTP viewer thread serving frames,
    stats, and key events (utils/viewer.py)."""
    from .utils import viewer
    sim = make_sim(args)
    return viewer.serve_loop(sim, args, make_camera, draw_cube_edges,
                             render, images, StepTimer, args.serve,
                             frames_budget=frames_budget)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.serve is not None:
        return run_serve(args)
    if args.interactive:
        return run_interactive(args)
    return run_headless(args)


if __name__ == "__main__":
    raise SystemExit(main())
