"""Real-time browser viewer — the GLUT window equivalent.

Port of ``cpp_fluid_particles_tpu/utils/viewer.py``. The reference opens an
OpenGL window with GLUT keyboard/mouse callbacks (src/main.cpp:354-391,
223-266, 197-221). A GPU server is headless, so the equivalent is a
zero-dependency HTTP server: the simulation loop runs on the main thread
(stepping and rendering on the simulation's device, one fetch per frame),
a background thread serves

  * ``GET /``          — viewer page: live image, stats line, key/mouse
                         capture mirroring the reference bindings
  * ``GET /frame.png`` — the latest rendered frame (long-polls until a
                         new frame is ready, so the page draws at the
                         simulation's own FPS like a vsynced window)
  * ``GET /stats``     — JSON of the ``Frame %d - %.2f ms …`` stats line
                         (src/main.cpp:300-306)
  * ``POST /key``      — key events, identical semantics to the stdin
                         interactive mode (space pause, n step, 1/2/3
                         restart+solver, r/,/. camera, q quit,
                         ``m DX DY`` mouse-drag rotate)

Start with ``python -m cpp_fluid_particles_tpu_torch.simulate --serve 8000``.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_PAGE = """<!doctype html>
<html><head><title>cpp-fluid-particles-tpu (torch)</title><style>
body { background:#111; color:#ddd; font:14px monospace; margin:1em; }
img  { border:1px solid #444; image-rendering:pixelated; }
#s   { white-space:pre; margin:0.5em 0; }
</style></head><body>
<div id="s">connecting…</div>
<img id="v" width="%W%" height="%H%">
<div>space pause · n step · 1/2/3 restart SPH/DFSPH/PBD · r reset view ·
, zoom in · . zoom out · q quit · drag to rotate</div>
<script>
const img = document.getElementById('v');
let gen = 0;
async function loop() {
  for (;;) {
    try {
      const r = await fetch('/frame.png?gen=' + gen);
      gen = r.headers.get('x-gen') || 0;
      const b = await r.blob();
      img.src = URL.createObjectURL(b);
    } catch (e) { await new Promise(t => setTimeout(t, 500)); }
  }
}
async function stats() {
  for (;;) {
    try {
      const r = await (await fetch('/stats')).json();
      document.getElementById('s').textContent = r.line;
      if (r.done) return;
    } catch (e) {}
    await new Promise(t => setTimeout(t, 250));
  }
}
function send(k) { fetch('/key', {method:'POST', body:k}); }
document.addEventListener('keydown', e => {
  if (e.key === ' ') { e.preventDefault(); send(' '); }
  else if (e.key.length === 1) send(e.key);
});
let drag = null;
img.addEventListener('mousedown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('mouseup', () => { drag = null; });
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  if (dx || dy) send('m ' + dx + ' ' + dy);
});
loop(); stats();
</script></body></html>"""


class ViewerState:
    """Thread-shared latest frame + stats + pending key events."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self._lock = threading.Lock()
        self._frame = b""
        self._gen = 0
        self._new_frame = threading.Condition(self._lock)
        self.stats_line = "starting…"
        self.done = False
        self.running = True   # pause state, observable via /stats (the
        #                       test waits on it — frame-counter timing
        #                       cannot distinguish "paused" from "slow")
        self.keys: "queue.Queue[str]" = queue.Queue()

    def push_frame(self, png: bytes) -> None:
        with self._new_frame:
            self._frame = png
            self._gen += 1
            self._new_frame.notify_all()

    def frame(self, after_gen: int, timeout: float = 10.0):
        """Block until a frame newer than ``after_gen`` exists (long poll);
        returns (png, gen)."""
        with self._new_frame:
            self._new_frame.wait_for(
                lambda: self._gen > after_gen or self.done, timeout=timeout)
            return self._frame, self._gen


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body, extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)
            if path[0] == "/":
                page = (_PAGE.replace("%W%", str(state.width))
                        .replace("%H%", str(state.height)))
                self._send(200, "text/html", page.encode())
            elif path[0] == "/frame.png":
                gen = 0
                if len(path) > 1 and "gen=" in path[1]:
                    try:
                        gen = int(path[1].split("gen=")[1].split("&")[0])
                    except ValueError:
                        pass
                png, g = state.frame(gen)
                self._send(200, "image/png", png, [("X-Gen", str(g))])
            elif path[0] == "/stats":
                body = json.dumps({"line": state.stats_line,
                                   "running": state.running,
                                   "done": state.done}).encode()
                self._send(200, "application/json", body)
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path == "/key":
                n = int(self.headers.get("Content-Length", 0))
                state.keys.put(self.rfile.read(n).decode(errors="replace"))
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def start_server(state: ViewerState, port: int,
                 host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Serve ``state`` on a daemon thread; returns the server (call
    ``shutdown()`` when the simulation loop exits)."""
    srv = ThreadingHTTPServer((host, port), _make_handler(state))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


def serve_loop(sim, args, make_camera, draw_cube_edges, render, images,
               StepTimer, port: int, frames_budget: Optional[int] = None,
               host: str = "127.0.0.1", on_ready=None) -> int:
    """The main-thread simulation loop behind ``--serve`` — the
    displayFunc/keyboardFunc pair of the reference (src/main.cpp:308-352,
    223-266) with the window replaced by the HTTP viewer. Starts RUNNING
    (the reference window starts paused=false); ``frames_budget`` bounds
    total frames for tests (None = run until 'q')."""
    cam = make_camera(args)
    cube_pts, cube_cols = draw_cube_edges(device=sim.device)
    state = ViewerState(args.size, args.size)
    srv = start_server(state, port, host)
    print(f"viewer: http://{host}:{srv.server_address[1]}/")
    if on_ready is not None:
        on_ready(srv.server_address[1])
    timer = StepTimer()
    running = True

    def draw():
        img = render(sim.state.pos, sim.state.density, cam, cube_pts,
                     cube_cols).cpu().numpy()
        state.push_frame(images.png_bytes(img))

    draw()
    try:
        while True:
            if frames_budget is not None and sim.frame >= frames_budget:
                return 0
            advanced = False
            if running:
                n = max(1, args.render_every)
                ms = sim.run_scan(n, args.dt) if n > 1 else sim.step(args.dt)
                for _ in range(n):
                    state.stats_line = timer.record(ms)
                advanced = True
            try:
                key = state.keys.get(
                    block=not running, timeout=None if running else 0.25)
            except queue.Empty:
                key = None
            if key is None:
                if advanced:
                    draw()
                continue
            if key[:1] in ("m", "M"):
                try:
                    dx, dy = (float(v) for v in key[1:].split())
                    cam = cam._replace(
                        rot_x=cam.rot_x + dy * 180.0 / 720.0,
                        rot_y=cam.rot_y + dx * 180.0 / 720.0)
                except ValueError:
                    pass
            elif key == " ":
                running = not running
                state.running = running
            elif key in "nN":
                state.stats_line = timer.record(sim.step(args.dt))
            elif key in "123":
                sim.restart({"1": "wcsph", "2": "dfsph", "3": "pbd"}[key])
                timer = StepTimer()
            elif key == ",":
                cam = cam._replace(zoom=cam.zoom * 1.2)
            elif key == ".":
                cam = cam._replace(zoom=cam.zoom / 1.2)
            elif key in "rR":
                cam = make_camera(args)
            elif key in "qQ":
                return 0
            draw()
    finally:
        state.done = True
        state.push_frame(state.frame(-1)[0])  # release long-pollers
        srv.shutdown()
