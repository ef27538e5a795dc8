"""The PyTorch port's app layer on the CPU against the JAX package: the
renderer, the metrics, the PNG / GIF writers, the ``simulate`` CLI (headless,
interactive) and the HTTP viewer.

Bars, stated once: the density colormap within atol 1e-6; the GIF palette,
PNG bytes and GIF bytes bitwise; a render at most 0.5% of pixels over 1e-3
from JAX's and the others within 1e-5 (``utils.check.render_errors``);
diagnostics within rtol 1e-6; the stats line character for character.
"""

import io
import json
import math
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu import simulate as jsim
from cpp_fluid_particles_tpu.utils import images as jimages
from cpp_fluid_particles_tpu.utils import metrics as jmetrics
from cpp_fluid_particles_tpu.utils import render as jrender

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch import simulate as tsim
from cpp_fluid_particles_tpu_torch.runtime import native as tnative
from cpp_fluid_particles_tpu_torch.utils import images as timages
from cpp_fluid_particles_tpu_torch.utils import io as tio
from cpp_fluid_particles_tpu_torch.utils import metrics as tmetrics
from cpp_fluid_particles_tpu_torch.utils import render as trender
from cpp_fluid_particles_tpu_torch.utils import viewer as tviewer
from cpp_fluid_particles_tpu_torch.utils.check import render_errors

from helpers import SMALL_CFG as JCFG, small_block

torch.set_num_threads(2)

TCFG = T.dam_break_config(**{f: getattr(JCFG, f)
                             for f in JCFG.__dataclass_fields__})
REPO = Path(__file__).resolve().parents[1]

# (rot_x, rot_y, zoom, cube edges): the 96 px view and the zoom-3 close-up
# (where the 16 px sprite clamp binds) of tests/test_render_envelope.py, and
# the view with the cube outline
VIEWS = {"view": (15.0, -25.0, 0.3, False),
         "closeup": (10.0, -20.0, 3.0, False),
         "cube": (15.0, -25.0, 0.3, True)}


def _scene(n=160, seed=3):
    """The 160-particle scene of tests/test_render_envelope.py:70-74."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0.15, 0.85, (n, 3)).astype(np.float32)
    density = rng.uniform(0.6, 1.2, (n,)).astype(np.float32)
    return pos, density


def _render_both(pos_j, rho_j, pos_t, rho_t, cam, cube):
    """JAX's render of (pos_j, rho_j) and the port's of (pos_t, rho_t) at
    the same camera -> two numpy images."""
    jex = jrender.draw_cube_edges() if cube else (None, None)
    tex = trender.draw_cube_edges() if cube else (None, None)
    want = np.array(jrender.render(jnp.asarray(pos_j), jnp.asarray(rho_j),
                                   cam, *jex))
    got = trender.render(torch.as_tensor(pos_t), torch.as_tensor(rho_t),
                         trender.Camera(*cam), *tex).numpy()
    return got, want


# ----------------------------------------------------------------------
# renderer

def test_density_colormap_matches_jax():
    d = np.random.default_rng(11).uniform(0.3, 1.3, 1000).astype(np.float32)
    want = np.asarray(jrender.density_colormap(jnp.asarray(d)))
    got = trender.density_colormap(torch.as_tensor(d)).numpy()
    assert got.dtype == np.float32 and got.shape == (1000, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_renderer_palette_bitwise():
    got, want = trender.renderer_palette(), jrender.renderer_palette()
    assert got.dtype == np.uint8 and got.shape == (256, 3)
    np.testing.assert_array_equal(got, want)


def test_renderer_constants_and_camera_match_jax():
    for name in ("NAVY", "WHITE", "MAGENTA", "BACKGROUND", "MAX_SPRITE"):
        assert getattr(trender, name) == getattr(jrender, name)
    assert tuple(trender.Camera()) == tuple(jrender.Camera())
    assert trender.Camera._fields == jrender.Camera._fields


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_render_matches_jax(view):
    rx, ry, zoom, cube = VIEWS[view]
    cam = jrender.Camera(rot_x=rx, rot_y=ry, zoom=zoom, width=96, height=96)
    pos, rho = _scene()
    if view == "closeup":
        # the unclamped sprite size (the renderer's own formula) passes 16
        eye = (pos.astype(np.float64) - 0.5) @ np.asarray(
            jrender._rotation(rx, ry), np.float64).T - [0, 0, 1 / zoom]
        size = (cam.point_radius * cam.height
                / math.tan(math.radians(cam.fov) / 2)
                / np.linalg.norm(eye, axis=-1))
        assert size.max() > jrender.MAX_SPRITE
    got, want = _render_both(pos, rho, pos, rho, cam, cube)
    assert got.shape == (96, 96, 3) and np.isfinite(got).all()
    share, rest = render_errors(view, got, want)
    print(f"{view}: {share:.4%} of pixels over 1e-3, others within "
          f"{rest:.3e}")


def test_render_moves_extra_points_to_pos_device():
    pos, rho = _scene(20)
    cube = trender.draw_cube_edges(samples_per_edge=8)
    assert cube[0].shape == (96, 3) and cube[0].device.type == "cpu"
    img = trender.render(torch.as_tensor(pos), torch.as_tensor(rho),
                         trender.Camera(width=32, height=32), *cube)
    assert img.shape == (32, 32, 3) and img.dtype == torch.float32
    assert bool(((img >= 0) & (img <= 1)).all())


# ----------------------------------------------------------------------
# metrics

def _seeded_states():
    rng = np.random.default_rng(7)
    pos = small_block()
    js = J.make_fluid_state(pos, JCFG)
    js = js._replace(
        vel=jnp.asarray(rng.normal(0, 0.3, pos.shape).astype(np.float32)),
        density=jnp.asarray(rng.uniform(0.8, 1.2, len(pos))
                            .astype(np.float32)))
    return js, T.FluidState(**{k: torch.as_tensor(np.array(v))
                               for k, v in js._asdict().items()})


def test_physical_diagnostics_match_jax():
    js, ts = _seeded_states()
    want = jmetrics.physical_diagnostics(js, JCFG)
    got = tmetrics.physical_diagnostics(ts, TCFG)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == () and v.device == ts.pos.device
        np.testing.assert_allclose(v.item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("field", T.FluidState._fields)
def test_nan_guard(field):
    js, ts = _seeded_states()
    ok = tmetrics.nan_guard(ts)
    assert ok.dtype == torch.bool and ok.shape == () and bool(ok)
    bad = getattr(ts, field).clone()
    bad.view(-1)[3] = float("nan")
    bad_j = np.array(getattr(js, field))
    bad_j.reshape(-1)[3] = np.nan
    assert not bool(tmetrics.nan_guard(ts._replace(**{field: bad})))
    assert not bool(jmetrics.nan_guard(js._replace(**{field: bad_j})))


def test_step_timer_lines_equal_jax():
    ms = np.random.default_rng(2).uniform(0.01, 4000.0, 40).tolist()
    ms += [0.0, 1e-12, 12345.678]
    jt, tt = jmetrics.StepTimer(), tmetrics.StepTimer()
    for x in ms:
        assert tt.record(x) == jt.record(x)
    for _ in range(10001 - len(ms)):
        assert tt.record(1.5) == jt.record(1.5)   # the frame wraps at 1e4
    assert tt.frames == jt.frames and tt.total_ms == jt.total_ms


def test_profiler_trace(tmp_path):
    with tmetrics.profiler_trace(None):
        pass
    with tmetrics.profiler_trace(str(tmp_path / "prof")):
        torch.ones(8).cumsum(0)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


# ----------------------------------------------------------------------
# image writers

def _frames(n=3, h=24, w=32):
    rng = np.random.default_rng(3)
    return [rng.random((h, w, 3)).astype(np.float32) for _ in range(n)]


def test_png_bytes_equal_jax(tmp_path):
    for img in _frames(2) + [timages.to_uint8(_frames(1)[0])]:
        assert timages.png_bytes(img) == jimages.png_bytes(img)
    timages.write_png(str(tmp_path / "t.png"), _frames(1)[0])
    assert (tmp_path / "t.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("palette", ["renderer", "cube"])
def test_gif_bytes_equal_jax(tmp_path, palette):
    """The port's pure-Python encoder against the JAX package's, and with
    the renderer palette the CLI's path too (``write_gif``: the native
    encoder where g++ builds it). The JAX side needs no build: the JAX
    package's own tests build its native encoder. With the default 6x7x6
    cube the native encoders of both packages write another palette
    rounding than the Python ones, so that path is compared only with the
    renderer palette, as tests/test_utils.py:100-116 does."""
    pal = trender.renderer_palette() if palette == "renderer" else None
    frames = _frames()
    jimages._write_gif_py(str(tmp_path / "j.gif"), frames, 12, pal)
    want = (tmp_path / "j.gif").read_bytes()
    timages._write_gif_py(str(tmp_path / "p.gif"), frames, 12, pal)
    assert (tmp_path / "p.gif").read_bytes() == want
    if pal is not None:
        timages.write_gif(str(tmp_path / "t.gif"), frames, fps=12,
                          palette=pal)
        assert (tmp_path / "t.gif").read_bytes() == want
    assert _gif_frame_count(want) == len(frames)


def test_native_gif_matches_python_encoder(tmp_path):
    """The port's native encoder (cfp_write_gif_pal) against its
    pure-Python encoder with the renderer palette, bitwise, as
    tests/test_utils.py:100-116 holds the JAX package's."""
    if not tnative.available():
        pytest.skip("no C++ toolchain")
    so = Path(tnative._SO)
    assert so.parent.name == "_build" and so.parent.parent.name == \
        "cpp_fluid_particles_tpu_torch"
    frames = _frames(2)
    pal = trender.renderer_palette()
    tnative.write_gif(str(tmp_path / "n.gif"),
                      [timages.to_uint8(f) for f in frames], 12, palette=pal)
    timages._write_gif_py(str(tmp_path / "p.gif"), frames, 12, pal)
    assert (tmp_path / "n.gif").read_bytes() == \
        (tmp_path / "p.gif").read_bytes()


def _gif_frame_count(data: bytes) -> int:
    """Image descriptors in a GIF89a, walked block by block."""
    assert data[:6] == b"GIF89a"
    i = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)
    n = 0
    while data[i] != 0x3B:
        if data[i] == 0x21:          # extension: introducer, label
            i += 2
        else:                        # image: descriptor, LZW code size
            assert data[i] == 0x2C
            n += 1
            i += 11
        while data[i]:               # data sub-blocks up to the 0 length
            i += data[i] + 1
        i += 1
    return n


# ----------------------------------------------------------------------
# the CLI

@pytest.fixture
def small_cli(monkeypatch):
    """Both packages' ``make_sim`` build the small parity block of
    tests/helpers.py (the port's on the device the CLI was given); the
    sims built are recorded."""
    made = {"port": [], "jax": []}

    def port_sim(args):
        sim = T.Simulation(solver=args.solver, cfg=TCFG,
                           fluid_pos=small_block(), device=args.device)
        made["port"].append(sim)
        return sim

    def jax_sim(args):
        sim = J.Simulation(solver=args.solver, cfg=JCFG,
                           fluid_pos=small_block())
        made["jax"].append(sim)
        return sim

    monkeypatch.setattr(tsim, "make_sim", port_sim)
    monkeypatch.setattr(jsim, "make_sim", jax_sim)
    return made


CLI_PNG = ["--solver", "wcsph", "--steps", "3", "--size", "96",
           "--render-every", "1", "--quiet"]


def test_cli_png_matches_jax_cli(tmp_path, small_cli):
    """Three WCSPH steps of the same block through both packages' CLI; the
    port's render of its final state against JAX's render of JAX's."""
    png = tmp_path / "t.png"
    assert tsim.main(["--device", "cpu", "--png", str(png)] + CLI_PNG) == 0
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert jsim.main(["--png", str(tmp_path / "j.png")] + CLI_PNG) == 0
    (ts,), (js,) = small_cli["port"], small_cli["jax"]
    assert ts.frame == js.frame == 3 and ts.device.type == "cpu"
    args = tsim.build_argparser().parse_args(CLI_PNG)
    cam = jsim.make_camera(args)
    assert tuple(tsim.make_camera(args)) == tuple(cam)
    got, want = _render_both(np.asarray(js.state.pos),
                             np.asarray(js.state.density),
                             ts.state.pos.numpy(), ts.state.density.numpy(),
                             cam, cube=True)
    share, rest = render_errors("cli", got, want)
    print(f"cli: {share:.4%} of pixels over 1e-3, others within {rest:.3e}")


def test_cli_gif_frames(tmp_path, small_cli):
    gif = tmp_path / "t.gif"
    rc = tsim.main(["--device", "cpu", "--solver", "wcsph", "--steps", "4",
                    "--render-every", "2", "--size", "48", "--gif", str(gif),
                    "--quiet"])
    assert rc == 0
    assert _gif_frame_count(gif.read_bytes()) == 4 // 2


def test_cli_checkpoint_resume(tmp_path, small_cli, monkeypatch):
    ck = tmp_path / "c.npz"
    base = ["--device", "cpu", "--solver", "wcsph", "--quiet"]
    assert tsim.main(base + ["--steps", "2", "--checkpoint-out",
                             str(ck)]) == 0
    (first,) = small_cli["port"]
    loaded, load_checkpoint = [], tio.load_checkpoint

    def load(path, device):
        sim = load_checkpoint(path, device=device)
        loaded.append((sim, sim.state.pos.clone()))
        return sim

    monkeypatch.setattr(tio, "load_checkpoint", load)
    assert tsim.main(base + ["--steps", "1", "--checkpoint-in", str(ck)]) == 0
    assert len(small_cli["port"]) == 1            # no new scene was built
    (sim, pos0), = loaded
    assert sim.solver_name == "wcsph" and sim.device.type == "cpu"
    torch.testing.assert_close(pos0, first.state.pos, rtol=0, atol=0)
    assert sim.frame == 3
    first.step()
    torch.testing.assert_close(sim.state.pos, first.state.pos, rtol=0,
                               atol=1e-6)


def test_cli_needs_a_card_unless_told_cpu():
    """No card here: without --device cpu the CLI raises Simulation's
    RuntimeError and runs nothing on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tsim.main(["--solver", "wcsph", "--steps", "1", "--quiet"])


def test_cli_unported_engine_exits_nonzero():
    out = subprocess.run(
        [sys.executable, "-m", "cpp_fluid_particles_tpu_torch.simulate",
         "--device", "cpu", "--engine", "pallas", "--steps", "1"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr
    assert "engine 'pallas' is not ported" in out.stderr


def test_cli_interactive(tmp_path, small_cli, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "stdin", io.StringIO("n\n1\nq\n"))
    rc = tsim.main(["--device", "cpu", "--solver", "pbd", "--interactive",
                    "--size", "48"])
    assert rc == 0
    assert (tmp_path / "frames" / "current.png").read_bytes()[:8] == \
        b"\x89PNG\r\n\x1a\n"
    (sim,) = small_cli["port"]
    # key 1 restarted the same scene with WCSPH, on the same device
    assert sim.solver_name == "wcsph" and sim.frame == 0
    assert sim.device.type == "cpu" and sim.state.pos.device.type == "cpu"
    out = capsys.readouterr().out
    assert "Key 1 - Restart Simulation Using SPH Solver" in out
    assert "Frame 1 - " in out


# ----------------------------------------------------------------------
# the HTTP viewer

def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read(), dict(r.headers)


def _post(url, body, timeout=30):
    req = urllib.request.Request(url, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_viewer_end_to_end():
    """tests/test_viewer.py's check on the port, device "cpu": the page,
    long-polled frames, stats, pause, single step, rotate, quit."""
    sim = T.Simulation(solver="wcsph", cfg=TCFG, fluid_pos=small_block(),
                       device="cpu")
    args = tsim.build_argparser().parse_args(
        ["--serve", "0", "--size", "96", "--render-every", "2",
         "--dt", "0.002", "--device", "cpu"])
    rc = {}
    ready = threading.Event()

    def on_ready(port):
        rc["port"] = port
        ready.set()

    def run():
        rc["code"] = tviewer.serve_loop(
            sim, args, tsim.make_camera, trender.draw_cube_edges,
            trender.render, timages, tmetrics.StepTimer, port=0,
            frames_budget=10_000, on_ready=on_ready)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(120), "viewer server did not start"
    base = f"http://127.0.0.1:{rc['port']}"

    page, _ = _get(base + "/")
    assert b"keydown" in page and b"/frame.png" in page

    png, hdrs = _get(base + "/frame.png?gen=0")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    gen1 = int(hdrs["X-Gen"])
    assert gen1 >= 1

    body, _ = _get(base + "/stats")
    assert json.loads(body)["line"].startswith(("Frame", "starting"))

    for _ in range(600):
        if sim.frame > 0:
            break
        t.join(0.2)
    assert sim.frame > 0, "simulation loop did not advance"

    # pause (waiting on the viewer's own pause state), then single-step
    _post(base + "/key", " ")
    paused = False
    for _ in range(1200):
        t.join(0.5)
        body, _ = _get(base + "/stats")
        if json.loads(body).get("running") is False:
            paused = True
            break
    assert paused, "pause key did not stop the loop"
    f0 = sim.frame
    _post(base + "/key", "n")
    for _ in range(300):
        t.join(0.1)
        if sim.frame == f0 + 1:
            break
    assert sim.frame == f0 + 1

    # mouse-drag rotate + zoom keys produce a new frame generation
    _post(base + "/key", "m 30 10")
    _post(base + "/key", ",")
    hdrs2 = hdrs
    for _ in range(300):
        _png2, hdrs2 = _get(base + "/frame.png?gen=" + str(gen1))
        if int(hdrs2["X-Gen"]) > gen1:
            break
        t.join(0.1)
    assert int(hdrs2["X-Gen"]) > gen1

    _post(base + "/key", "q")
    t.join(60)
    assert not t.is_alive() and rc["code"] == 0
    assert bool(torch.isfinite(sim.state.pos).all())
