"""The port's flat-grid fluid pass against the JAX prototype's Pallas kernel.

``flat_pallas_pass`` of exp/flat_pallas_proto.py:67 runs here in Pallas
interpret mode; the port's ``ops/passes.flat_pallas_pass`` runs its plain
executor on the CPU. Both take the same grid: the full 25^3-cell parity dam
domain (G = 27^3, flat_p = 757), filled from numpy positions and velocities
made from a seed, once by each package. Two scenes: a jittered block and a
seeded splash with multi-occupancy cells. The three bodies (density, sa,
dcv) at tile 512, the prototype's, and 384; the i-window of 18,169 cells
leaves a ragged last tile at both.

Tolerance (``utils.check.row_errors``): per output row, rtol 2e-5 plus atol 2e-5
x the row's max (the JAX package's Pallas bar,
tests/test_pallas_engine.py:125-126). The two
sum each cell's pairs in another order: the prototype one offset's (K_i,
K_j) block at a time through a VMEM accumulator, the port offset by
offset over whole slabs, and sa multiplies m_j in at another point.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpp_fluid_particles_tpu as J
from cpp_fluid_particles_tpu.ops import dense as jdn
from cpp_fluid_particles_tpu.ops import kernels as kn
from cpp_fluid_particles_tpu.ops.grid import POS_PAD as J_POS_PAD

import cpp_fluid_particles_tpu_torch as T
from cpp_fluid_particles_tpu_torch.exp import flat_pallas_proto as fp
from cpp_fluid_particles_tpu_torch.ops import column_pass_cuda as cc
from cpp_fluid_particles_tpu_torch.ops import passes as tpp
from cpp_fluid_particles_tpu_torch.ops.grid import POS_PAD
from cpp_fluid_particles_tpu_torch.ops.passes import flat_pallas_pass
from cpp_fluid_particles_tpu_torch.utils.check import PASS_BAR, row_errors

torch.set_num_threads(2)

JCFG = J.dam_break_config(mode="parity")
TCFG = T.dam_break_config(mode="parity")
TILES = (512, 384)
N_OUT = {body: tpp.PASSES[name].n_out
         for body, name in tpp.FLAT_BODIES.items()}


def _load_prototype():
    """exp/ is no package: load the script by path. It puts its own root
    at the front of sys.path when it runs; the path is restored after, so
    later imports resolve as before."""
    path = Path(__file__).resolve().parents[1] / "exp" / "flat_pallas_proto.py"
    spec = importlib.util.spec_from_file_location("flat_pallas_proto", path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


PROTO = _load_prototype()


def _proto_bodies(cfg):
    """The prototype's bodies, local to its main(): verbatim copies of
    exp/flat_pallas_proto.py:147-188 over the same h and cfg."""
    h = cfg.radius

    def density_terms(i, j):
        _jb = lambda v: v[None, :, :]
        dx = i[0][:, None, :] - j[0][None, :, :]
        dy = i[1][:, None, :] - j[1][None, :, :]
        dz = i[2][:, None, :] - j[2][None, :, :]
        r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        return jnp.sum(_jb(j[3]) * kn.w_cubic(r, h), 1)[None]

    def dcv_terms(i, j):
        _ii = lambda v: v[:, None, :]
        _jb = lambda v: v[None, :, :]
        dx = _ii(i[0]) - _jb(j[0])
        dy = _ii(i[1]) - _jb(j[1])
        dz = _ii(i[2]) - _jb(j[2])
        r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        w = kn.w_cubic(r, h)
        cw = kn.grad_w_cubic_coef(r, h)
        mj = _jb(j[3])
        volj = mj / cfg.rho0
        cj = volj * cw
        lap = kn.w_visc_laplacian(r, h) / cfg.rho0
        tx = lap * (_jb(j[4]) - _ii(i[4]))
        ty = lap * (_jb(j[5]) - _ii(i[5]))
        tz = lap * (_jb(j[6]) - _ii(i[6]))
        return jnp.stack([
            jnp.sum(mj * w, 1),
            jnp.sum(cj * dx, 1), jnp.sum(cj * dy, 1), jnp.sum(cj * dz, 1),
            jnp.sum(volj * w, 1),
            jnp.sum(mj * tx, 1), jnp.sum(mj * ty, 1), jnp.sum(mj * tz, 1),
        ])

    def sa_terms(i, j):
        _ii = lambda v: v[:, None, :]
        _jb = lambda v: v[None, :, :]
        dx = _ii(i[0]) - _jb(j[0])
        dy = _ii(i[1]) - _jb(j[1])
        dz = _ii(i[2]) - _jb(j[2])
        r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        cw = kn.grad_w_cubic_coef(r, h)
        s = (_ii(i[4]) + _jb(j[4])) * cw * _jb(j[3])
        return jnp.stack([jnp.sum(s * dx, 1), jnp.sum(s * dy, 1),
                          jnp.sum(s * dz, 1)])

    return {"density": density_terms, "sa": sa_terms, "dcv": dcv_terms}


BODIES = _proto_bodies(JCFG)


def _scene(name):
    """-> (pos, vel, K) as float32 numpy, from a seed."""
    k = 8
    if name == "block":
        # spaced 0.025 against 0.0404-wide cells: at most 2 per axis
        rng = np.random.default_rng(5)
        pos = J.block_positions((0.30, 0.02, 0.30), (6, 6, 6), 0.025)
        pos = pos + rng.uniform(-0.003, 0.003, pos.shape)
    else:
        # a splash: a loose spray over ~10^3 cells plus tight clumps of five
        rng = np.random.default_rng(17)
        spray = rng.uniform(0.15, 0.55, (300, 3))
        centres = rng.uniform(0.2, 0.5, (6, 3))
        clumps = (centres[:, None, :]
                  + rng.uniform(-0.012, 0.012, (6, 5, 3))).reshape(-1, 3)
        pos = np.concatenate([spray, clumps])
    vel = rng.normal(0.0, 0.5, pos.shape)
    return pos.astype(np.float32), vel.astype(np.float32), k


@pytest.fixture(scope="module", params=["block", "splash"])
def scene(request):
    pos, vel, k = _scene(request.param)
    dims_j = jdn.dims_for(JCFG, k)
    pj, vj = jnp.asarray(pos), jnp.asarray(vel)
    idx = jdn.build_dense_index(pj, JCFG, dims_j)
    assert int(idx.overflow) == 0
    flj = jdn.fill_dense(
        idx, [pj[:, 0], pj[:, 1], pj[:, 2],
              jnp.full((pos.shape[0],), JCFG.m0, jnp.float32),
              vj[:, 0], vj[:, 1], vj[:, 2]],
        [J_POS_PAD] * 3 + [0.0] * 4, dims_j)
    fl, dims = fp.build_grid(torch.as_tensor(pos), torch.as_tensor(vel),
                             TCFG, k)
    assert (dims.k, dims.g, dims.flat_p) == (k, 19683, 757)
    np.testing.assert_array_equal(fl.numpy(), np.asarray(flj))
    occupancy = (fl[0] < POS_PAD / 2).sum(0)
    assert int(occupancy.max()) > 1                # multi-occupancy cells
    port = fp.run(fl, dims, TCFG)
    return {"name": request.param, "flj": flj, "dims_j": dims_j, "fl": fl,
            "dims": dims, "port": port}


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("body", list(N_OUT))
def test_port_matches_prototype_kernel(scene, body, tile):
    rows = tpp.PASSES[tpp.FLAT_BODIES[body]].fi
    want = torch.as_tensor(np.array(PROTO.flat_pallas_pass(
        BODIES[body], scene["flj"][:rows], scene["dims_j"], N_OUT[body],
        tile=tile, interpret=True)))
    got = scene["port"][body]
    assert got.shape == want.shape == (N_OUT[body], scene["dims"].k, 19683)
    # the prototype's own output meets the port's output contract too
    fp.check_output(body, want, scene["fl"], scene["dims"])
    row_errors(f"{scene['name']} {body} tile {tile}", got, want)


@pytest.mark.parametrize("body", list(N_OUT))
def test_port_output_contract(scene, body):
    """Finite; exactly zero on the first and last flat_p cells, on the
    other ghost cells and on every empty slot; non-zero somewhere."""
    out, fl, dims = scene["port"][body], scene["fl"], scene["dims"]
    fp.check_output(body, out, fl, dims)
    g = out.reshape(out.shape[0], dims.k, dims.gx, dims.gy, dims.gz)
    for axis in (2, 3, 4):
        assert not bool(g.narrow(axis, 0, 1).any())
        assert not bool(g.narrow(axis, g.shape[axis] - 1, 1).any())
    assert bool(out.any())


def test_fluid_only_plain_drops_the_boundary_term():
    """fluid_only sums the fluid term of a pass with a boundary term: equal
    to the full pass over an empty boundary grid."""
    pos, vel, k = _scene("block")
    fl, dims = fp.build_grid(torch.as_tensor(pos), torch.as_tensor(vel),
                             TCFG, k)
    x = fp.operand("density", fl)
    bd = torch.zeros((tpp.BOUNDARY_ROWS, 1, dims.g))
    bd[:3] = POS_PAD
    full = tpp.column_pass_plain("density", x, bd, dims, dims._replace(k=1),
                                 TCFG)
    alone = tpp.column_pass_plain("density", x, None, dims, None, TCFG,
                                  fluid_only=True)
    assert torch.equal(alone, full)
    with pytest.raises(ValueError, match="no boundary operand"):
        tpp.column_pass_plain("density", x, bd, dims, dims._replace(k=1),
                              TCFG, fluid_only=True)


def test_flat_pallas_pass_checks_its_operands():
    pos, vel, k = _scene("block")
    fl, dims = fp.build_grid(torch.as_tensor(pos), torch.as_tensor(vel),
                             TCFG, k)
    with pytest.raises(ValueError, match="unknown flat body"):
        flat_pallas_pass("pressure", fl[:4], dims, TCFG)
    with pytest.raises(ValueError, match="shape"):
        flat_pallas_pass("density", fl, dims, TCFG)   # 7 rows, not 4
    with pytest.raises(ValueError, match="no flat-pass executor"):
        flat_pallas_pass("density", fl[:4].to("meta"), dims, TCFG)


def test_flat_pass_cuda_rejects_a_cpu_tensor():
    pos, vel, k = _scene("block")
    fl, dims = fp.build_grid(torch.as_tensor(pos), torch.as_tensor(vel),
                             TCFG, k)
    for tiled in (True, False):
        with pytest.raises(ValueError, match="not a CUDA device"):
            cc.flat_pass_cuda("density", fl[:4], dims, TCFG, tiled=tiled)


def test_flat_brick_shrinks_then_raises():
    """rows x K slots x halo'd cells + one count per halo cell, 4 B each,
    within 232,448 B: the 2x4x4 brick at the dam's K 24 for all three
    bodies, smaller ones at larger K, and a ValueError past the smallest."""
    assert cc.flat_brick(4, 24) == ((2, 4, 4), (4 * 24 + 1) * 144 * 4)
    assert cc.flat_brick(5, 24) == ((2, 4, 4), (5 * 24 + 1) * 144 * 4)
    assert cc.flat_brick(7, 24) == ((2, 4, 4), (7 * 24 + 1) * 144 * 4)
    assert cc.flat_brick(7, 40)[0] == (2, 4, 4)
    assert cc.flat_brick(4, 101)[0] == (2, 2, 4)
    assert cc.flat_brick(7, 60)[0] == (2, 2, 4)
    assert cc.flat_brick(7, 100)[0] == (2, 2, 2)
    for rows, k in ((7, 130), (4, 227)):
        with pytest.raises(ValueError, match="do not fit"):
            cc.flat_brick(rows, k)


def test_flat_brick_bytes_per_brick():
    """Every brick of the ladder at the dam's K 24: the halo'd cells
    (bx+2)(by+2)(bz+2) x (rows x K + 1) x 4 B, all within the limit."""
    halo = {(2, 4, 4): 144, (2, 2, 4): 96, (2, 2, 2): 64}
    assert set(halo) == set(cc.BRICKS)
    for brick, cells in halo.items():
        for rows in (4, 5, 7):
            nbytes = cc.brick_bytes(rows, 24, brick)
            assert nbytes == (rows * 24 + 1) * cells * 4
            assert nbytes <= cc.SHARED_LIMIT


def test_row_errors_holds_each_row_to_its_own_max():
    """PASS_BAR per row: an error of 1.5 x PASS_BAR x the row's max fails
    in a small row even where a larger row would pass it."""
    want = torch.tensor([[1.0, -2.0, 0.0], [100.0, 50.0, 0.0]])
    got = want.clone()
    got[0, 2] += 1.5 * PASS_BAR * 2.0
    with pytest.raises(AssertionError, match="row 0"):
        row_errors("small row", got, want)
    got = want.clone()
    got[1, 2] += 0.5 * PASS_BAR * 100.0
    err, rel = row_errors("large row", got, want)
    assert err == pytest.approx(0.5 * PASS_BAR * 100.0)
    assert rel == pytest.approx(0.5 * PASS_BAR, rel=1e-5)


def test_loading_the_prototype_leaves_sys_path_as_it_was():
    before = list(sys.path)
    assert _load_prototype().flat_pallas_pass is not None
    assert sys.path == before


def _save_state(path, pos):
    np.savez(path, pos=pos.astype(np.float32),
             vel=np.zeros_like(pos, dtype=np.float32))
    return str(path)


def test_main_rejects_an_overflowing_k(tmp_path):
    """30 particles in one cell (cell 7 spans [0.283, 0.323) on each
    axis) do not fit K = 24: main raises rather than drop any."""
    rng = np.random.default_rng(2)
    pos = 0.29 + rng.uniform(0.0, 0.025, (30, 3))
    path = _save_state(tmp_path / "crowded.npz", pos)
    with pytest.raises(ValueError, match="do not fit K=24"):
        fp.main(["--state", path, "--device", "cpu"])


def test_main_runs_on_the_cpu_when_asked(tmp_path, monkeypatch, capsys):
    # K 4 keeps the plain executor's (K, K, W) pair blocks small here
    monkeypatch.setattr(fp, "K", 4)
    rng = np.random.default_rng(9)
    pos = rng.uniform(0.2, 0.6, (64, 3))
    path = _save_state(tmp_path / "sparse.npz", pos)
    assert fp.main(["--state", path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "n=64 K=4 overflow=0 G=19683 P=757 device=cpu"
    assert [ln.split(":")[0] for ln in out[1:]] == ["density", "sa", "dcv"]


def test_main_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    path = _save_state(tmp_path / "one.npz", np.full((1, 3), 0.3))
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        fp.main(["--state", path])
