"""Simulation configuration — a verbatim copy of
``cpp_fluid_particles_tpu/config.py``.

It is copied, not imported: importing ``cpp_fluid_particles_tpu.config`` runs
that package's ``__init__``, which imports jax. Every field and default must
stay equal to the JAX package's (tests/test_torch_state_config.py), so a
checkpoint's config round-trips between the two packages. Fields that steer
machinery the port does not have yet (``box_fill``, ``occupancy_split``,
``skip_empty_boundary``, ``halo_comm``, ...) are kept for that reason; their
comments below describe the JAX package.

(reference: src/main.cpp:54-67 file-scope consts, src/DFSPHSolver.h:27-30 and
src/PBDSolver.h:27-30 ctor defaults, src/global.h:20-26 macros).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

PI = math.pi


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """All physics + capacity constants for one simulation.

    Defaults reproduce the reference dam-break scene exactly
    (src/main.cpp:54-67).
    """

    # --- domain & discretisation (src/main.cpp:54-58,67) ---
    space_size: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    spacing: float = 0.02                  # sphSpacing
    radius: float = 0.04                   # sphSmoothingRadius = 2*spacing
    cell_length: float = 0.0404            # sphCellLength = 1.01*radius
    dt: float = 0.002

    # --- fluid constants (src/main.cpp:59-66) ---
    rho0: float = 1.0
    rho_boundary: float = 1.4              # 1.4 * rho0
    m0: float = 76.596750762082e-6
    stiff: float = 10.0
    gravity: Tuple[float, float, float] = (0.0, -9.8, 0.0)
    visc: float = 5e-4
    surface_tension: float = 1e-4
    air_pressure: float = 1e-4

    # --- numerical guards (src/global.h:21-26) ---
    epsilon: float = 1e-6
    max_accel: float = 1000.0              # MAX_A acceleration clamp

    # --- DFSPH solver (src/DFSPHSolver.h:27-30) ---
    dfsph_density_threshold: float = 1e-3
    dfsph_divergence_threshold: float = 1e-3
    dfsph_max_iter: int = 20
    # Warm-start scale for the DIVERGENCE solve (this framework's
    # extension; the reference warm-starts only the density solve,
    # src/DFSPHSolver.cu:160-210). 0 = off (reference behavior). The
    # solve converges to the same threshold either way; a warm start
    # just reaches it in fewer Jacobi iterations (measured on the dam
    # break: 20 (maxed out) -> ~13 post-impact, DFSPH frame time -22%;
    # scale 1.0 converges, 0.5 does not help). See PARITY.md.
    dfsph_warm_divergence: float = 1.0
    # Over-relaxation factor applied to every Jacobi stiffness update in
    # both DFSPH solves (1.0 = the reference's plain Jacobi iteration;
    # the converged fixed point is unchanged either way). EXPERIMENTAL —
    # measured on the dam break, omega=1.3 does cut divergence iterations
    # from ~13 to ~3 but overshoots during impact: velocities spike, cell
    # occupancy jumps 12 -> 25, and frame times get WORSE through capacity
    # escalation. Keep at 1.0 for violent scenes.
    dfsph_sor: float = 1.0

    # --- PBD solver (src/PBDSolver.h:27-30) ---
    pbd_max_iter: int = 20
    pbd_xsph_c: float = 0.05
    pbd_relaxation: float = 0.75
    # Optional convergence-based early exit for the projection loop (this
    # framework's extension; the reference always runs the fixed 20
    # iterations). 0 = off (reference behavior, plus the always-on EXACT
    # early exit when every lambda is zero). A value like 0.01 stops
    # iterating once max(rho)/rho0 - 1 < tol — the standard
    # SPlisHSPlasH-style criterion; measured on the dam break it cuts
    # post-impact iterations substantially at ~1% residual compression.
    pbd_density_tolerance: float = 0.0
    # Chebyshev semi-iterative acceleration of the Jacobi-style solver
    # loops ([2015][TOG][Wang] "A Chebyshev Semi-Iterative Approach for
    # Accelerating Projective and Position-Based Dynamics"; this
    # framework's extension — no reference equivalent, 0 = off =
    # reference behavior). rho estimates the spectral radius of the
    # underlying iteration (Wang: 0.9-0.99 works across scenes); the
    # recurrence w1=1, w2=2/(2-rho^2), w(k+1)=4/(4-rho^2 wk)
    # extrapolates x(k+1) = w (x~(k+1) - x(k-1)) + x(k-1).
    # Extrapolation only engages at iteration `chebyshev_start` (early
    # iterates are far from the asymptotic regime; extrapolating them
    # destabilizes violent scenes — Wang's "delayed start"), and is
    # suppressed on any iteration whose plain update is an exact no-op
    # so the all-lambda-zero early exit stays exact.
    pbd_chebyshev_rho: float = 0.0
    dfsph_chebyshev_rho: float = 0.0
    chebyshev_start: int = 4
    # Restrict DFSPH Chebyshev extrapolation to the DENSITY solve (the
    # divergence solve runs plain warm-started Jacobi). The round-4
    # validation showed dfsph_chebyshev_rho=0.9 applied to BOTH solves
    # diverges trajectory-wise on the dam (PARITY.md #11); the round-5
    # sweep (exp/dfsph_sweep.py) explores gentler rho and density-only
    # application through the same full-dam envelopes.
    dfsph_cheb_density_only: bool = False
    # Warm-start predictor for the PBD projection (this framework's
    # extension, DFSPH-warm-start-inspired — src/DFSPHSolver.cu:160-210
    # carries the stiffness sum across frames the same way): before
    # iterating, shift positions by `scale x` the PREVIOUS frame's total
    # projection displacement (carried per particle; zero traversals of
    # extra cost). The projection converges to the same constraint
    # manifold from a closer start. Only meaningful with the
    # tolerance-based exit (pbd_density_tolerance > 0) — the parity
    # contract is a fixed iteration count, where a different start
    # changes the trajectory without saving work — and rejected
    # otherwise. 0 = off (default, parity).
    pbd_warm_start: float = 0.0
    # Reproduce the reference's mid-projection re-binning semantics
    # (src/PBDSolver.cu:154-156): particle i's 27-cell stencil is
    # recomputed from its MOVING position every projection iteration
    # (and in the XSPH pass) against cell ranges frozen at step start,
    # instead of this framework's default start-of-step binning for both
    # sides (PARITY.md divergence #2 quantifies the gap). Opt-in, oracle
    # engine only: the per-particle re-binned traversal is irregular and
    # not built for speed.
    pbd_rebin_moving: bool = False

    # --- static capacity bounds (TPU fixed-shape requirements; no reference
    #     equivalent — the CUDA code walks dynamic cellStart ranges) ---
    max_active_cells: int = 8192           # max fluid-occupied cells per step
    max_per_cell: int = 16                 # max fluid particles per cell

    # Fluid masses are a uniform m0 fill in the reference
    # (src/SPHSystem.cu:73, thrust::fill over sphM0); when True the dense
    # fast path derives its grid mass row from slot occupancy (real slot
    # -> m0, empty -> 0) instead of scattering state.mass — one fewer
    # scatter row per step (the 1M-particle fill is per-element-cost
    # bound, BENCHMARKS.md). Identical results while state.mass is the
    # uniform m0 fill that make_fluid_state produces; set False when
    # carrying custom per-particle fluid masses. The oracle engines and
    # boundary masses always honor the stored arrays.
    uniform_fluid_mass: bool = True

    # Grid-fill strategy for the sliding-box engine: "scatter" writes all
    # F field rows with one scatter; "gather" scatters ONE int32
    # slot->particle-id row and fetches all F rows with a single
    # shared-index row take (bitwise-identical output — the slot map is
    # injective). TPU scatter pays per ELEMENT (~0.45 GB/s measured,
    # exp/fill_sort.py) while the row take pays per INDEX (~2.3 GB/s,
    # exp/gather_bw.py), so gather wins when the box holds few slots per
    # particle: "auto" picks by the measured-bandwidth model
    # (F*slots/2.3 + N/0.45 < F*N/0.45) — gather at the 1M scene
    # (~2.2 slots/particle), scatter on the 20k dam break (~12.6).
    box_fill: str = "auto"

    # Skip the boundary folds of every traversal while the sliding box's
    # boundary window holds no boundary particle (boundary candidates are
    # 37-39% of a with-boundary traversal, exp/boundary_share.py — all
    # exactly zero then: empty slots carry zero mass and POS_PAD
    # positions). Simulation compiles a boundary-free step program and
    # selects it per chunk from the on-device `bd_touch` detector; a
    # chunk in which the window reaches a wall mid-flight is re-run with
    # the boundary program from the pre-chunk state (the same no-drop
    # retry contract as the capacity bounds). Physics is identical up to
    # f32 summation order (the boundary folds it removes are exact
    # zeros, but XLA's reduce fusions tile differently in the two
    # programs — the same noise class as a chunking/capacity
    # reconfiguration; measured 1 ulp on velocities per step, positions
    # unchanged). Pays off in interior-fluid phases
    # (the 1M scene's entire fall window; the 20k dam touches walls from
    # frame 0 and never switches). Requires auto_capacity + the sliding
    # box engine.
    skip_empty_boundary: bool = True

    # Occupancy-class split (ops/split.py, VERDICT r4 #1): run the
    # sliding-box engine as two tiers — the box truncated to `split_k_a`
    # slot rows (complete for the ~90% of cells holding <= K_a) plus a
    # small overflow window carrying only ranks >= K_a — paying
    # K_a^2-cost traversals over the box instead of K^2 while the splash
    # escalates K. Simulation auto-selects the split program per chunk
    # (occupancy + window-volume heuristic with hysteresis, like
    # skip_empty_boundary) under the same no-drop retry contract: the
    # window size is a third adaptive capacity axis next to K and the
    # box. Results are float-close to the single-tier engine (pair sums
    # regrouped), not bitwise — so the flag is opt-in and the parity /
    # golden contracts keep it off. WCSPH/PBD only (the traversal-bound
    # solvers); single-chip only.
    occupancy_split: bool = False
    # Class-A slot rows when occupancy_split is on (exp/occupancy_split.py
    # measured +12-40% per-pass at K_a=8-12 against splash K=18-22).
    split_k_a: int = 10

    # Multi-chip communication strategy (only meaningful under a mesh):
    # "auto" uses the shard_map halo engine — ONE fused flat_p-wide edge
    # exchange per traversal (2 ppermutes) and N-sized collectives at the
    # particle<->grid boundary (parallel/halo.py) — whenever the static
    # shapes divide the mesh, falling back to GSPMD inference otherwise;
    # "gspmd" always uses GSPMD inference (per-offset permutes and
    # grid-sized all-gathers — the round-3 path, kept as the differential
    # oracle); "shard_map" asserts the halo engine is used.
    halo_comm: str = "auto"

    # --- execution engine ---
    # "dense"     : resolves to "xlab"
    # "xlab"      : sliding-box lane-major grid (ops/box.py) — the flat
    #               symmetric half-stencil passes run over the fluid's
    #               cell-space bounding box (static size auto-fitted,
    #               dynamic position); zero gathers; fastest measured
    # "xla"       : full-domain lane-major flat grid, symmetric
    #               half-stencil XLA passes (each fluid pair block
    #               evaluated once, reduced along both axes)
    # "xla27"     : full-domain grid, plain 27-offset XLA loop
    #               (differential oracle for the symmetric executor)
    # "pallas"    : dense grid + Pallas column kernels (candidates resident
    #               in VMEM — the design for direct TPU runtimes)
    # "interpret" : pallas in interpreter mode (CPU correctness testing)
    # "reference" : compacted-cell gather engine (first implementation,
    #               kept as a differential-testing oracle)
    # "auto"      : dense
    engine: str = "auto"

    # ------------------------------------------------------------------
    @property
    def cell_size(self) -> Tuple[int, int, int]:
        """Grid resolution per axis (src/main.cpp:67)."""
        return tuple(
            int(math.ceil(s / self.cell_length)) for s in self.space_size
        )

    @property
    def num_cells(self) -> int:
        """Number of real cells; cell id ``num_cells`` is the out-of-grid
        sentinel (src/CUDAFunctions.cuh:64-70)."""
        cx, cy, cz = self.cell_size
        return cx * cy * cz

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


# The validated beyond-parity solver modes (BENCHMARKS.md "Beyond
# parity"; physics validation exp/pbd_mode_validation.py + PARITY.md
# #11-12): same convergence criteria, fewer projection iterations.
# Parity mode (all zeros) remains the differential-test contract and is
# one mode="parity" away. Deliberately NOT here, measured on the full
# 300-frame dam (exp/pbd_mode_validation.py / exp/dfsph_sweep*.py):
#   * dfsph_chebyshev_rho fails the validation envelopes at every
#     setting that engages (round-5 sweep: rho 0.6-0.9 x start 4-10 all
#     diverge or are no-ops) — stays opt-in;
#   * pbd_warm_start: 1.0 DESTABILIZES the dam impact (compounding
#     re-application until capacity exhausts at K=128); 0.5 diverges
#     statistically (dKE 10.9%, height-p95 off 3.2 sp); 0.25 passes the
#     gate at the code-default dt 0.002 (dCOM 0.36 sp, dKE 3.0%) and is
#     a measured -11% (90 vs 101 ms/frame) — but DIVERGES at the
#     reference's benchmark dt 0.004 (dKE 7.8%, dCOM 0.79 sp, round-5
#     dual-dt gate), where tol+cheb both still validate. A default must
#     pass at every dt the headline is quoted at, so 0.25 stays opt-in
#     for dt <= 0.002 regimes.
FAST_MODE_FLAGS = dict(
    pbd_density_tolerance=0.01,   # SPlisHSPlasH-style residual exit
    pbd_chebyshev_rho=0.9,        # Chebyshev-accelerated projection
)


def dam_break_config(mode: str = "fast", **overrides) -> SimConfig:
    """The reference's only scene configuration (src/main.cpp:54-67).

    ``mode="fast"`` (default) enables the physics-validated
    beyond-parity solver modes (``FAST_MODE_FLAGS``: PBD tolerance exit
    + Chebyshev acceleration — each validated against parity over the
    full 300-frame dam at both dt 0.002 and 0.004,
    exp/pbd_mode_validation.py; the PBD warm-start predictor and DFSPH
    Chebyshev failed that validation and stay opt-in, see the comment
    above FAST_MODE_FLAGS).
    ``mode="parity"`` is the bit-for-bit reference solver contract
    (fixed-20 PBD projection, plain Jacobi DFSPH) used by the golden and
    differential tests. Explicit ``**overrides`` win over either mode.
    """
    if mode not in ("fast", "parity"):
        raise ValueError(f"unknown config mode {mode!r}")
    flags = dict(FAST_MODE_FLAGS) if mode == "fast" else {}
    flags.update(overrides)
    return SimConfig(**flags)


# Benchmark dt values from the reference README (README.md:6-9); the code
# default is dt=0.002 but published timings used these.
BENCH_DT = {"wcsph": 0.001, "dfsph": 0.004, "pbd": 0.004}
