"""The yardsticks that hold a kernel against its plain version on the card
and the renderer against another render: the per-row tolerance, the
render bar and the CUDA-event timers.

``PASS_BAR`` is the JAX package's Pallas bar
(tests/test_pallas_engine.py:125-126): per output row, rtol 2e-5 plus atol
2e-5 x the row's max. ``chip_smoke.py`` holds every neighbor-pass instance
to it, and the flat-grid prototype's entry point
(``exp/flat_pallas_proto.py``) its three bodies.
"""

from __future__ import annotations

import torch

PASS_BAR = 2e-5          # pass outputs: rtol, and atol x the row's max


def row_errors(tag: str, got: torch.Tensor, want: torch.Tensor):
    """-> (max abs error, worst max error / row max); raises if a row is
    over rtol PASS_BAR + atol PASS_BAR x the row's max."""
    diff = (got - want).abs()
    worst = 0.0
    for r in range(want.shape[0]):
        scale = float(want[r].abs().max()) + 1e-12
        bound = PASS_BAR * want[r].abs() + PASS_BAR * scale
        if not bool((diff[r] <= bound).all()):
            raise AssertionError(f"{tag} row {r}: max err "
                                 f"{float(diff[r].max())} over the bar (row "
                                 f"max {scale})")
        worst = max(worst, float(diff[r].max()) / scale)
    return float(diff.max()), worst


def time_ms(fn, reps: int, warm: int = 2) -> float:
    """ms per call of fn, from CUDA events around reps calls."""
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


def time_graph_ms(fn, reps: int) -> float:
    """ms per call of fn from CUDA events around one replay of a CUDA graph
    that captured reps calls: their device time back to back, without the
    host's enqueueing between them, which time_ms includes when a call's
    device work is shorter than its host work. fn runs once first, outside
    the graph. The kernels' launch counts (``column_pass_cuda.LAUNCHES``)
    are left as they were: a wrapper counts a launch when the graph
    captures it, and the graph's replays launch again uncounted, so neither
    count would be the launches that ran."""
    from ..ops.column_pass_cuda import LAUNCHES
    saved = dict(LAUNCHES)
    try:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
    finally:
        LAUNCHES.update(saved)
    return t0.elapsed_time(t1) / reps


# render: a pixel is an outlier when its largest channel error is over
# RENDER_OUTLIER; at most RENDER_OUTLIER_SHARE of the pixels may be, and
# every other pixel must agree within RENDER_ATOL (sub-pixel rounding moves
# whole sprite-edge pixels; equal-depth ties may resolve either way)
RENDER_ATOL = 1e-5
RENDER_OUTLIER = 1e-3
RENDER_OUTLIER_SHARE = 0.005


def render_errors(tag: str, got, want):
    """Two (H, W, 3) images -> (outlier share, max error of the other
    pixels); raises if over the render bar."""
    err = (torch.as_tensor(got, dtype=torch.float32).cpu()
           - torch.as_tensor(want, dtype=torch.float32).cpu()).abs()
    err = err.amax(-1)
    outlier = err > RENDER_OUTLIER
    share = float(outlier.float().mean())
    rest = float(err[~outlier].max()) if bool((~outlier).any()) else 0.0
    if share > RENDER_OUTLIER_SHARE or rest > RENDER_ATOL:
        raise AssertionError(f"{tag}: {share:.4%} of pixels over "
                             f"{RENDER_OUTLIER} (bar {RENDER_OUTLIER_SHARE:.1%}"
                             f"), the others within {rest:.3e} (bar "
                             f"{RENDER_ATOL})")
    return share, rest
