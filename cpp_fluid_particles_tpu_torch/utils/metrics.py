"""Observability: per-step metrics, timing, NaN guard.

Port of ``cpp_fluid_particles_tpu/utils/metrics.py``. The reference's only
observability is a per-frame printf of ms/FPS (src/main.cpp:300-306) and
CUDA error macros (src/global.h:23-25). Here: physical diagnostics as
tensors on the state's device, a NaN guard that costs one host read, the
reference's stats line, and a ``torch.profiler`` trace around a region.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch


def physical_diagnostics(state, cfg) -> Dict[str, torch.Tensor]:
    """Summary of the fluid state as 0-d tensors on its device."""
    speed2 = torch.sum(state.vel * state.vel, dim=-1)
    return {
        "kinetic_energy": 0.5 * torch.sum(state.mass * speed2),
        "max_speed": torch.sqrt(torch.max(speed2)),
        "max_density": torch.max(state.density),
        "mean_density": torch.mean(state.density),
        "min_pos": torch.min(state.pos),
        "max_pos": torch.max(state.pos),
    }


def nan_guard(state) -> torch.Tensor:
    """A bool tensor on the state's device: True when every field is
    finite. Reading it is the one host sync."""
    ok = torch.ones((), dtype=torch.bool, device=state.pos.device)
    for leaf in state:
        ok = ok & torch.isfinite(leaf).all()
    return ok


class StepTimer:
    """Running average + FPS, mirroring the reference's printed line
    'Frame %d - %.2f ms, avg ... (FPS)' (src/main.cpp:304-305)."""

    def __init__(self):
        self.frames = 0
        self.total_ms = 0.0
        self.last_ms = 0.0

    def record(self, ms: float) -> str:
        self.frames += 1
        self.total_ms += ms
        self.last_ms = ms
        avg = self.total_ms / self.frames
        fps = 1000.0 * self.frames / max(self.total_ms, 1e-9)
        return (f"Frame {self.frames % 10000} - {ms:5.2f} ms, "
                f"avg time - {avg:5.2f} ms/frame ({fps:6.2f} FPS)")


@contextlib.contextmanager
def profiler_trace(logdir: str | None):
    """Optional ``torch.profiler`` trace around a region, the CUDA
    activity included where a card is present, exported as a Chrome trace
    to ``logdir/trace.json`` (open in chrome://tracing or Perfetto). No-op
    when logdir is None."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
