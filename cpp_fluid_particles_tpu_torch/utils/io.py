"""Checkpoint / resume, and the numpy carry-over of state.

Port of ``cpp_fluid_particles_tpu/utils/io.py`` in the same npz format: a
``__meta__`` JSON blob (solver, frame, config) plus ``state_<field>`` and
``carry_<i>`` arrays. A checkpoint written by either package loads into
the other. The scene is rebuilt from the config on load: it is a pure
function of the config and the boundary layout.

``state_to_numpy`` / ``state_from_numpy`` are the carry-over path: the
JAX package's state, as numpy arrays, becomes the port's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import numpy as np
import torch

from ..config import SimConfig
from ..state import FluidState


def state_to_numpy(state: FluidState) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def state_from_numpy(arrays: Dict[str, np.ndarray], device) -> FluidState:
    return FluidState(**{k: torch.as_tensor(np.asarray(arrays[k]),
                                            device=device)
                         for k in FluidState._fields})


def save_checkpoint(path: str, sim) -> None:
    """Persist a Simulation's full dynamic state."""
    flat_state = {f"state_{k}": v
                  for k, v in state_to_numpy(sim.state).items()}
    flat_carry = {f"carry_{i}": v.detach().cpu().numpy()
                  for i, v in enumerate(sim.carry)}
    meta = json.dumps({
        "solver": sim.solver_name,
        "frame": sim.frame,
        "cfg": dataclasses.asdict(sim.cfg),
        "version": 1,
    })
    np.savez_compressed(path, __meta__=np.frombuffer(meta.encode(), np.uint8),
                        **flat_state, **flat_carry)


def load_checkpoint(path: str, device="cuda"):
    """Returns a fully reconstructed Simulation on ``device``. The carry is
    rebuilt from the ``carry_<i>`` arrays in the solver's carry order; a
    checkpoint that holds fewer arrays than the carry has leaves resumes
    with the missing leaves at zero, their init value (as the JAX package
    does)."""
    from ..simulation import Simulation

    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        state_np = {k[len("state_"):]: z[k] for k in z.files
                    if k.startswith("state_")}
        carry_np = [z[f"carry_{i}"] for i in range(
            sum(k.startswith("carry_") for k in z.files))]

    cfg_d = meta["cfg"]
    for key in ("space_size", "gravity"):
        cfg_d[key] = tuple(cfg_d[key])
    cfg = SimConfig(**cfg_d)
    sim = Simulation(solver=meta["solver"], cfg=cfg,
                     fluid_pos=state_np["pos"], warmup=False, device=device)
    fresh = list(sim.carry)
    if len(carry_np) > len(fresh):
        raise ValueError(f"checkpoint carries {len(carry_np)} arrays; solver "
                         f"{sim.solver_name!r} carries {len(fresh)}")
    leaves = [torch.as_tensor(v, device=sim.device) for v in carry_np]
    leaves += [torch.zeros_like(v) for v in fresh[len(leaves):]]
    sim.carry = type(sim.carry)(*leaves)
    sim.state = state_from_numpy(state_np, sim.device)
    sim.frame = meta["frame"]
    return sim
