"""Checkpoint/resume for long trace generations.

Counterpart of ``zkir_tpu/interp/checkpoint.py``: the complete
``MachineState`` (plus the configuration and the program) goes into one
``.npz`` file between chunks, and comes back on any device.

Usage:
    save_state("ckpt.npz", interp, state)
    interp, state = load_state("ckpt.npz", device="cuda")
    result = interp.resume(state)
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np
import torch

from ..spec.program import Program
from .columnar import (_STATE_DTYPES, InterpConfig, MachineState,
                       TpuInterpreter)


def save_state(path: str, interp: TpuInterpreter, state: MachineState) -> None:
    arrays = {name: value.cpu().numpy()
              for name, value in zip(MachineState._fields, state)}
    meta = {
        "config": dataclasses.asdict(interp.config),
        "program": interp.program.to_bytes().hex(),
    }
    np.savez_compressed(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_state(path: str, *, device) -> Tuple[TpuInterpreter, MachineState]:
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {name: data[name] for name in MachineState._fields}
    program = Program.from_bytes(bytes.fromhex(meta["program"]))
    interp = TpuInterpreter(program, InterpConfig(**meta["config"]),
                            device=device)
    state = MachineState(**{
        name: torch.from_numpy(a).to(device=device,
                                     dtype=_STATE_DTYPES[name])
        for name, a in arrays.items()})
    return interp, state
