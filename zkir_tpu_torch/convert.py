"""Carry state over from the JAX package, in plain numpy and JSON.

Nothing here imports ``zkir_tpu``: callers hand over numpy arrays, so the
port can take the reference interpreter's traces and check its Poseidon2
constants without JAX on the machine.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np


def trace_from_reference(path) -> Dict[str, np.ndarray]:
    """A reference interpreter trace dict (``TpuInterpreter.run(...)
    ["trace"]``) saved as ``.npz``, as the dict of numpy arrays that the
    port's ``trace_to_matrix`` takes."""
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def poseidon2_params_from_reference(external, internal, dm1,
                                    device="cpu") -> tuple:
    """The port's Poseidon2 device constants (external [8, 16], internal
    [14], diag - 1 [16], as int64 tensors on ``device``), after checking
    the arrays of ``zkir_tpu.ops.poseidon2._params_np()`` against the
    port's own Grain-LFSR derivation word for word."""
    from .ops.poseidon2 import _params_np, params

    for name, theirs, ours in zip(("external", "internal", "dm1"),
                                  (external, internal, dm1), _params_np()):
        if not np.array_equal(np.asarray(theirs, dtype=np.uint64),
                              ours.astype(np.uint64)):
            raise ValueError(f"Poseidon2 {name} constants differ from the "
                             "port's derivation")
    return params(device)


def proof_to_json(proof: Dict[str, Any]) -> str:
    """Serialise a proof the way ``python -m zkir_tpu prove`` does: the
    FRI config dataclass becomes a dict.  Tuples (FRI ``lo``/``hi``,
    ``shift``) become lists, so compare proofs after a JSON round trip."""
    fri = dict(proof["fri"])
    if dataclasses.is_dataclass(fri["config"]):
        fri["config"] = dataclasses.asdict(fri["config"])
    return json.dumps(dict(proof, fri=fri))
