"""Carry state over from the JAX package, in plain numpy and JSON.

Nothing here imports ``zkir_tpu``: callers hand over numpy arrays, program
bytes and proof JSON, so the port can take the reference interpreter's
traces, prove and verify what the reference's CLI wrote, and check its
Poseidon2 constants without JAX on the machine.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
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


def proof_from_json(text: str) -> Dict[str, Any]:
    """A proof as ``python -m zkir_tpu prove [--bind]`` wrote it (with or
    without ``sums_root``, ``io``, ``crypto`` and ``program``) as the dict
    the port's ``verify_trace`` takes: the FRI config becomes the port's
    ``FriConfig``.  ``proof_to_json`` is the way back."""
    from .prover.fri import FriConfig

    proof = json.loads(text)
    proof["fri"]["config"] = FriConfig(**proof["fri"]["config"])
    return proof


def fixture_from_reference(directory, name: str) -> Dict[str, Any]:
    """A prove fixture made with the JAX package, as ``<name>.matrix.npz``
    (the trace matrix), ``<name>.proof.json`` (the reference's proof, CLI
    layout) and, for a program-bound one, ``<name>.program.zkir``
    (``Program.to_bytes()``) in ``directory``.

    Returns ``{"matrix", "program", "inputs", "want", "config"}``:
    ``program`` is the port's ``spec.Program`` or ``None``, ``inputs`` the
    input tape the proof claims (empty without ``range_lookup``), ``want``
    the reference proof as parsed JSON, ``config`` its ``FriConfig``."""
    from .prover.fri import FriConfig
    from .spec import Program

    directory = pathlib.Path(directory)
    with np.load(directory / f"{name}.matrix.npz") as z:
        matrix = z["matrix"]
    want = json.loads((directory / f"{name}.proof.json").read_text())
    binary = directory / f"{name}.program.zkir"
    program = (Program.from_bytes(binary.read_bytes())
               if binary.exists() else None)
    return {"matrix": matrix, "program": program,
            "inputs": list(want.get("io", {}).get("inputs", [])),
            "want": want, "config": FriConfig(**want["fri"]["config"])}
