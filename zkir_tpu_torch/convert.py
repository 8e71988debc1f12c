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


def poseidon2_params_from_reference(external, internal, dm1, *,
                                    device) -> tuple:
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


def preprocessed_from_reference(path, table: str) -> Dict[str, Any]:
    """A preprocessed table the JAX package made (``preprocess_aux`` or
    ``preprocess_program``), stored as ``<table>_cols``, ``_rows``,
    ``_level_<k>`` and ``_root`` arrays in the ``.npz`` at ``path``:
    ``{"cols", "rows", "levels", "root"}`` as the reference returns them
    (numpy arrays, the levels a list, the root a list of ints)."""
    with np.load(path) as z:
        levels = []
        while f"{table}_level_{len(levels)}" in z.files:
            levels.append(z[f"{table}_level_{len(levels)}"])
        return {"cols": z[f"{table}_cols"], "rows": z[f"{table}_rows"],
                "levels": levels,
                "root": [int(x) for x in z[f"{table}_root"]]}


def machine_state_from_reference(arrays: Dict[str, np.ndarray], *, device):
    """The port's ``interp.MachineState`` on ``device`` from the numpy
    fields of a reference ``MachineState`` (a dict by field name, or a
    reference checkpoint ``.npz`` opened with ``np.load``): each
    ``*_lo``/``*_hi`` pair of uint32 limbs becomes one int64 bit pattern;
    ``accum`` (the deferred-carry model's accumulated registers) and the
    other columns carry over as they are."""
    import torch

    from .interp.columnar import _STATE_DTYPES, MachineState

    def word(name):
        lo = np.asarray(arrays[f"{name}_lo"], dtype=np.uint64)
        hi = np.asarray(arrays[f"{name}_hi"], dtype=np.uint64)
        return (lo | (hi << np.uint64(32))).view(np.int64)

    fields = {
        "pc": word("pc"), "regs": word("regs"), "exit": word("exit"),
        "inputs": word("inputs"), "outputs": word("outputs"),
        "cycles": np.asarray(arrays["cycles"]).astype(np.int64),
        **{k: np.asarray(arrays[k])
           for k in ("bound_bits", "accum", "halted", "mem", "n_inputs",
                     "input_pos", "out_pos")}}
    return MachineState(**{
        k: torch.from_numpy(np.array(v)).to(
            device=device, dtype=_STATE_DTYPES[k])
        for k, v in fields.items()})


def machine_state_to_reference(state) -> Dict[str, np.ndarray]:
    """The way back: the reference ``MachineState``'s fields as numpy
    arrays (uint32 limb pairs), by field name."""
    host = {k: v.cpu().numpy() for k, v in zip(state._fields, state)}
    out = {}
    for name in ("pc", "regs", "exit", "inputs", "outputs"):
        bits = host[name].view(np.uint64)
        out[f"{name}_lo"] = (bits & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out[f"{name}_hi"] = (bits >> np.uint64(32)).astype(np.uint32)
    out["cycles"] = host["cycles"].astype(np.uint32)
    for name in ("bound_bits", "accum", "halted", "mem", "n_inputs",
                 "input_pos", "out_pos"):
        out[name] = host[name]
    return out
