"""The port runs where JAX is absent: in a fresh interpreter that cannot
import ``jax`` or ``zkir_tpu``, import the port, prove golden B and verify
the stored program-bound golden E (spec, convert, the preprocessed tables
and the public demands)."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import json, pathlib, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["zkir_tpu"] = None
import numpy as np
import zkir_tpu_torch.convert, zkir_tpu_torch.prover, zkir_tpu_torch.spec
import zkir_tpu_torch.spec.config, zkir_tpu_torch.spec.program
from zkir_tpu_torch.convert import (fixture_from_reference, proof_from_json,
                                    proof_to_json)
from zkir_tpu_torch.prover import FriConfig, prove_trace, verify_trace
fix = pathlib.Path("tests/fixtures/torch_port")
want = json.loads((fix / "golden_b.proof.json").read_text())
matrix = np.load(fix / "golden_b.matrix.npz")["matrix"]
proof = prove_trace(matrix, FriConfig(**want["fri"]["config"]), device="cpu")
assert json.loads(proof_to_json(proof)) == want
fx = fixture_from_reference(fix, "golden_e")
assert verify_trace(proof_from_json(json.dumps(fx["want"])), fx["program"],
                    device="cpu")
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m.startswith("zkir_tpu.") or m == "zkir_tpu"]
assert all(sys.modules[m] is None for m in bad), bad
print("NO_JAX_OK")
"""


def test_port_needs_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         # two torch threads: other pytest workers share
                         # the machine
                         env=dict(os.environ, PYTHONPATH=str(ROOT),
                                  OMP_NUM_THREADS="2"))
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout
