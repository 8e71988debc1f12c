"""The port runs where JAX is absent: in a fresh interpreter that cannot
import ``jax`` or ``zkir_tpu``, import the port (prover, toolchain,
interpreter, the batched hashes and CLI), prove golden B, verify the stored program-bound
golden E (spec, convert, the preprocessed tables and the public demands),
and drive ``asm``, ``run`` (the native and the oracle engine), ``prove``
and ``verify`` of ``examples/add.zkasm`` through the CLI on the CPU."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

SCRIPT = r"""
import contextlib, io, json, pathlib, sys, tempfile
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.modules["zkir_tpu"] = None
import numpy as np
import zkir_tpu_torch.convert, zkir_tpu_torch.prover, zkir_tpu_torch.spec
import zkir_tpu_torch.spec.config, zkir_tpu_torch.spec.program
import zkir_tpu_torch.asm, zkir_tpu_torch.cli, zkir_tpu_torch.interp
import zkir_tpu_torch.interp.checkpoint, zkir_tpu_torch.prover.benchtrace
import zkir_tpu_torch.tools.fuzz_programs, zkir_tpu_torch.tools.interp_bench
import zkir_tpu_torch.runtime.native_vm, zkir_tpu_torch.prover.streaming
import zkir_tpu_torch.tools.stream_prove, zkir_tpu_torch.runtime.vm
import zkir_tpu_torch.spec.analyzer, zkir_tpu_torch.spec.values
import zkir_tpu_torch.ops.sha256, zkir_tpu_torch.ops.keccak
import zkir_tpu_torch.ops.blake3, zkir_tpu_torch.ops.byte_rows
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
with tempfile.TemporaryDirectory() as tmp:
    tmp = pathlib.Path(tmp)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli = lambda *a: zkir_tpu_torch.cli.main(["--device", "cpu", *a])
        assert cli("asm", "examples/add.zkasm", "-o", str(tmp / "a.zkir")) == 0
        assert cli("run", str(tmp / "a.zkir"), "--input", "2", "--input",
                   "3") == 0
        assert cli("run", str(tmp / "a.zkir"), "--input", "2", "--input",
                   "3", "--engine", "oracle") == 0
        assert cli("prove", str(tmp / "a.zkir"), "--input", "2", "--input",
                   "3", "--bind", "-o", str(tmp / "p.json")) == 0
        assert cli("verify", str(tmp / "p.json"), "--binary",
                   str(tmp / "a.zkir")) == 0
    assert out.getvalue().endswith("VALID\n"), out.getvalue()
    assert "halt=2 cycles=11 exit=0 outputs=[5]\n" in out.getvalue()
    assert "halt=exit cycles=11 exit=0 outputs=[5]\n" in out.getvalue()
    assert json.loads((tmp / "p.json").read_text())["io"] == {
        "inputs": [2, 3], "outputs": [5]}
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
