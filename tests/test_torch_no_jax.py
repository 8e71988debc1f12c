"""The port runs where JAX is absent: in a fresh interpreter that cannot
import ``jax`` or ``zkir_tpu``, import the port (prover, toolchain,
interpreter, the batched hashes and CLI), prove golden B, verify the stored program-bound
golden E (spec, convert, the preprocessed tables and the public demands),
and drive ``asm``, ``run`` (the native and the oracle engine), ``prove``
and ``verify`` of ``examples/add.zkasm`` through the CLI on the CPU; and,
in another such interpreter, import ``zkir_tpu_torch.parallel``, run a
one-rank gloo ``dist_ntt_natural`` and ``dist_merkle_root``, prove golden
B on that mesh, and run the CLI's ``warm``.  Both run in one such
interpreter, one after the other."""

import os
import pathlib
import subprocess
import sys

import pytest

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


PARALLEL_SCRIPT = r"""
import contextlib, io, json, pathlib, sys
sys.modules["jax"] = None
sys.modules["zkir_tpu"] = None
import numpy as np
import torch
import torch.distributed as dist
import zkir_tpu_torch.parallel
import zkir_tpu_torch.parallel.distributed, zkir_tpu_torch.parallel.mesh
import zkir_tpu_torch.parallel.multihost
from zkir_tpu_torch.ops import merkle, ntt
from zkir_tpu_torch.parallel import (dist_merkle_root, dist_ntt_natural,
                                     make_mesh)
import zkir_tpu_torch.cli
from zkir_tpu_torch.convert import proof_to_json
from zkir_tpu_torch.prover import FriConfig, prove_trace
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
mesh = make_mesh(device="cpu")
gen = torch.Generator().manual_seed(7)
re, im = (torch.randint(0, (1 << 31) - 1, (1 << 10,), generator=gen)
          for _ in range(2))
for got, want in zip(dist_ntt_natural(re, im, mesh, 10), ntt.ntt(re, im, 10)):
    assert torch.equal(got, want)
rows = torch.randint(0, (1 << 31) - 1, (32, 5), generator=gen)
want = merkle.root(merkle.build_tree(merkle.hash_rows(rows)))
assert dist_merkle_root(rows, mesh).tolist() == want.tolist()
fix = pathlib.Path("tests/fixtures/torch_port")
want = json.loads((fix / "golden_b.proof.json").read_text())
proof = prove_trace(np.load(fix / "golden_b.matrix.npz")["matrix"],
                    FriConfig(**want["fri"]["config"]), mesh=mesh,
                    device="cpu")
assert json.loads(proof_to_json(proof)) == want
dist.destroy_process_group()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    assert zkir_tpu_torch.cli.main(["--device", "cpu", "warm", "--log-rows",
                                    "10"]) == 0
assert out.getvalue().startswith("warmed prove kernels for 2^10 rows in ")
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m.startswith("zkir_tpu.") or m == "zkir_tpu"]
assert all(sys.modules[m] is None for m in bad), bad
print("NO_JAX_PARALLEL_OK")
"""


# Both scripts in one fresh interpreter, one after the other (each pays
# ``import torch`` once less): a script that fails prints its name and
# traceback, and the next one still runs.
RUNNER = r"""
import sys, traceback
for name, script in SCRIPTS:
    try:
        exec(compile(script, name, "exec"), {"__name__": "__main__"})
    except BaseException:
        print(f"FAILED {name}", flush=True)
        traceback.print_exc()
"""


@pytest.fixture(scope="module")
def fresh_interpreter():
    """Both scripts' run: (stdout, stderr)."""
    scripts = [("port", SCRIPT), ("parallel", PARALLEL_SCRIPT)]
    res = subprocess.run([sys.executable, "-c",
                          f"SCRIPTS = {scripts!r}\n{RUNNER}"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         # one torch thread: other pytest workers share
                         # the machine
                         env=dict(os.environ, PYTHONPATH=str(ROOT),
                                  OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout, res.stderr


def test_port_needs_no_jax(fresh_interpreter):
    out, err = fresh_interpreter
    assert "FAILED port" not in out, err[-4000:]
    assert "NO_JAX_OK" in out


def test_parallel_needs_no_jax(fresh_interpreter):
    """``zkir_tpu_torch.parallel`` (all four modules) imports neither
    ``jax`` nor ``zkir_tpu``; a one-rank gloo world runs
    ``dist_ntt_natural`` and ``dist_merkle_root`` to the single-device
    results and proves golden B on its mesh to the reference proof; and
    ``warm --log-rows 10`` runs through the CLI."""
    out, err = fresh_interpreter
    assert "FAILED parallel" not in out, err[-4000:]
    assert "NO_JAX_PARALLEL_OK" in out
