"""Regenerate the reference fixtures that the PyTorch port is held against.

Every file here is made with the JAX package (``zkir_tpu``) on the CPU:

- ``trace_exact_2e16.npz``: the reference interpreter's trace dict for
  ``exact_trace_program(16)`` (65,536 rows ending in EBREAK), run with
  ``TpuInterpreter(lanes=1, chunk=1024, collect_trace=True)``.  The port
  has no interpreter yet, so this is the input of its full-size prove.
- ``golden_a.proof.json`` / ``golden_a.matrix.npz``: the exact output of
  ``python -m zkir_tpu --platform cpu prove examples/fibonacci.zkasm
  --input 10`` (production ``FriConfig()``: 32 queries, 16 grinding bits,
  blowup 4), and its trace matrix as ``cli.py`` builds it.
- ``golden_b.proof.json`` / ``golden_b.matrix.npz``: ``prove_trace`` of
  ``exact_trace_program(8)`` with ``GOLDEN_B_CONFIG`` (LDE domain 2^10,
  the NTT's four-step path), its config stored the way the CLI stores it.

Run from the repository root (takes a few minutes)::

    JAX_PLATFORMS=cpu python tests/fixtures/torch_port/make_fixtures.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[2]
sys.path.insert(0, str(ROOT))

GOLDEN_B_CONFIG = dict(log_blowup=2, log_final=3, num_queries=8,
                       grinding_bits=2, min_security=0)


def _trace_2e16() -> None:
    from zkir_tpu.interp import InterpConfig, TpuInterpreter
    from zkir_tpu.prover.benchtrace import exact_trace_program

    n = 1 << 16
    interp = TpuInterpreter(exact_trace_program(16), InterpConfig(
        lanes=1, chunk=1024, collect_trace=True))
    trace = interp.run([[]], max_cycles=2 * n)["trace"]
    np.savez_compressed(HERE / "trace_exact_2e16.npz",
                        **{k: np.asarray(v) for k, v in trace.items()})


def _golden_a() -> None:
    from zkir_tpu.cli import _load_program
    from zkir_tpu.interp import InterpConfig, TpuInterpreter
    from zkir_tpu.prover import trace_to_matrix

    src = ROOT / "examples" / "fibonacci.zkasm"
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "proof.json"
        subprocess.run(
            [sys.executable, "-m", "zkir_tpu", "--platform", "cpu", "prove",
             str(src), "--input", "10", "-o", str(out)],
            check=True, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        (HERE / "golden_a.proof.json").write_text(out.read_text())
    # The matrix exactly as cmd_prove builds it (cli.py).
    program = _load_program(str(src))
    interp = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=256, collect_trace=True))
    result = interp.run([[10]], max_cycles=100_000)
    matrix = trace_to_matrix(result["trace"], program=program)
    np.savez_compressed(HERE / "golden_a.matrix.npz", matrix=matrix)


def _golden_b() -> None:
    from zkir_tpu.prover import prove_trace
    from zkir_tpu.prover.benchtrace import exact_trace_matrix
    from zkir_tpu.prover.fri import FriConfig

    matrix = exact_trace_matrix(8)
    proof = prove_trace(matrix, FriConfig(**GOLDEN_B_CONFIG))
    proof["fri"]["config"] = dataclasses.asdict(proof["fri"]["config"])
    (HERE / "golden_b.proof.json").write_text(json.dumps(proof))
    np.savez_compressed(HERE / "golden_b.matrix.npz", matrix=matrix)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    which = sys.argv[1:] or ["trace", "a", "b"]
    for name in which:
        {"trace": _trace_2e16, "a": _golden_a, "b": _golden_b}[name]()
        print(f"made fixture {name}", flush=True)


if __name__ == "__main__":
    main()
