"""Regenerate the reference fixtures that the PyTorch port is held against.

Every file here is made with the JAX package (``zkir_tpu``) on the CPU:

- ``trace_exact_2e16.npz``: the reference interpreter's trace dict for
  ``exact_trace_program(16)`` (65,536 rows ending in EBREAK), run with
  ``TpuInterpreter(lanes=1, chunk=1024, collect_trace=True)``: the
  reference trace that the port's interpreter is held to on the GPU (valid
  rows, column by column), and the input of its ``range_lookup=False``
  full-size prove.
- ``golden_a.proof.json`` / ``golden_a.matrix.npz``: the exact output of
  ``python -m zkir_tpu --platform cpu prove examples/fibonacci.zkasm
  --input 10`` (production ``FriConfig()``: 32 queries, 16 grinding bits,
  blowup 4), and its trace matrix as ``cli.py`` builds it.
- ``golden_b.proof.json`` / ``golden_b.matrix.npz``: ``prove_trace`` of
  ``exact_trace_program(8)`` with ``GOLDEN_B_CONFIG`` (LDE domain 2^10,
  the NTT's four-step path), its config stored the way the CLI stores it.
- ``trace_exact_2e16.program.zkir``: ``exact_trace_program(16).to_bytes()``,
  so that the full-size prove can bind its program.
- ``golden_c``: ``prove_trace(exact_trace_matrix(10), SMALL_CONFIG,
  range_lookup=True)`` (the full constraint set, no program).
- ``golden_d``: the exact output of ``python -m zkir_tpu --platform cpu
  prove examples/fibonacci.zkasm --input 10 --bind`` (production
  ``FriConfig()``, I/O tape, program-bound), its matrix as ``cli.py``
  builds it, and the program's bytes (``golden_d.program.zkir``).
- ``golden_e``: a program that stores ``b"abc"``, hashes it with the
  SHA-256 syscall and loads the first digest word (memory table, crypto
  tape), proved with ``SMALL_CONFIG, range_lookup=True, program=...``.
- ``preprocessed_e.npz`` (``pre``): the preprocessed tables that golden
  E's proof and its verification use, ``preprocess_aux(10, 2)`` and
  ``preprocess_program`` of golden E's program at 2^10 rows and blowup 4:
  for ``aux`` and ``program``, the table's columns, committed rows, tree
  levels (``<table>_level_<k>``) and root.  Made from ``golden_e.program.zkir``.

Run from the repository root (takes a few minutes); name the fixtures to
make, or none for all of them::

    JAX_PLATFORMS=cpu python tests/fixtures/torch_port/make_fixtures.py [trace a b c d e pre]
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
# The reference tests' own small config for range_lookup proofs.
SMALL_CONFIG = dict(log_blowup=2, log_final=3, num_queries=4,
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
    (HERE / "trace_exact_2e16.program.zkir").write_bytes(
        exact_trace_program(16).to_bytes())


def _cli_golden(name: str, *flags: str):
    """``python -m zkir_tpu prove examples/fibonacci.zkasm --input 10`` with
    ``flags``: its proof JSON and the matrix exactly as cmd_prove builds it
    (cli.py).  Returns the program."""
    from zkir_tpu.cli import _load_program
    from zkir_tpu.interp import InterpConfig, TpuInterpreter
    from zkir_tpu.prover import trace_to_matrix

    src = ROOT / "examples" / "fibonacci.zkasm"
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "proof.json"
        subprocess.run(
            [sys.executable, "-m", "zkir_tpu", "--platform", "cpu", "prove",
             str(src), "--input", "10", *flags, "-o", str(out)],
            check=True, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT)))
        (HERE / f"golden_{name}.proof.json").write_text(out.read_text())
    program = _load_program(str(src))
    interp = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=256, collect_trace=True))
    result = interp.run([[10]], max_cycles=100_000)
    matrix = trace_to_matrix(result["trace"], program=program)
    np.savez_compressed(HERE / f"golden_{name}.matrix.npz", matrix=matrix)
    return program


def _golden_a() -> None:
    _cli_golden("a")


def _golden_b() -> None:
    from zkir_tpu.prover import prove_trace
    from zkir_tpu.prover.benchtrace import exact_trace_matrix
    from zkir_tpu.prover.fri import FriConfig

    matrix = exact_trace_matrix(8)
    _save_proof("b", prove_trace(matrix, FriConfig(**GOLDEN_B_CONFIG)),
                matrix)


def _save_proof(name: str, proof, matrix) -> None:
    proof["fri"]["config"] = dataclasses.asdict(proof["fri"]["config"])
    (HERE / f"golden_{name}.proof.json").write_text(json.dumps(proof))
    np.savez_compressed(HERE / f"golden_{name}.matrix.npz", matrix=matrix)


def _golden_c() -> None:
    from zkir_tpu.prover import prove_trace
    from zkir_tpu.prover.benchtrace import exact_trace_matrix
    from zkir_tpu.prover.fri import FriConfig

    matrix = exact_trace_matrix(10)
    proof = prove_trace(matrix, FriConfig(**SMALL_CONFIG), range_lookup=True)
    _save_proof("c", proof, matrix)


def _golden_d() -> None:
    program = _cli_golden("d", "--bind")
    (HERE / "golden_d.program.zkir").write_bytes(program.to_bytes())


def _golden_e() -> None:
    from zkir_tpu.interp import InterpConfig, TpuInterpreter
    from zkir_tpu.prover import prove_trace, trace_to_matrix
    from zkir_tpu.prover.fri import FriConfig
    from zkir_tpu.spec import Instruction, Op, Program

    # Store b"abc" at PTR byte by byte, SHA-256 it (syscall 3) into OUT,
    # load the first digest word (as tests/test_crypto_air.py builds it).
    ptr, out, data = 0x4000, 0x4100, b"abc"
    ins = [Instruction(Op.ADDI, rd=11, rs1=0, imm=ptr)]
    for i, b in enumerate(data):
        ins.append(Instruction(Op.ADDI, rd=6, rs1=0, imm=b))
        ins.append(Instruction(Op.SB, rs1=11, rs2=6, imm=i))
    ins += [Instruction(Op.ADDI, rd=10, rs1=0, imm=3),
            Instruction(Op.ADDI, rd=12, rs1=0, imm=len(data)),
            Instruction(Op.ADDI, rd=13, rs1=0, imm=out),
            Instruction(Op.ECALL),
            Instruction(Op.LW, rd=5, rs1=13, imm=0),
            Instruction(Op.EBREAK)]
    program = Program.from_instructions(ins)
    interp = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=16, collect_trace=True))
    matrix = trace_to_matrix(interp.run([[]])["trace"], program=program)
    proof = prove_trace(matrix, FriConfig(**SMALL_CONFIG), range_lookup=True,
                        program=program)
    _save_proof("e", proof, matrix)
    (HERE / "golden_e.program.zkir").write_bytes(program.to_bytes())


def _preprocessed_e() -> None:
    from zkir_tpu.prover import aux_table
    from zkir_tpu.prover import prover
    from zkir_tpu.prover.fri import FriConfig
    from zkir_tpu.spec import Program

    program = Program.from_bytes(
        (HERE / "golden_e.program.zkir").read_bytes())
    arrays = {}
    for table, pre in (
            ("aux", aux_table.preprocess_aux(10, 2)),
            ("program", prover.preprocess_program(
                list(program.code), 10, FriConfig(log_blowup=2)))):
        arrays[f"{table}_cols"] = np.asarray(pre["cols"])
        arrays[f"{table}_rows"] = np.asarray(pre["rows"])
        arrays[f"{table}_root"] = np.asarray(pre["root"], dtype=np.uint32)
        for k, level in enumerate(pre["levels"]):
            arrays[f"{table}_level_{k}"] = np.asarray(level)
    np.savez_compressed(HERE / "preprocessed_e.npz", **arrays)


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    makers = {"trace": _trace_2e16, "a": _golden_a, "b": _golden_b,
              "c": _golden_c, "d": _golden_d, "e": _golden_e,
              "pre": _preprocessed_e}
    for name in sys.argv[1:] or list(makers):
        makers[name]()
        print(f"made fixture {name}", flush=True)


if __name__ == "__main__":
    main()
