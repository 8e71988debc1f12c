"""Command-line toolchain: assemble, disassemble, run, prove, warm, verify.

Counterpart of ``zkir_tpu/cli.py``, with the reference's arguments and
printed lines.  Everything that computes runs on ``--device`` (default
``cuda``); without a GPU and without ``--device cpu``, ``run``, ``prove``,
``warm`` and ``verify`` fail with a message instead of running quietly on
the CPU (``asm``, ``disasm`` and ``run --engine native|oracle`` are host
code).

Usage:
    python -m zkir_tpu_torch asm program.zkasm -o program.zkir
    python -m zkir_tpu_torch disasm program.zkir
    python -m zkir_tpu_torch run program.zkir --input 5
    python -m zkir_tpu_torch run program.zkir --input 5 --engine native
    python -m zkir_tpu_torch run program.zkir --input 5 --engine oracle
    python -m zkir_tpu_torch prove program.zkir --input 5 --bind -o proof.json
    python -m zkir_tpu_torch prove program.zkir --input 5 --bind --mesh 4
    python -m zkir_tpu_torch warm --log-rows 16 [--streaming]
    python -m zkir_tpu_torch verify proof.json --binary program.zkir
    python -m zkir_tpu_torch --device cpu prove program.zkasm --input 5

``run --engine`` is ``gpu`` (the batched interpreter on ``--device``, the
counterpart of the reference's ``tpu``; the default on the card) or
``native`` (the reference's default: the C++ core on the host, which stops
at ``--max-cycles`` and exits 1 on any halt but EBREAK and EXIT; the
default with ``--device cpu``) or ``oracle`` (the scalar Python VM of
``runtime/vm.py``, the specification the other engines are held to;
exit 0); both host engines are refused beside an explicit ``--device
cuda``.  ``prove --streaming [--col-block N]`` proves with the
column-streaming prover (the same proof in less device memory; always the
full constraint set, the program bound only with ``--bind``); it refuses
``--checkpoint-dir``, which it would not honour.  ``prove --mesh N``
starts N local ranks, a process each (NCCL, rank r on ``cuda:r``; gloo
with ``--device cpu``), each interpreting the program and proving on its
own device over ``parallel.make_mesh(N)`` (with ``--bind`` and
``--streaming`` alike); rank 0 writes the proof and prints the line.  N
must be a power of two, and on ``cuda`` at most the number of cards.
``warm`` proves and verifies a synthetic trace of 2^``--log-rows`` rows,
which builds the kernel library and the quotient's generated parts that
proves of that feature set need (``prover/quotient_codegen.py``; the
one-coset parts with ``--streaming``); ``--cache-dir D`` sets
``ZKIR_CACHE_DIR``, so that the parts go to ``D/quotient``, where later
processes with the same ``ZKIR_CACHE_DIR`` load them.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time


def _load_program(path: str):
    from .asm import assemble
    from .spec import Program

    p = pathlib.Path(path)
    if p.suffix == ".zkasm":
        return assemble(p.read_text())
    return Program.from_bytes(p.read_bytes())


def cmd_asm(args) -> int:
    from .asm import assemble

    program = assemble(pathlib.Path(args.source).read_text())
    out = args.output or str(pathlib.Path(args.source).with_suffix(".zkir"))
    pathlib.Path(out).write_bytes(program.to_bytes())
    print(f"assembled {len(program.code)} instructions -> {out}")
    return 0


def cmd_disasm(args) -> int:
    from .asm import disassemble

    print(disassemble(_load_program(args.binary)), end="")
    return 0


def cmd_run(args) -> int:
    program = _load_program(args.binary)
    inputs = [int(x, 0) for x in args.input]

    if args.engine == "native":
        from .runtime.native_vm import HALT_EBREAK, HALT_EXIT, run_native

        result = run_native(program, inputs, max_cycles=args.max_cycles)
        print(f"halt={result.halt} cycles={result.cycles} "
              f"exit={result.exit_code} outputs={result.outputs}")
        return 0 if result.halt in (HALT_EBREAK, HALT_EXIT) else 1
    if args.engine == "oracle":
        from .runtime import VM, VMConfig

        result = VM(program, inputs,
                    VMConfig(max_cycles=args.max_cycles)).run()
        print(f"halt={result.halt_reason.reason.value} cycles={result.cycles} "
              f"exit={result.halt_reason.code} outputs={result.outputs}")
        return 0
    from .interp import InterpConfig, TpuInterpreter

    interp = TpuInterpreter(program, InterpConfig(lanes=1, chunk=256),
                            device=args.device)
    result = interp.run([inputs], max_cycles=args.max_cycles)
    print(f"halt={int(result['halted'][0])} "
          f"cycles={int(result['cycles'][0])} "
          f"exit={int(result['exit_code'][0])} "
          f"outputs={[int(x) for x in result['outputs'][0]]}")
    return 0


def cmd_prove(args) -> int:
    if args.streaming and args.checkpoint_dir:
        raise SystemExit(
            "error: prove --streaming writes no stage checkpoints (the "
            "streaming prover does not persist its stages, so a rerun "
            "could not resume); drop --checkpoint-dir, or prove without "
            "--streaming to checkpoint")
    if not args.mesh:
        return _prove(args)
    from .parallel import run_local_ranks

    n = args.mesh
    if n < 1 or n & (n - 1):
        raise SystemExit(f"error: --mesh {n}: the prover shards over a "
                         "power of two of devices")
    if args.device == "cuda":
        import torch

        if n > torch.cuda.device_count():
            raise SystemExit(f"error: --mesh {n}: requested {n} devices, "
                             f"only {torch.cuda.device_count()} available")
        # Build once here what every rank loads: the kernel library and
        # the quotient's parts of this prove's feature set.
        from . import _kernels
        from .prover import FriConfig, quotient_codegen

        _kernels.build()
        # The streaming prover always has the lookups, and evaluates the
        # quotient on one coset at log_blowup 0.
        quotient_codegen.prepare(quotient_codegen.plan_key(
            args.bind or args.streaming, args.bind,
            0 if args.streaming else FriConfig().log_blowup))
    run_local_ranks(_prove, n, args, device=args.device)
    return 0


def _prove(args) -> int:
    """Interpret and prove on ``args.device``, or, on a rank of ``prove
    --mesh``, on its mesh device; rank 0 writes the proof and prints."""
    from .convert import proof_to_json
    from .interp import InterpConfig, TpuInterpreter
    from .prover import prove_trace, trace_to_matrix

    mesh = None
    if args.mesh:
        from .parallel import make_mesh

        mesh = make_mesh(args.mesh, device=args.device)
    device = args.device if mesh is None else str(mesh.device)
    program = _load_program(args.binary)
    inputs = [int(x, 0) for x in args.input]
    interp = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=256, collect_trace=True), device=device)
    result = interp.run([inputs], max_cycles=args.max_cycles)
    matrix = trace_to_matrix(result["trace"], program=program)
    if args.streaming:
        # Always the full constraint set; the program bound with --bind.
        from .prover.streaming import prove_trace_streaming

        proof = prove_trace_streaming(
            matrix, program=program if args.bind else None,
            col_block=args.col_block, mesh=mesh, device=device)
    elif args.bind:
        proof = prove_trace(matrix, range_lookup=True, program=program,
                            mesh=mesh, checkpoint_dir=args.checkpoint_dir,
                            device=device)
    else:
        proof = prove_trace(matrix, mesh=mesh,
                            checkpoint_dir=args.checkpoint_dir, device=device)
    if mesh is not None and mesh.index != 0:
        return 0
    out = args.output or "proof.json"
    pathlib.Path(out).write_text(proof_to_json(proof))
    print(f"proved {matrix.shape[0]} trace rows "
          f"({int(result['cycles'][0])} cycles) -> {out}")
    return 0


def cmd_warm(args) -> int:
    """Fill the build caches for a prove shape: prove a synthetic trace of
    2^``log_rows`` rows (``exact_trace_matrix``) with the full constraint
    set and no program, as the reference's ``warm`` does, and verify it.
    On a card this builds the kernel library and the quotient's parts of
    that feature set (the one-coset parts with ``--streaming``); a later
    process with the same ``ZKIR_CACHE_DIR`` loads them."""
    from .prover import FriConfig, prove_trace, verify_trace
    from .prover.benchtrace import exact_trace_matrix

    if args.cache_dir:
        # The quotient's parts are built in and loaded from
        # DIR/quotient (quotient_codegen.build_dir).
        os.environ["ZKIR_CACHE_DIR"] = args.cache_dir
    t0 = time.perf_counter()
    matrix = exact_trace_matrix(args.log_rows, device=args.device)
    if args.streaming:
        from .prover.streaming import prove_trace_streaming

        proof = prove_trace_streaming(matrix, FriConfig(),
                                      col_block=args.col_block,
                                      device=args.device)
    else:
        proof = prove_trace(matrix, FriConfig(), range_lookup=True,
                            device=args.device)
    if not verify_trace(proof, device=args.device):
        raise SystemExit("error: warm: the port's verifier rejects the "
                         "synthetic proof")
    print(f"warmed prove kernels for 2^{args.log_rows} rows in "
          f"{time.perf_counter() - t0:.1f}s")
    return 0


def cmd_verify(args) -> int:
    from .convert import proof_from_json
    from .prover import verify_trace

    proof = proof_from_json(pathlib.Path(args.proof).read_text())
    program = _load_program(args.binary) if args.binary else None
    if proof.get("program") and program is None:
        print("error: program-bound proof requires the public program "
              "(pass --binary); the memory argument's init demand is "
              "recomputed from its code/data segments")
        return 1
    ok = verify_trace(proof, program=program, device=args.device)
    print("VALID" if ok else "INVALID")
    return 0 if ok else 1


def _require_device(device: str) -> None:
    """Fail, with a message, where the requested GPU is not there."""
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit(
                "error: --device cuda (the default) needs an NVIDIA GPU and "
                "torch.cuda.is_available() is false; pass --device cpu to "
                "run the plain versions on the CPU")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="zkir_tpu_torch")
    parser.add_argument("--device", choices=["cuda", "cpu"],
                        help="where the interpreter, prover and verifier "
                             "run (default cuda; cpu takes the kernels' "
                             "plain versions)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("asm", help="assemble .zkasm to a .zkir binary")
    p.add_argument("source")
    p.add_argument("-o", "--output")
    p.set_defaults(fn=cmd_asm)

    p = sub.add_parser("disasm", help="disassemble a .zkir binary")
    p.add_argument("binary")
    p.set_defaults(fn=cmd_disasm)

    p = sub.add_parser("run", help="execute a program")
    p.add_argument("binary")
    p.add_argument("--input", action="append", default=[],
                   help="input tape value (repeatable)")
    p.add_argument("--engine", choices=["oracle", "native", "gpu"],
                   help="gpu: the batched interpreter on --device (the "
                        "default); native: the C++ core on the host, no "
                        "GPU (the default with --device cpu); oracle: the "
                        "scalar Python VM on the host")
    p.add_argument("--max-cycles", type=int, default=1_000_000)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("prove", help="execute + prove the trace")
    p.add_argument("binary")
    p.add_argument("--input", action="append", default=[])
    p.add_argument("--max-cycles", type=int, default=100_000)
    p.add_argument("--bind", action="store_true",
                   help="full soundness: in-circuit range lookups + "
                        "program binding (pads the trace to >= 1024 rows)")
    p.add_argument("--checkpoint-dir",
                   help="persist per-stage prove artifacts here; a killed "
                        "prove rerun with the same inputs resumes past "
                        "completed stages (bit-identical proof)")
    p.add_argument("--streaming", action="store_true",
                   help="column-streaming prover: the same proof in "
                        "O(col_block x domain) device memory; always the "
                        "full constraint set (no --checkpoint-dir)")
    p.add_argument("--col-block", type=int, default=64,
                   help="streaming column block size (default 64)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the prove over an N-device mesh, a local "
                        "process a device (composes with --streaming)")
    p.add_argument("-o", "--output")
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser("warm", help="build the prover's kernels for a "
                                    "trace size (persistent cache)")
    p.add_argument("--log-rows", type=int, default=13)
    p.add_argument("--cache-dir",
                   help="the build cache's root (ZKIR_CACHE_DIR): the "
                        "quotient's parts go to DIR/quotient")
    p.add_argument("--streaming", action="store_true",
                   help="warm the streaming prover's kernels instead")
    p.add_argument("--col-block", type=int, default=64)
    p.set_defaults(fn=cmd_warm)

    p = sub.add_parser("verify", help="verify a proof")
    p.add_argument("proof")
    p.add_argument("--binary",
                   help="the public program; required to pin a "
                        "program-bound proof to it")
    p.set_defaults(fn=cmd_verify)

    args = parser.parse_args(argv)
    if args.fn is cmd_run:
        if args.engine is None:
            args.engine = "native" if args.device == "cpu" else "gpu"
        if args.engine in ("native", "oracle") and args.device == "cuda":
            raise SystemExit(
                f"error: run --engine {args.engine} runs on the host; drop "
                "--device cuda, or pass --engine gpu to run on the GPU")
    args.device = args.device or "cuda"
    # asm, disasm and the host engines of run need no device.
    if args.fn in (cmd_prove, cmd_warm, cmd_verify) or (
            args.fn is cmd_run and args.engine == "gpu"):
        _require_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
