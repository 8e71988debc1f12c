#!/usr/bin/env python3
"""The largest trace one GPU proves, one-shot and streaming.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 zkir_tpu_torch/tools/stream_prove.py [--oneshot 18 19 20]
        [--streaming 20 21 22] [--col-block 64] [--out FILE]

For each size 2^k of each path (the defaults: up to the first size that
does not fit an 80 GB H100) a fresh process makes the
trace of ``exact_trace_program(k)`` on the card (``TpuInterpreter``, then
``trace_to_matrix``), proves it as ``prove --bind`` does (the full
constraint set, the program bound: one-shot ``prove_trace(range_lookup=
True, program=...)``, or ``prove_trace_streaming``), and verifies it with
the port's verifier.  A 2^10 prove of the same path runs first in that
process, so the kernel libraries and the quotient's parts are loaded
before the timed prove.  Each size prints one JSON line: peak device
memory over the prove (``torch.cuda.max_memory_allocated``), the prove's
seconds and rows per second, stage seconds (``ZKIR_PROVE_LOG``), verify
seconds, or the error that stopped it (an out-of-memory error: the size
does not fit the card).  ``--out`` appends the lines to a file.

The counterpart of the reference's ``tools/stream_prove.py``, which proves
one streaming size on a TPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def measure(mode: str, log_rows: int, col_block: int) -> dict:
    """Make, prove and verify one trace in this process (see the module
    docstring); the result's fields."""
    import torch

    sys.path.insert(0, str(ROOT))
    from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter
    from zkir_tpu_torch.prover import (FriConfig, prove_trace,
                                       trace_to_matrix, verify_trace)
    from zkir_tpu_torch.prover.benchtrace import exact_trace_program
    from zkir_tpu_torch.prover.streaming import prove_trace_streaming

    def make(k):
        program = exact_trace_program(k)
        trace = TpuInterpreter(program, InterpConfig(
            lanes=1, chunk=1024, collect_trace=True), device="cuda").run(
                [[]], max_cycles=2 << k)["trace"]
        return program, trace_to_matrix(trace)

    def prove(matrix, program):
        if mode == "streaming":
            return prove_trace_streaming(matrix, FriConfig(), program=program,
                                         col_block=col_block, device="cuda")
        return prove_trace(matrix, FriConfig(), range_lookup=True,
                           program=program, device="cuda")

    rec = {"path": mode, "log_rows": log_rows, "rows": 1 << log_rows}
    if mode == "streaming":
        rec["col_block"] = col_block
    program, matrix = make(10)
    prove(matrix, program)
    t0 = time.perf_counter()
    program, matrix = make(log_rows)
    rec["trace_s"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec["resident_bytes_before"] = torch.cuda.memory_allocated()
    os.environ["ZKIR_PROVE_LOG"] = "1"
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(log):
            proof = prove(matrix, program)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as exc:
        rec.update(fits=False, error=str(exc).splitlines()[0],
                   peak_bytes=torch.cuda.max_memory_allocated())
        return rec
    finally:
        del os.environ["ZKIR_PROVE_LOG"]
    rec["prove_s"] = time.perf_counter() - t0
    rec["rows_per_s"] = rec["rows"] / rec["prove_s"]
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    marks = [(float(m[1]), m[2]) for m in re.finditer(
        r"\[prove\s+([0-9.]+)s\] (.*) \[launches \d+\]", log.getvalue())]
    rec["stages_s"] = {msg: t1 - t0 for (t0, _), (t1, msg)
                       in zip([(0.0, "")] + marks, marks)}
    t0 = time.perf_counter()
    rec["verified"] = bool(verify_trace(proof, program, device="cuda"))
    rec["verify_s"] = time.perf_counter() - t0
    rec["fits"] = rec["verified"]
    return rec


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--oneshot", type=int, nargs="*",
                        default=[18, 19, 20])
    parser.add_argument("--streaming", type=int, nargs="*",
                        default=[20, 21, 22])
    parser.add_argument("--col-block", type=int, default=64)
    parser.add_argument("--out")
    parser.add_argument("--one", nargs=2, metavar=("PATH", "LOG_ROWS"),
                        help=argparse.SUPPRESS)   # the child process
    args = parser.parse_args()
    if args.one:
        print(json.dumps(measure(args.one[0], int(args.one[1]),
                                 args.col_block)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    failed = False
    for mode, sizes in (("oneshot", args.oneshot),
                        ("streaming", args.streaming)):
        for k in sizes:
            res = subprocess.run(
                [sys.executable, __file__, "--one", mode, str(k),
                 "--col-block", str(args.col_block)],
                capture_output=True, text=True, timeout=1800)
            lines = res.stdout.strip().splitlines()
            if res.returncode != 0 or not lines:
                rec = {"path": mode, "log_rows": k, "fits": False,
                       "error": f"exit {res.returncode}: "
                                f"{res.stderr.strip()[-2000:]}"}
            else:
                rec = json.loads(lines[-1])
            rec["card"] = card
            failed |= rec.get("verified") is False
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
