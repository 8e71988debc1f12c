#!/usr/bin/env python3
"""Where a warm 2^16-row prove spends its host time, on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 zkir_tpu_torch/tools/profile_prove.py [--bound] [--interpret]

Proves the 2^16 x 493 benchmark trace (the fixture of ``chip_smoke.py``)
once to warm up, three times for wall time, once with
``ZKIR_PROVE_LOG=1`` for the stage times and launches, and once under
``cProfile``: the functions by own time and by cumulative time.  The
device is idle for most of a prove, so the host profile is where the
time is.  With ``--bound`` the prove is the full constraint set with the
program bound (``range_lookup=True, program=...``).  With
``--interpret`` the matrix is made as the main path makes it before the
proves: ``exact_trace_program(16)`` run on the card by the interpreter,
then ``trace_to_matrix`` (both kept alive, as a CLI prove keeps them).
"""

from __future__ import annotations

import cProfile
import io
import os
import pathlib
import pstats
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.convert import trace_from_reference
    from zkir_tpu_torch.prover import FriConfig, prove_trace, trace_to_matrix

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    fixtures = ROOT / "tests" / "fixtures" / "torch_port"
    if "--interpret" in sys.argv[1:]:
        from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter
        from zkir_tpu_torch.prover.benchtrace import exact_trace_program

        t0 = time.perf_counter()
        trace = TpuInterpreter(exact_trace_program(16), InterpConfig(
            lanes=1, chunk=1024, collect_trace=True), device="cuda").run(
                [[]], max_cycles=1 << 17)["trace"]
        matrix = trace_to_matrix(trace)
        print(f"interpreted and built the matrix in "
              f"{time.perf_counter() - t0:.4f} s", flush=True)
    else:
        matrix = trace_to_matrix(trace_from_reference(
            fixtures / "trace_exact_2e16.npz"))
    kwargs = {}
    if "--bound" in sys.argv[1:]:
        from zkir_tpu_torch.spec import Program

        kwargs = {"range_lookup": True, "program": Program.from_bytes(
            (fixtures / "trace_exact_2e16.program.zkir").read_bytes())}

    def prove():
        proof = prove_trace(matrix, FriConfig(), device="cuda", **kwargs)
        torch.cuda.synchronize()
        return proof

    prove()
    for _ in range(3):
        t0 = time.perf_counter()
        prove()
        print(f"warm prove {time.perf_counter() - t0:.4f} s", flush=True)
    os.environ["ZKIR_PROVE_LOG"] = "1"
    prove()
    del os.environ["ZKIR_PROVE_LOG"]
    _kernels.reset_launches()
    profile = cProfile.Profile()
    profile.enable()
    prove()
    profile.disable()
    print(f"launches: {_kernels.launches}")
    for order, count in (("tottime", 30), ("cumulative", 35)):
        out = io.StringIO()
        pstats.Stats(profile, stream=out).sort_stats(order).print_stats(count)
        print(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
