#!/usr/bin/env python3
"""The generated quotient kernels in several designs, on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 zkir_tpu_torch/tools/quotient_bench.py [TILE:MIN_BLOCKS:PART_BUDGET[:STAGE_COLUMNS] ...]

(default: the module's design, then parts of 800 and 1,200 operations,
and stages of 32 new columns).  Proves the 2^16-row benchmark trace once
on the main path (``range_lookup=True``, program bound) to take the
quotient's inputs, then for each design of ``quotient_codegen`` (``TILE``
points a CTA, ``MIN_BLOCKS`` CTAs an SM, which sets the shared-memory
slots a CTA has, ``PART_BUDGET`` operations a part and ``STAGE_COLUMNS``
new columns a stage) builds the parts and prints one JSON line: the
parts (a launch each) and stages, the build seconds, each part's
registers, spills, shared memory and CTAs an SM, whether the words equal the plain version's, the
launches alone with the tables built (CUDA events), the whole wrapper,
the host's table, the global column reads a point by the staging plan
and the bytes they move.  The designs are module constants here only:
the prover has one design.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

REGISTERS_PER_SM = 65_536


def ctas_per_sm(threads: int, registers: int, smem: int, qc) -> int:
    """CTAs an H100 SM holds at once: its registers (a warp's allocated
    in units of 256), its shared memory (each CTA's plus what the system
    keeps of it) and its 64 warps."""
    warps = threads // 32
    per_warp = math.ceil(registers * 32 / 256) * 256
    return min(REGISTERS_PER_SM // (per_warp * warps),
               qc.SMEM_PER_SM // (smem + qc.SMEM_RESERVED), 64 // warps, 32)


def main() -> int:
    import torch

    import chip_smoke
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.convert import trace_from_reference
    from zkir_tpu_torch.prover import FriConfig, prove_trace, trace_to_matrix
    from zkir_tpu_torch.prover import constraints as cs
    from zkir_tpu_torch.prover import quotient_codegen as qc
    from zkir_tpu_torch.prover.benchtrace import exact_trace_program
    from zkir_tpu_torch.tools.sass_count import instructions

    design = (qc.TILE, qc.MIN_BLOCKS, qc.PART_BUDGET, qc.STAGE_COLUMNS)
    variants = [tuple(map(int, v.split(":"))) for v in sys.argv[1:]] or [
        design, (*design[:2], 800, design[3]), (*design[:2], 1_200, design[3]),
        (*design[:3], 32)]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _kernels.build()
    cuobjdump = pathlib.Path(_kernels._nvcc()).parent / "cuobjdump"
    matrix = trace_to_matrix(trace_from_reference(
        chip_smoke.FIXTURES / "trace_exact_2e16.npz"))
    with chip_smoke.quotient_calls() as calls:
        prove_trace(matrix, FriConfig(), device="cuda", range_lookup=True,
                    program=exact_trace_program(16))
    args, kwargs = calls[0]
    want = cs.quotient_evals_plain(*args, **kwargs)
    A, keys = cs._vec_alg(args[0], args[1], args[3], **kwargs)
    dinv = qc._dinv_rows(args[2], args[3], tuple(args[4]), args[0].device)
    n = args[0].shape[1]
    key = (qc.features_of(kwargs), args[3])
    for variant in variants:
        tile, min_blocks, part_budget, stage_columns = (
            *variant, *design[len(variant):])
        qc.TILE, qc.MIN_BLOCKS, qc.PART_BUDGET = tile, min_blocks, part_budget
        qc.STAGE_COLUMNS = stage_columns
        qc._PREPARED.clear()
        t0 = time.perf_counter()
        kernel = qc.prepare(key)[0]
        build_s = time.perf_counter() - t0
        regs, spills = [], 0
        for part in kernel.parts:
            ptxas = (qc.build_dir() / f"part_{part.key}.log").read_text()
            regs.append(int(re.search(r"Used (\d+) registers", ptxas)[1]))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ptxas)
            spills += int(m[1]) + int(m[2])
        got = cs.quotient_evals(*args, **kwargs)
        torch.cuda.synchronize()
        tables = kernel.table(A, keys, args[5])
        table_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            kernel.table(A, keys, args[5])
            table_s.append(time.perf_counter() - t0)
        reads = sum(p.reads for p in kernel.parts)
        for part in kernel.parts:
            base = qc.build_dir() / f"part_{part.key}"
            base.with_suffix(".sass").write_text(subprocess.run(
                [str(cuobjdump), "-sass", str(base.with_suffix(".so"))],
                capture_output=True, text=True, check=True).stdout)
        smem = [4 * (tile + (1 << args[3])) * p.staging.slots
                for p in kernel.parts]
        print(json.dumps({
            "tile": tile, "min_blocks": min_blocks,
            "part_budget": part_budget, "stage_columns": stage_columns,
            "parts": len(kernel.parts), "launches": len(kernel.parts),
            "stages": sum(len(p.stages) for p in kernel.parts),
            "build_s": build_s,
            "exact": all(torch.equal(g, w) for g, w in zip(got, want)),
            "launches_ms": chip_smoke.cuda_ms(
                lambda: kernel.launch(tables, dinv, n), 20),
            "sass": [len(instructions(qc.build_dir() / f"part_{p.key}.sass",
                                      "quotient_part_kernel"))
                     for p in kernel.parts],
            "wrapper_ms": chip_smoke.cuda_ms(
                lambda: cs.quotient_evals(*args, **kwargs), 20),
            "host_table_ms": 1e3 * min(table_s),
            "column_reads": reads,
            "plan_bytes_ms": 8 * n * (reads + 4)
            / chip_smoke.HBM_BYTES_PER_S * 1e3,
            "registers": regs, "spill_bytes": spills, "smem_bytes": smem,
            "ctas_per_sm": [ctas_per_sm(tile, r, s, qc)
                            for r, s in zip(regs, smem)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
