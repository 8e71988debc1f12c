#!/usr/bin/env python3
"""The generated quotient kernels at several part sizes, on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 zkir_tpu_torch/tools/quotient_bench.py [BUDGET:MIN_BLOCKS ...]

(default: 900:4 600:4 400:4 1200:2 2500:1).  Proves the 2^16-row
benchmark trace once on the main path (``range_lookup=True``, program
bound) to take the quotient's inputs, then for each variant of
``quotient_codegen.PART_BUDGET`` (operations a part) and ``MIN_BLOCKS``
(``__launch_bounds__``'s blocks per SM, which caps the registers) builds
the parts and prints one JSON line: the parts, their build seconds,
registers and spills, whether the words equal the plain version's, the
launches alone with the table built (CUDA events), the whole wrapper, the
host's table, the byte bound (``chip_smoke.quotient_bytes``: each column
once, the same for every variant) and the bytes the parts move (a column
once per part that reads it).
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.convert import trace_from_reference
    from zkir_tpu_torch.prover import FriConfig, prove_trace, trace_to_matrix
    from zkir_tpu_torch.prover import constraints as cs
    from zkir_tpu_torch.prover import quotient_codegen as qc
    from zkir_tpu_torch.prover.benchtrace import exact_trace_program

    variants = [tuple(map(int, v.split(":"))) for v in sys.argv[1:]] or [
        (900, 4), (600, 4), (400, 4), (1200, 2), (2500, 1)]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    _kernels.build()
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
    features = qc.features_of(kwargs)
    for budget, min_blocks in variants:
        qc.PART_BUDGET, qc.MIN_BLOCKS = budget, min_blocks
        qc._PREPARED.clear()
        t0 = time.perf_counter()
        kernel = qc.prepare(features)[0]
        build_s = time.perf_counter() - t0
        regs, spills = [], 0
        for part in kernel.parts:
            ptxas = (qc.BUILD / f"part_{part.key}.log").read_text()
            regs.append(int(re.search(r"Used (\d+) registers", ptxas)[1]))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", ptxas)
            spills += int(m[1]) + int(m[2])
        got = cs.quotient_evals(*args, **kwargs)
        torch.cuda.synchronize()
        tab, offsets = kernel.table(A, keys, args[5])
        table_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            kernel.table(A, keys, args[5])
            table_s.append(time.perf_counter() - t0)
        columns = sum(len(p.leaves) + 2 * len({t for t, _ in
                                               kernel.rec.terms[p.lo:p.hi]})
                      for p in kernel.parts)
        print(json.dumps({
            "budget": budget, "min_blocks": min_blocks,
            "parts": len(kernel.parts), "build_s": build_s,
            "exact": all(torch.equal(g, w) for g, w in zip(got, want)),
            "launches_ms": chip_smoke.cuda_ms(lambda: kernel.launch(
                tab, offsets, dinv, n, args[3]), 20),
            "wrapper_ms": chip_smoke.cuda_ms(
                lambda: cs.quotient_evals(*args, **kwargs), 20),
            "host_table_ms": 1e3 * min(table_s),
            "bound_bytes_ms": chip_smoke.quotient_bytes(kernel, n)
            / chip_smoke.HBM_BYTES_PER_S * 1e3,
            "split_bytes_ms": 8 * n * (columns + 4)
            / chip_smoke.HBM_BYTES_PER_S * 1e3,
            "max_registers": max(regs), "spill_bytes": spills}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
