#!/usr/bin/env python3
"""Where the LogUp compression should run: host numpy or the device.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 zkir_tpu_torch/tools/sums_bench.py

On the 2^16-row benchmark trace with its program bound, times the
delta-compression (beta - sum_k comp_k delta^k over QM31) of per-row
tuples of the partial-sum stage's shapes twice: with
``_beta_minus_compress_np`` (host numpy on columns of the host matrix, one
multiply-accumulate per component and coordinate, then one upload) and
with ``_beta_minus_compress`` (rows of the device column matrix, stacked;
one broadcast product and one sum per coordinate).  Both must give the
same words.  Beside them: the whole partial-sum stage and the LDE plus
commit of the sums it feeds, from a stage-logged prove.
"""

from __future__ import annotations

import contextlib
import io
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    from zkir_tpu_torch.convert import trace_from_reference
    from zkir_tpu_torch.prover import FriConfig, prove_trace, trace_to_matrix
    from zkir_tpu_torch.prover import prover as pv
    from zkir_tpu_torch.prover import trace as tr
    from zkir_tpu_torch.spec import Program

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    fixtures = ROOT / "tests" / "fixtures" / "torch_port"
    matrix = trace_to_matrix(trace_from_reference(
        fixtures / "trace_exact_2e16.npz"))
    program = Program.from_bytes(
        (fixtures / "trace_exact_2e16.program.zkir").read_bytes())

    def prove():
        proof = prove_trace(matrix, FriConfig(), range_lookup=True,
                            program=program, device="cuda")
        torch.cuda.synchronize()
        return proof

    prove()
    os.environ["ZKIR_PROVE_LOG"] = "1"
    captured = io.StringIO()
    with contextlib.redirect_stderr(captured):
        prove()
    del os.environ["ZKIR_PROVE_LOG"]
    print(captured.getvalue())

    # Per-row tuples of the stage's shapes, as host arrays and as rows of
    # the device column matrix: the memory tuples' (19 components of [n]),
    # the crypto tape's (92 of [n]) and the crypto slots' (19 of [11, n]).
    # Byte columns of the trace stand in for the components: the cost
    # depends on shape and type only.
    padded = pv._pad_rows(matrix, min_log=10)[0].copy()
    pv._build_memory_table(padded, matrix.shape[0], program=program)
    cols = pv._words(padded, "cuda").T.contiguous()

    # Each component is the trace column of one index, or the stack of
    # several.
    def host_comps(index_lists):
        return [padded[:, ix[0]] if len(ix) == 1
                else np.stack([padded[:, i] for i in ix])
                for ix in index_lists]

    def dev_comps(index_lists):
        return [cols[ix[0]] if len(ix) == 1
                else torch.stack([cols[i] for i in ix]) for ix in index_lists]

    base = tr.COL_CRB0
    cases = (
        ("memory-tuple shape, 19 x [n]", [[base + k] for k in range(19)]),
        ("crypto-tape shape, 92 x [n]", [[base + k] for k in range(92)]),
        ("crypto-slot shape, 19 x [11, n]",
         [[base + (s + c) % 56 for s in range(11)] for c in range(19)]))
    beta, delta = (11, 22, 33, 44), (5, 6, 7, 8)
    total = {"host": 0.0, "device": 0.0}
    for name, index_lists in cases:
        for _ in range(2):          # the second round is the warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bw = pv._beta_minus_compress_np(host_comps(index_lists), beta,
                                            delta)
            host = tuple(pv._words(r, "cuda") for r in bw)
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            dev = pv._beta_minus_compress(dev_comps(index_lists), beta,
                                          delta)
            torch.cuda.synchronize()
            dev_s = time.perf_counter() - t0
        if not all(torch.equal(h, d) for h, d in zip(host, dev)):
            raise AssertionError(f"{name}: host and device words differ")
        total["host"] += host_s
        total["device"] += dev_s
        print(f"{name}: host numpy {host_s:.4f} s, device {dev_s:.4f} s, "
              "equal words")
    print(f"all three: host numpy {total['host']:.4f} s, device "
          f"{total['device']:.4f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
