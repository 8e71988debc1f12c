#!/usr/bin/env python3
"""Time the LogUp partial-sum stage of the 2^16 main path, of this tree or
of others side by side, and where its compression should run.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 zkir_tpu_torch/tools/sums_bench.py [--iters N] [ROOT ...]

Each ROOT (default: this repository) is a checkout whose
``zkir_tpu_torch`` is imported in a process of its own (for a parent
commit: ``git archive`` it into a git-ignored directory such as
``.chip_scratch/parent``).  There the 2^16-row benchmark trace
(``tests/fixtures/torch_port/trace_exact_2e16.npz`` of this repository)
is proved with ``range_lookup=True`` and its program bound, once to warm
up and once stage-logged (``ZKIR_PROVE_LOG=1``, printed), and then:

- the stage: the arguments of the prover's call of
  ``prover._sums_columns`` are kept and the stage is run ``N`` times (after
  one warm-up), each between two device synchronisations, with its
  launches counted by kernel; the sums columns of every run must equal the
  first's;
- the delta-compression (beta - sum_k comp_k delta^k over QM31) of per-row
  tuples of the stage's shapes, twice: with ``_beta_minus_compress_np``
  (host numpy on columns of the host matrix, then one upload) and with
  ``_beta_minus_compress`` (rows of the device column matrix, stacked;
  one broadcast product and one sum per coordinate); both must give the
  same words.

The last line of each root's output is a JSON object: the stage's seconds
of each run, their median, its launches by kernel, a digest of its
columns (equal across roots when the trees compute the same words) and
the compression's seconds.  Give the roots in turns (parent, change,
change, parent) to compare within one call.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[2]


def child(root: str, iters: int) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    sync = torch.cuda.synchronize
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.convert import trace_from_reference
    from zkir_tpu_torch.prover import FriConfig, prove_trace, trace_to_matrix
    from zkir_tpu_torch.prover import prover as pv
    from zkir_tpu_torch.prover import trace as tr
    from zkir_tpu_torch.spec import Program

    fixtures = HERE / "tests" / "fixtures" / "torch_port"
    matrix = trace_to_matrix(trace_from_reference(
        fixtures / "trace_exact_2e16.npz"))
    program = Program.from_bytes(
        (fixtures / "trace_exact_2e16.program.zkir").read_bytes())
    kept = {}
    real = pv._sums_columns

    def spy(*args):
        kept["args"] = args
        return real(*args)

    def prove():
        proof = prove_trace(matrix, FriConfig(), range_lookup=True,
                            program=program, device="cuda")
        sync()
        return proof

    pv._sums_columns = spy
    try:
        prove()
    finally:
        pv._sums_columns = real
    os.environ["ZKIR_PROVE_LOG"] = "1"
    captured = io.StringIO()
    with contextlib.redirect_stderr(captured):
        prove()
    del os.environ["ZKIR_PROVE_LOG"]
    print(captured.getvalue(), flush=True)

    args = kept["args"]
    first = real(*args)
    sync()
    digest = hashlib.sha256(b"".join(
        t.cpu().numpy().tobytes() for t in first)).hexdigest()[:16]
    seconds = []
    for _ in range(iters):
        _kernels.reset_launches()
        sync()
        t0 = time.perf_counter()
        out = real(*args)
        sync()
        seconds.append(time.perf_counter() - t0)
        if any(not torch.equal(a, b) for a, b in zip(out, first)):
            raise AssertionError(f"{root}: the stage's columns changed")
    stage = {"seconds": seconds, "median_s": statistics.median(seconds),
             "launches": {k: v for k, v in _kernels.launches.items() if v},
             "columns": [list(t.shape) for t in first], "digest": digest}

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
            sync()
            t0 = time.perf_counter()
            bw = pv._beta_minus_compress_np(host_comps(index_lists), beta,
                                            delta)
            host = tuple(pv._words(r, "cuda") for r in bw)
            sync()
            host_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            dev = pv._beta_minus_compress(dev_comps(index_lists), beta,
                                          delta)
            sync()
            dev_s = time.perf_counter() - t0
        if not all(torch.equal(h, d) for h, d in zip(host, dev)):
            raise AssertionError(f"{name}: host and device words differ")
        total["host"] += host_s
        total["device"] += dev_s
        print(f"{name}: host numpy {host_s:.4f} s, device {dev_s:.4f} s, "
              "equal words")
    return {"root": root, "stage": stage, "compression_s": total}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="*", default=[str(HERE)])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        print(json.dumps(child(args.roots[0], args.iters)))
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for root in args.roots:
        res = subprocess.run(
            [sys.executable, __file__, "--child", "--iters",
             str(args.iters), str(pathlib.Path(root).resolve())],
            capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            return res.returncode
        print(res.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
