#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``zkir_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from ``zkir_tpu_torch/csrc`` (nvcc, sm_90a);
3. hold each kernel against its plain torch version on the card, for
   exact equality, at the main path's shapes (timed with CUDA events)
   and at a few more, plus the pinned Poseidon2 known-answer vectors;
4. prove the small golden traces on the card and require proofs equal
   (after a JSON round trip) to the stored reference proofs;
5. prove the 2^16-row benchmark trace (493 columns, production
   ``FriConfig()``) twice, cold and warm; the port's verifier must
   accept the proof, and every kernel must have been launched by it.

The line before the last is a JSON object with one entry per kernel
(launches in the cold 2^16 prove, max |kernel - plain|, kernel and plain
milliseconds); the line before it holds the prove's timings; the last
line is ``{"ok": true, "device": {...}}``.  The script imports
nothing of JAX.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
P = (1 << 31) - 1
SEED = 20261016

# C entry point -> (source, the TPU kernel it replaces).
KERNELS = {
    "m31_binary": ("zkir_tpu_torch/csrc/m31_binary.cu",
                   "zkir_tpu/ops/field_ops.py:190"),
    "p2_permute": ("zkir_tpu_torch/csrc/poseidon2.cu",
                   "zkir_tpu/ops/poseidon2.py:261"),
    "p2_sponge_rows": ("zkir_tpu_torch/csrc/poseidon2.cu",
                       "zkir_tpu/ops/poseidon2.py:261"),
    "p2_compress_level": ("zkir_tpu_torch/csrc/poseidon2.cu",
                          "zkir_tpu/ops/poseidon2.py:261"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs, CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def words(gen, shape):
    import torch

    return torch.randint(0, P, shape, generator=gen, device="cuda",
                         dtype=torch.int64)


def compare(name, kernel_fn, plain_fn, iters, results):
    """Run the kernel's wrapper and its plain version on the same card
    tensors; require equal words; time both."""
    import torch

    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = int((got - want).abs().max().item()) if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version, max |diff| = {err}")
    ms = cuda_ms(kernel_fn, iters)
    plain_ms = cuda_ms(plain_fn, iters)
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    log(f"{name}: exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        f"({tuple(got.shape)})")


def phase_kernels(results) -> None:
    import torch

    from zkir_tpu_torch.ops import field_ops as f
    from zkir_tpu_torch.ops import merkle
    from zkir_tpu_torch.ops import poseidon2 as p2
    from zkir_tpu_torch.ops.poseidon2_ref import (bytes_to_field_elements,
                                                  poseidon2_permute,
                                                  poseidon2_sponge)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    # K1 on 2^24 seeded words, with the edge words 0, 1, p - 1 paired
    # against each other at the front.
    edge = torch.tensor([0, 1, P - 1], device="cuda", dtype=torch.int64)
    a = torch.cat([edge.repeat_interleave(3), words(gen, (1 << 24,))])
    b = torch.cat([edge.repeat(3), words(gen, (1 << 24,))])
    for op, plain in (("add", f.add_plain), ("sub", f.sub_plain)):
        got = getattr(f, f"m31_{op}")(a, b)
        if not torch.equal(got, plain(a, b)):
            raise AssertionError(f"m31_binary {op} differs from plain")
        log(f"m31_binary {op}: exact")
    compare("m31_binary", lambda: f.m31_mul(a, b),
            lambda: f.mul_plain(a, b), 20, results)

    # K2 at the main path's shapes: a grinding batch, the trace-commit
    # row sponge (2^18 rows of 2 x 493 words), the first tree level.
    states = words(gen, (1 << 16, 16))
    compare("p2_permute", lambda: p2.poseidon2_permute_batch(states),
            lambda: p2.permute_plain(states), 10, results)
    rows = words(gen, (1 << 18, 986))
    compare("p2_sponge_rows", lambda: merkle.hash_rows(rows),
            lambda: p2.sponge_rows_plain(rows), 2, results)
    del rows
    leaves = words(gen, (1 << 18, 8))
    compare("p2_compress_level",
            lambda: p2.poseidon2_compress_level(leaves),
            lambda: p2.compress_level_plain(leaves), 10, results)
    del leaves
    # The same entry points at more shapes (equality only): larger and
    # smaller batches, a row width that is a multiple of 8, and batches
    # that do not fill the last thread block.
    for name, kernel_fn, plain_fn, shape in (
            ("p2_permute", p2.poseidon2_permute_batch, p2.permute_plain,
             (1 << 20, 16)),
            ("p2_permute", p2.poseidon2_permute_batch, p2.permute_plain,
             (1000, 16)),
            ("p2_sponge_rows", merkle.hash_rows, p2.sponge_rows_plain,
             (1 << 14, 986)),
            ("p2_sponge_rows", merkle.hash_rows, p2.sponge_rows_plain,
             (999, 16)),
            ("p2_compress_level", p2.poseidon2_compress_level,
             p2.compress_level_plain, (1 << 16, 8)),
            ("p2_compress_level", p2.poseidon2_compress_level,
             p2.compress_level_plain, (2 * 999, 8))):
        x = words(gen, shape)
        if not torch.equal(kernel_fn(x), plain_fn(x)):
            raise AssertionError(f"{name} differs from its plain version "
                                 f"at {shape}")
        log(f"{name}: exact at {shape}")

    # Pinned known-answer vectors (docs/POSEIDON2.md).
    kat = {(0,) * 16: [1304355236, 1786230697, 1252711109, 1945258516],
           tuple(range(16)): [1663501927, 1148442227, 887313724, 52423570]}
    for state, want in kat.items():
        got = p2.poseidon2_permute_batch(
            torch.tensor([state], device="cuda", dtype=torch.int64))
        if got[0, :4].tolist() != want or \
                got[0].tolist() != poseidon2_permute(list(state)):
            raise AssertionError(f"permutation KAT failed for {state}")
    abc = bytes_to_field_elements(b"abc")
    got = merkle.hash_rows(torch.tensor([abc], device="cuda",
                                        dtype=torch.int64))[0].tolist()
    if got[:4] != [1149247174, 988940175, 1305207541, 208049065] or \
            got != poseidon2_sponge(abc):
        raise AssertionError("sponge KAT failed")
    log("poseidon2 KATs: exact")


def phase_goldens() -> None:
    import numpy as np

    from zkir_tpu_torch.convert import proof_to_json
    from zkir_tpu_torch.prover import FriConfig, prove_trace

    for name in ("a", "b"):
        want = json.loads((FIXTURES / f"golden_{name}.proof.json")
                          .read_text())
        with np.load(FIXTURES / f"golden_{name}.matrix.npz") as z:
            matrix = z["matrix"]
        t0 = time.perf_counter()
        proof = prove_trace(matrix, FriConfig(**want["fri"]["config"]),
                            device="cuda")
        dt = time.perf_counter() - t0
        if json.loads(proof_to_json(proof)) != want:
            raise AssertionError(f"golden {name}: proof differs from the "
                                 "reference proof")
        log(f"golden {name}: proof equal to the reference "
            f"({matrix.shape[0]} rows, {dt:.3f} s)")


def phase_full(launch_counts) -> dict:
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.convert import trace_from_reference
    from zkir_tpu_torch.prover import (FriConfig, prove_trace,
                                       trace_to_matrix, verify_trace)

    trace = trace_from_reference(FIXTURES / "trace_exact_2e16.npz")
    matrix = trace_to_matrix(trace)
    if matrix.shape != (1 << 16, 493):
        raise AssertionError(f"trace matrix shape {matrix.shape}")
    log(f"trace matrix {matrix.shape}")

    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    proof = prove_trace(matrix, FriConfig(), device="cuda")
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launch_counts.update(_kernels.launches)
    log(f"launches in the first 2^16 prove: {launch_counts}")
    missing = [k for k, v in launch_counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the prove: {missing}")

    torch.cuda.reset_peak_memory_stats()
    os.environ["ZKIR_PROVE_LOG"] = "1"     # stage times on stderr
    t0 = time.perf_counter()
    warm = prove_trace(matrix, FriConfig(), device="cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    del os.environ["ZKIR_PROVE_LOG"]
    peak = torch.cuda.max_memory_allocated()
    if warm != proof:
        raise AssertionError("cold and warm proofs differ")

    t0 = time.perf_counter()
    ok = verify_trace(proof)
    verify_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the port's verifier rejects the 2^16 proof")
    rows = matrix.shape[0]
    stats = {"rows": rows, "prove_first_s": first_s, "prove_warm_s": warm_s,
             "rows_per_s_warm": rows / warm_s, "verify_s": verify_s,
             "peak_bytes": peak}
    log(f"2^16 prove: first {first_s:.3f} s, warm {warm_s:.3f} s "
        f"({rows / warm_s:.1f} rows/s), verify {verify_s:.3f} s (True), "
        f"peak device memory {peak / 2**30:.3f} GiB")
    return stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    from zkir_tpu_torch import _kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _kernels.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({_kernels.library_path().name})")

    results = {}
    phase_kernels(results)
    phase_goldens()
    launch_counts = {}
    stats = phase_full(launch_counts)

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launch_counts[name],
                **results[name]}
               for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"prove_2e16": stats, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
