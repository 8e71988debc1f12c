#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``zkir_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
(``python3 chip_smoke.py --quotient`` runs only phase 2's quotient build
and the quotient's comparisons on goldens C and E and the 2^16 main
path; ``python3 chip_smoke.py --crypto`` only the kernels' build and the
``crypto`` phase after phase 5; ``python3 chip_smoke.py --mesh`` only the
kernels' build, the ``mesh`` phase after it, the quotient's plans, the
2^16 main path's matrix and proof, and the ``mesh prove`` phase after
phase 8; ``python3 chip_smoke.py --sums`` only the kernels' build and the
LogUp partial sums' two kernels of phase 3):

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from ``zkir_tpu_torch/csrc`` (nvcc, sm_90a),
   then generate and build the quotient's kernels for its five plans
   (three feature sets on the whole LDE domain, the two of the streaming
   prover on one coset at log_blowup 0) from an empty build directory
   (the cold compile), and load them
   once more in a fresh process (the warm load); print each part's
   stages, global column reads a point, shared memory, registers,
   spills and SASS instructions, and each quotient helper's instructions
   (the quotient's operation bound);
3. hold each kernel entry point against its plain torch version on the
   card, for exact equality, at the main path's shapes (timed with CUDA
   events, beside the least time the card could take) and at a few more
   (strided, broadcast and immediate operands; short, real and coset
   transforms of one, two and three passes; ``cm31_ntt`` also timed at the
   streaming prover's block pairs [64, 2^16] and [64, 2^20], the partial
   sums' LDE [238, 2^16] -> 2^18, one 2^24 column and rows 2^17 words
   apart, each beside the replaced design's recorded time where there is
   one and a bound whose
   operations come from this build's SASS), plus the pinned Poseidon2
   known-answer vectors; ``p2_merkle_tree`` (a whole tree in one launch)
   against ``build_tree_plain`` and the per-level loop at every tree shape
   of the main path (2^18 .. 2^6 leaves) and at 2 and 4 leaves, timed
   against the loop beside its bound and its latency floor (levels times
   a narrow level's latency in the kernel's own chain); the LogUp partial
   sums' ``qm31_inv_scaled`` at every partial-sum function's 2^16 shape
   and ``m31_exclusive_scan`` at their row counts and at rows of
   2^20 and 2^22 words, with the edge words, each call one launch and no
   K1 launch, timed beside the bound (the inversion's SASS instructions)
   and, for the scan, ``torch.cumsum`` over the same rows;
4. prove the small golden traces A-E on the card (A, B without
   ``range_lookup``; C with it; D and E program-bound, with an I/O tape
   and a SHA-256 syscall) and require proofs equal (after a JSON round
   trip) to the stored reference proofs, and the port's verifier to
   accept them; golden E with a changed digest byte must be refused at
   prove time with the violated terms named; hold the generated quotient
   kernels against the plain ``VecAlg`` path on golden C's and E's
   quotient inputs (as in phases 6 and 7 on the 2^16 ones);
5. hold the interpreter kernel against its plain version on the card:
   ``interp_chunk`` (``interp_run`` over one chunk) chunk by chunk, exact
   on the whole state and on the
   valid trace rows, and ``TpuInterpreter.run`` (``interp_run``, the
   whole run in segments) against the reference's host loop over the
   plain chunk (result and trace dicts word for word, invalid rows 0):
   the 64 seeded fuzz programs on two lanes each, a memory, I/O and
   Poseidon2-syscall program on 1,024 lanes with a tape per lane (its
   syscalls one ``p2_sponge_bytes`` launch, no ``p2_permute``), a program whose lanes pause on
   Poseidon2 syscalls at different chunks and run ahead of each other
   (4 lanes, a warp each; 2,048, a thread each), the same with a
   ``max_cycles`` that is not a multiple of the chunk,
   and golden E's program (SHA-256 pause and resume, its matrix equal to
   the stored one), and SHA-256 of no input bytes from a pointer outside
   both windows (halt 1, output 3820012610, as the reference); the
   proof-of-work search against its plain version;
   one lane's clocks per cycle by phase (``tools/interp_bench.py``); the
   interpreter's cycles per second on the reference benchmark's loop
   program at 65,536 and 8,192 lanes, and both layouts (a thread or a
   warp per lane) from 1 to 65,536 lanes, and with a trace from 1 to
   1,024 (the wrapper's pick must be the faster); then the ``crypto``
   phase (``phase_crypto``, at most 90 s): the hash kernels
   (``sha256_blocks``, ``p2_sponge_bytes``, ``keccak_absorb``,
   ``b3_rows``, ``b3_compress``) against their plain versions, exact and
   timed beside their bounds, and against known answers;
   ``crypto_lanes_program`` on 65,536 lanes at the reference benchmark's
   interpreter shape, every lane's outputs equal to a host recomputation
   and 8 lanes to the oracle VM, each service round's seconds and
   launches (exactly one launch of each of the four hash kernels a round,
   no ``p2_permute`` and no ``b3_compress``); then the ``mesh`` phase (``phase_mesh``,
   at most 90 s): ``zkir_tpu_torch.parallel``'s distributed entry points
   on a world of one NCCL rank at full width (a 2^24 NTT, the main
   path's LDE and committed rows, the reference benchmark's interpreter
   shape in ``prove_step_sharded``), word for word against the
   single-device kernels, launches counted, timed beside them and the
   bound, with each kernel's device time by ``torch.profiler`` for the
   NTT and the step; then 4 gloo ranks that share ``cuda:0`` at smaller
   shapes, exact;
6. prove the 2^16-row benchmark trace (493 columns, production
   ``FriConfig()``) without ``range_lookup`` once, and verify it;
7. the main path at full width: ``exact_trace_program(16)`` interpreted
   on the card in one ``interp_run`` launch (its trace must equal the
   stored reference trace on valid rows), the matrix proved with ``range_lookup=True`` and its program
   bound (596 committed trace columns, 119 QM31 partial-sum columns, 838
   batched terms), cold and warm; the two proofs must be equal, the
   port's verifier must accept them with the program, the interpreter's
   and every prover kernel must have been launched (the warm prove's
   launches printed, and its partial-sum stage's by kernel: seven
   ``qm31_inv_scaled`` and six ``m31_exclusive_scan``), every tree of every
   prove (cold and warm, also without ``range_lookup``) must be one
   ``p2_merkle_tree`` launch with no ``p2_compress_level``, and the NTT
   family must launch nothing but ``cm31_ntt``; no prove may compile a
   quotient kernel (one build serves every proof of a feature set);
8. the streaming prover: ``p2_sponge_absorb`` against its plain version
   at [2^18, 128 words] from zero and non-zero states, with and without
   the padding block, and at odd widths (timed beside its bound); goldens
   C and E proved by ``prove_trace_streaming`` on the card, equal to the
   stored proofs and verified; the 2^16 main path's matrix proved by
   streaming (blocks of 64 columns), equal to phase 7's one-shot proof
   and verified, with no quotient compile, one ``p2_merkle_tree`` launch
   a tree, no kernel outside the prover's (the NTT family only
   ``cm31_ntt``) and no plain version run on a card tensor; the quotient
   on one coset (log_blowup 0) against the plain version on golden E's
   and the 2^16 main path's inputs; then ``exact_trace_program(20)``
   interpreted on the card, proved by streaming with its program bound
   and verified (peak device memory, seconds, rows per second); then the
   ``mesh prove`` phase (``phase_mesh_prove``, at most 150 s): the 2^16
   main path proved one-shot and by streaming on a world of one NCCL
   rank (``prove_trace(mesh=)``, ``prove_trace_streaming(mesh=)``), each
   proof equal to the single-device proof, each warm prove's launches by
   kernel equal to one device's, no plain version on a card tensor, warm
   seconds in turns with one device's and the peak device memory; 4 gloo
   ranks sharing ``cuda:0`` proving goldens B and E one-shot and C by
   streaming (blocks of 6 columns) to the reference proofs; ``prove
   --bind --mesh 1`` in a fresh process writing golden D, and ``warm
   --log-rows 12 --streaming --cache-dir`` an empty directory building
   the quotient parts that a later ``prove --streaming`` there loads
   without a build;
9. the deferred-carry model (``InterpConfig(deferred=True)``, the
   kernel's deferred build): the interpreter kernel against its plain
   version as in phase 5 on the 64 fuzz programs (two lanes) and on a
   program of the model's corners (2 lanes, a warp each; 2,048, a thread
   each; two lanes also against the port's oracle VM); the one-lane
   ``exact_trace_program(15)`` runs, deferred and plain, against the
   oracle VM row by row (pre-state registers, bounds and accumulated
   registers, normalization witnesses against ``norm_*``; the plain run
   at 2^14), with the oracle's cycles per second on the host; the
   deferred 2^16 trace
   interpreted and proved with its program bound (launch counts from 0),
   its matrix and proof equal to phase 7's and verified; the 2^16 launch
   of both builds timed in turns beside each build's bound;
10. the CLI as a user runs it, in subprocesses of ``python3 -m
   zkir_tpu_torch`` in a temporary directory: ``asm``, ``run`` with the
   three engines (native: the reference's line and exit code at a cycle
   limit; oracle: the reference's line, with and without a limit; gpu),
   ``prove``
   with and without ``--bind`` (proofs JSON-equal to goldens D and A),
   ``prove --streaming --bind`` (golden D again) and ``--streaming
   --checkpoint-dir`` (refused), ``verify`` (accepting, and refusing
   another program), and ``prove --checkpoint-dir`` resumed after its
   last stage's file was deleted.

The line before the last is a JSON object with one entry per kernel
entry point (launches on the path that owns it: the interpret-and-prove
run of phase 7, for the hash kernels the crypto phase's 65,536-lane
run, for ``p2_sponge_absorb`` the 2^16 streaming prove of phase 8, and 0
for ``p2_compress_level``, ``p2_permute`` and ``b3_compress``, which no
path launches any more; beside them the
launches of the other paths, the deferred one of phase 9, the mesh
phase's and the sharded proves' included, and
for ``interp_run`` both builds' 2^16 launch and bound; max
|kernel - plain|, kernel and plain milliseconds, the bound and what sets
it); the line before it holds the timings, stage times and the further
timed cases; the last line is ``{"ok": true, "device": {...}}``.  The
script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
P = (1 << 31) - 1
SEED = 20261016

# The card's published peaks (NVIDIA H100 SXM data sheet and the Hopper
# architecture white paper): device memory rate, and the INT32 rate outside
# the tensor cores, which is also the rate at which the SMs start
# instructions (132 SMs x 4 schedulers x 32 lanes x 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 33.5e12
# Instructions one thread executes for one Poseidon2 permutation in the
# built kernel: zkir_tpu_torch/tools/sass_count.py on permute_kernel's SASS
# (1,760 static instructions; round loops of 4, 14 and 4 trips).
P2_INSTR_PER_PERMUTATION = 8077

# C entry point -> (source, the TPU kernel it replaces).
KERNELS = {
    "m31_binary": ("zkir_tpu_torch/csrc/m31_binary.cu",
                   "zkir_tpu/ops/field_ops.py:190"),
    "cm31_binary": ("zkir_tpu_torch/csrc/m31_binary.cu",
                    "zkir_tpu/ops/field_ops.py:190"),
    "cm31_ntt": ("zkir_tpu_torch/csrc/ntt.cu",
                 "zkir_tpu/ops/field_ops.py:190"),
    "p2_permute": ("zkir_tpu_torch/csrc/poseidon2.cu",
                   "zkir_tpu/ops/poseidon2.py:261"),
    "p2_sponge_rows": ("zkir_tpu_torch/csrc/poseidon2.cu",
                       "zkir_tpu/ops/poseidon2.py:261"),
    "p2_sponge_absorb": ("zkir_tpu_torch/csrc/poseidon2.cu",
                         "zkir_tpu/ops/poseidon2.py:261"),
    "p2_compress_level": ("zkir_tpu_torch/csrc/poseidon2.cu",
                          "zkir_tpu/ops/poseidon2.py:261"),
    "p2_merkle_tree": ("zkir_tpu_torch/csrc/poseidon2.cu",
                       "zkir_tpu/ops/poseidon2.py:261"),
    "p2_grind": ("zkir_tpu_torch/csrc/poseidon2.cu",
                 "zkir_tpu/ops/poseidon2.py:261"),
    # The reference services its Poseidon2 syscalls on the host, a
    # permutation at a time: the Pallas kernel's function.
    "p2_sponge_bytes": ("zkir_tpu_torch/csrc/poseidon2.cu",
                        "zkir_tpu/ops/poseidon2.py:261"),
    # The jitted lax.scan of the reference interpreter (XLA, not Pallas),
    # and the reference's host loop of chunks around it.
    "interp_run": ("zkir_tpu_torch/csrc/interp.cu",
                   "zkir_tpu/interp/columnar.py:1083"),
    # The reference's jitted quotient (XLA, not Pallas): generated parts
    # over csrc/quotient.cuh.
    "quotient_part": ("zkir_tpu_torch/prover/quotient_codegen.py",
                      "zkir_tpu/prover/constraints.py:2683"),
    # The reference's jitted batch hashes (XLA, not Pallas).
    "sha256_blocks": ("zkir_tpu_torch/csrc/crypto.cu",
                      "zkir_tpu/ops/sha256.py:32"),
    "keccak_absorb": ("zkir_tpu_torch/csrc/crypto.cu",
                      "zkir_tpu/ops/keccak.py:30"),
    "b3_rows": ("zkir_tpu_torch/csrc/crypto.cu",
                "zkir_tpu/ops/blake3.py:107"),
    "b3_compress": ("zkir_tpu_torch/csrc/crypto.cu",
                    "zkir_tpu/ops/blake3.py:61"),
    # The LogUp partial sums' jitted functions (XLA, not Pallas): their QM31
    # batch inversion (qm31_batch_inv over _batch_inv_chain) and their
    # exclusive prefix sums (_exclusive_cumsum4).
    "qm31_inv_scaled": ("zkir_tpu_torch/csrc/qm31.cu",
                        "zkir_tpu/ops/qm31.py:142"),
    "m31_exclusive_scan": ("zkir_tpu_torch/csrc/qm31.cu",
                           "zkir_tpu/prover/prover.py:347"),
}
# The hash kernels serve the interpreter's crypto syscalls, each one launch
# a service round; no prove launches them.
CRYPTO_KERNELS = ("sha256_blocks", "p2_sponge_bytes", "keccak_absorb",
                  "b3_rows")
# Kernels of public entry points that no path launches any more:
# p2_compress_level (one tree level; p2_merkle_tree builds a tree in one
# launch), p2_permute (poseidon2_permute_batch) and b3_compress
# (b3_compress_batch) since the service's Poseidon2 and BLAKE3 are one
# launch of p2_sponge_bytes and of b3_rows.
PATHLESS = ("p2_compress_level", "p2_permute", "b3_compress")
# The quotient's plans: a feature set (lookup, aux, memory, io, crypto,
# program) at a log_blowup.  The one-shot prover evaluates the quotient on
# the whole LDE domain (FriConfig()'s log_blowup 2, every golden's); the
# streaming prover on one interleaved coset at a time, at log_blowup 0
# (the next row one point on), always with range_lookup.
QUOTIENT_PLANS = {
    "main path": ((True,) * 6, 2),
    "range_lookup, no program": ((True,) * 5 + (False,), 2),
    "range_lookup=False": ((False,) * 6, 2),
    "main path, one coset": ((True,) * 6, 0),
    "range_lookup, no program, one coset": ((True,) * 5 + (False,), 0)}
# The kernels the interpret-and-prove path must launch; the hash kernels
# belong to the interpreter's crypto syscalls and p2_sponge_absorb to the
# streaming prover.
MAIN_PATH_KERNELS = [k for k in KERNELS if k not in (
    "p2_sponge_absorb", *CRYPTO_KERNELS, *PATHLESS)]
PROVER_KERNELS = [k for k in MAIN_PATH_KERNELS if k != "interp_run"]
# The kernels a streaming prove must launch.
STREAMING_KERNELS = PROVER_KERNELS + ["p2_sponge_absorb"]
# The LogUp partial sums' kernels: a prove without range_lookup has none.
SUMS_KERNELS = ("qm31_inv_scaled", "m31_exclusive_scan")
# Instructions every cycle executes in the interpreter kernel, whatever its
# opcode: a floor, zkir_tpu_torch/tools/sass_count.py --floor on the
# older kernel, a thread per lane decoding each word every cycle (1,784
# static instructions, 1,390 in the cycle loop).  The bound takes the
# built kernel's own floor where it is lower (interp_floor), never a
# higher one.
INTERP_INSTR_PER_CYCLE = 140
SM_CLOCK_HZ = 1.98e9


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


def max_abs_err(name, got, want) -> int:
    """max |got - want| over one tensor or a tuple of them; 0 required."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((g - w).abs().max().item()))
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version, max |diff| = {err}")
    return err


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the field's integer
    operations at the integer rate, whichever is longer."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def interp_bound(n_bytes: float, cycles: int, lanes: int,
                 instr: int = INTERP_INSTR_PER_CYCLE) -> dict:
    """The interpreter kernel's bound: bytes as in ``bound``; its
    instructions (``instr`` a cycle, a floor) at the card's instruction rate,
    or, where the lanes are too few to reach that, at one instruction a
    clock for each lane (a lane is one sequential machine)."""
    n_ops = instr * cycles * lanes
    rate = min(INT_OPS_PER_S, lanes * SM_CLOCK_HZ)
    return bound(n_bytes, n_ops * INT_OPS_PER_S / rate)


def compare(name, kernel_fn, plain_fn, iters, results, *, n_bytes=0, n_ops=0,
            plain_iters=None, key=None, bounds=None):
    """Run the kernel's wrapper and its plain version on the same card
    tensors; require equal words; time both.  The bound is ``bounds`` or
    ``bound(n_bytes, n_ops)``.  No one PyTorch call computes any of these
    functions, so ``library_ms`` is null."""
    import torch

    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    err = max_abs_err(name, got, want)
    shape = tuple((got[0] if isinstance(got, tuple) else got).shape)
    del got, want
    ms = cuda_ms(kernel_fn, iters)
    plain_ms = cuda_ms(plain_fn, plain_iters or iters)
    results[key or name] = {"max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms,
                            **(bounds or bound(n_bytes, n_ops)),
                            "library_ms": None}
    r = results[key or name]
    log(f"{key or name}: exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({shape})")


def equal(name, got, want) -> None:
    import torch

    torch.cuda.synchronize()
    max_abs_err(name, got, want)
    log(f"{name}: exact")


def phase_binary_layouts(results, gen) -> None:
    """K1's two entry points on broadcast, strided and immediate operands
    (nothing is expanded or copied before a launch), timed at the main
    path's CM31 shapes."""
    import torch

    from zkir_tpu_torch.ops import field_ops as f

    edge = torch.tensor([0, 1, P - 1], device="cuda", dtype=torch.int64)
    plain = {"add": f.add_plain, "sub": f.sub_plain, "mul": f.mul_plain}
    cplain = {"add": f.cm31_add_plain, "sub": f.cm31_sub_plain,
              "mul": f.cm31_mul_plain}
    m = words(gen, (37, 1024))
    col = words(gen, (37, 1))
    for op in ("add", "sub", "mul"):
        fn = getattr(f, f"m31_{op}")
        equal(f"m31_binary {op} broadcast [37,1024]x[37,1]",
              fn(m, col), plain[op](m, col))
        equal(f"m31_binary {op} scalar", fn(m, P - 2), plain[op](m, P - 2))
        equal(f"m31_binary {op} scalar first",
              fn(12345, m), plain[op](12345, m))

    # CM31: every edge word against every other in all four coordinates.
    e4 = torch.cartesian_prod(edge, edge, edge, edge)
    a = (torch.cat([e4[:, 0], words(gen, (1 << 18,))[:-81]]),
         torch.cat([e4[:, 1], words(gen, (1 << 18,))[:-81]]))
    b = (torch.cat([e4[:, 2], words(gen, (1 << 18,))[:-81]]),
         torch.cat([e4[:, 3], words(gen, (1 << 18,))[:-81]]))
    sq = (words(gen, (512, 512)), words(gen, (512, 512)))
    wide = (words(gen, (64, 4096)), words(gen, (64, 4096)))
    for op in ("add", "sub", "mul"):
        for what, x, y in (
                ("edge words, [2^18]", a, b),
                ("constant pair", a, (P - 1, 12345)),
                ("constant pair first", (7, 0), b),
                ("transposed", (sq[0].T, sq[1].T), sq),
                ("strided slice", (wide[0][:, ::8], wide[1][:, 1::8]),
                 (sq[0][:64], sq[1][:64])),
                ("odd offset", (a[0][1:], a[1][1:]), (b[0][:-1], b[1][1:])),
                ("rank 4", (wide[0].reshape(4, 16, 64, 64)[:, :15, ::2, ::2],
                            wide[1].reshape(4, 16, 64, 64)[:, 1:, 1::2, ::2]),
                 (sq[0][:32, :32], sq[1][:32, :32]))):
            equal(f"cm31_binary {op}, {what}",
                  f.cm31_binary(x, y, op), cplain[op](x, y))
    try:
        t5 = wide[0].reshape(4, 4, 4, 64, 64)[::2, ::2, ::2, ::2, ::2]
        f.m31_add(t5, t5.transpose(0, 1))
    except ValueError as exc:
        log(f"m31_binary refuses a rank-5 layout: {str(exc)[:60]}...")
    else:
        raise AssertionError("a rank-5 layout was not refused")
    n = a[0].numel()
    compare("cm31_binary", lambda: f.cm31_binary(a, b, "mul"),
            lambda: f.cm31_mul_plain(a, b), 50, results,
            n_bytes=48 * n, n_ops=6 * n, key="cm31_binary [2^18]")
    del a, b, sq, wide
    # The combine's contraction: [C, 2^18] columns times a [C, 1] column
    # of powers, at the full constraint set's trace block (596 columns)
    # and at the range_lookup=False batch (493 + 4).
    for c, key in ((596, None), (497, "cm31_binary [497, 2^18]")):
        x = (words(gen, (c, 1 << 18)), words(gen, (c, 1 << 18)))
        pw = (words(gen, (c, 1)), words(gen, (c, 1)))
        n = x[0].numel()
        compare("cm31_binary", lambda: f.cm31_binary(x, pw, "mul"),
                lambda: f.cm31_mul_plain(x, pw), 5, results,
                n_bytes=32 * n + 16 * c, n_ops=6 * n, key=key)
        del x, pw


# cm31_ntt's times as PERF.md section 6 recorded them for the design this
# kernel replaced (H100 80GB HBM3, 700.00 W), by the keys of phase_ntt's
# rows.  That kernel is no longer in the tree; tools/ntt_bench.py times it
# beside this one on one card.
NTT_PREVIOUS_MS = {"cm31_ntt": 4.7279,
                   "cm31_ntt inverse [596, 2^16]": 1.1631,
                   "lde [596, 2^16] -> 2^18 (2 x cm31_ntt)": 5.7871}


def ntt_ops(ins, batch, log_n, first=0, products=0):
    """Instructions a transform needs by the built kernel's SASS (``ins``:
    ``tools/sass_count.py ntt_instructions``): every butterfly of stages
    ``first`` .. log_n - 1 its sum and difference, and the fewest CM31
    products over the splits of those stages into the kernel's register
    steps of 1-3 stages; plus ``products`` CM31 products a row (``pre``,
    ``post``).  A step of 2^r points whose lowest stage is g multiplies
    points 1 .. 2^r - 1 of each group by a factor, 1 in the 2^-g of the
    groups whose position bits below g are 0, and an 8-point step's DFT
    adds two products (w^(n/8), w^(3n/8)); +-i is a swap."""
    n = 1 << log_n

    def step(g, r):
        groups = n >> r
        return (((1 << r) - 1) * (groups - (groups >> g))
                + (2 * groups if r == 3 else 0))

    fewest = [0] * (log_n + 1)     # fewest[g]: stages g .. log_n - 1
    for g in range(log_n - 1, first - 1, -1):
        fewest[g] = min(step(g, r) + fewest[g + r]
                        for r in (1, 2, 3) if g + r <= log_n)
    return batch * (ins["sum_difference"] * (n >> 1) * (log_n - first)
                    + ins["cmul"] * (fewest[first] + products))


def phase_ntt(results, gen) -> None:
    """``cm31_ntt`` against the plain torch network: the prover's shapes,
    the streaming prover's blocks, the reference benchmark's 2^24 column
    and rows of a wider matrix timed beside the replaced design's times
    and the bound (bytes, or the butterflies' instructions counted from
    this build's SASS); then one-, two- and three-pass sizes, short and
    real inputs and the coset edges for equality."""
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.ops import ntt
    from zkir_tpu_torch.prover.prover import _coset_shift
    from zkir_tpu_torch.prover.streaming import _eval_block
    from zkir_tpu_torch.spec.field import m31_inv
    from zkir_tpu_torch.tools.sass_count import ntt_instructions

    shift = _coset_shift()
    ins = ntt_instructions(_kernels._nvcc(), _kernels.CSRC,
                           _kernels.BUILD / "sass_probe")
    log(f"cm31_ntt SASS: {ins['cmul']:g} instructions a product, "
        f"{ins['sum_difference']:g} a butterfly's sum and difference")
    results["ntt_instructions"] = ins

    def intt_plain(re, log_n):
        return ntt.ntt_plain(re, None, log_n, True, scale=m31_inv(1 << log_n))

    def lde_plain(re, log_n, log_blowup):
        c = intt_plain(re, log_n)
        return ntt.ntt_plain(c[0], c[1], log_n + log_blowup, False, pre=shift)

    def row(key, kernel_fn, plain_fn, n_bytes, n_ops, iters=5):
        compare("cm31_ntt", kernel_fn, plain_fn, iters, results,
                plain_iters=1, n_bytes=n_bytes, n_ops=n_ops, key=key)
        r = results[key]
        r["previous_ms"] = NTT_PREVIOUS_MS.get(key)
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        log(f"  {key}: {100 * r['share_of_bound']:.1f}% of the bound; "
            f"the replaced design: {r['previous_ms'] or 'not measured'} ms")

    # The trace block of the full constraint set (596 columns), the
    # range_lookup=False one (493), and the partial sums' (238 CM31
    # columns, real and imaginary parts: lde of real and of complex input
    # is the same launch pair; the prover's is real).
    for c in (596, 493, 238):
        n, big = 1 << 16, 1 << 18
        cols = words(gen, (c, n))
        row(f"lde [{c}, 2^16] -> 2^18 (2 x cm31_ntt)",
            lambda: ntt.lde(cols, None, 16, 2, shift=shift),
            lambda: lde_plain(cols, 16, 2), 8 * c * (n + 2 * big),
            ntt_ops(ins, c, 16) + ntt_ops(ins, c, 18, first=2,
                                          products=n))
        if c == 238:
            continue
        row(f"cm31_ntt inverse [{c}, 2^16]", lambda: ntt.intt(cols, None, 16),
            lambda: intt_plain(cols, 16), 8 * 3 * c * n, ntt_ops(ins, c, 16))
        del cols
        x = (words(gen, (c, big)), words(gen, (c, big)))
        row("cm31_ntt" if c == 596 else "cm31_ntt [493, 2^18]",
            lambda: ntt.ntt(x[0], x[1], 18),
            lambda: ntt.ntt_plain(x[0], x[1], 18, False), 8 * 4 * c * big,
            ntt_ops(ins, c, 18))
        del x
        torch.cuda.empty_cache()

    # The streaming prover's block of 64 columns on one coset (intt, then
    # coset_ntt into rows of a buffer), at 2^16 and 2^20.
    for log_n in (16, 20):
        n = 1 << log_n
        vals = words(gen, (64, n))
        out = (torch.empty_like(vals), torch.empty_like(vals))
        row(f"block intt + coset_ntt [64, 2^{log_n}]",
            lambda: _eval_block(vals, None, log_n, shift, out=out),
            lambda: ntt.ntt_plain(*intt_plain(vals, log_n), log_n, False,
                                  pre=shift),
            8 * 3 * 64 * n,
            ntt_ops(ins, 64, log_n) + ntt_ops(ins, 64, log_n, products=n),
            iters=3 if log_n == 20 else 5)
        del vals, out
        torch.cuda.empty_cache()
    # The quotient's column (prover.py: coset_intt of [2^18], batch 1, so
    # the plan narrows its tiles) and one of its chunks (coset_ntt of a
    # 2^16-word slice into 2^18).
    q = (words(gen, (1 << 18,)), words(gen, (1 << 18,)))
    row("coset_intt [1, 2^18]",
        lambda: ntt.coset_intt(q[0], q[1], 18, shift=shift),
        lambda: ntt.ntt_plain(q[0], q[1], 18, True,
                              post=ntt.cm31_inv_scalar(shift),
                              scale=m31_inv(1 << 18)),
        8 * 4 * (1 << 18), ntt_ops(ins, 1, 18, products=1 << 18))
    chunk = (q[0][1 << 16:2 << 16], q[1][1 << 16:2 << 16])
    row("coset_ntt [1, 2^16 slice] -> 2^18",
        lambda: ntt.coset_ntt(chunk[0], chunk[1], 18, shift=shift),
        lambda: ntt.ntt_plain(chunk[0], chunk[1], 18, False, pre=shift),
        8 * 2 * ((1 << 16) + (1 << 18)),
        ntt_ops(ins, 1, 18, first=2, products=1 << 16))
    del q, chunk
    # The reference benchmark's NTT: one CM31 column of 2^24, forward.
    col = (words(gen, (1, 1 << 24)), words(gen, (1, 1 << 24)))
    row("cm31_ntt [1, 2^24]", lambda: ntt.ntt(col[0], col[1], 24),
        lambda: ntt.ntt_plain(col[0], col[1], 24, False),
        8 * 4 * (1 << 24), ntt_ops(ins, 1, 24))
    del col
    # Rows of a wider matrix: row stride 2^17 words for rows of 2^16.
    wide = words(gen, (64, 1 << 17))
    rows_ = (wide[:, :1 << 16], wide[:, 1 << 16:])
    row("cm31_ntt [64, 2^16], row stride 2^17",
        lambda: ntt.ntt(rows_[0], rows_[1], 16),
        lambda: ntt.ntt_plain(rows_[0].contiguous(), rows_[1].contiguous(),
                              16, False), 8 * 4 * 64 * (1 << 16),
        ntt_ops(ins, 64, 16))
    del wide, rows_
    torch.cuda.empty_cache()

    for log_n, batch in ((1, 1), (2, 3), (5, 1), (5, 3), (10, 3), (12, 1),
                         (13, 1), (13, 3), (16, 3), (19, 1)):
        n = 1 << log_n
        re, im = words(gen, (batch, n)), words(gen, (batch, n))
        for inverse in (False, True):
            equal(f"cm31_ntt 2^{log_n} x {batch} inverse={inverse}",
                  ntt.cm31_ntt(re, im, log_n, inverse),
                  ntt.ntt_plain(re, im, log_n, inverse))
        short = re[:, :max(n // 4, 1)]
        equal(f"cm31_ntt 2^{log_n} x {batch} short real input, pre, scale",
              ntt.cm31_ntt(short, None, log_n, False, pre=shift, scale=3),
              ntt.ntt_plain(short, None, log_n, False, pre=shift, scale=3))
        equal(f"lde 2^{log_n} x {batch} -> 2^{log_n + 2}",
              ntt.lde(re, None, log_n, 2, shift=shift),
              lde_plain(re, log_n, 2))
    re, im = words(gen, (2, 1 << 18)), words(gen, (2, 1 << 18))
    for name in ("coset_ntt", "coset_intt"):
        plain = {"coset_ntt": lambda: ntt.ntt_plain(re, im, 18, False,
                                                    pre=shift),
                 "coset_intt": lambda: ntt.ntt_plain(
                     re, im, 18, True, post=ntt.cm31_inv_scalar(shift),
                     scale=m31_inv(1 << 18))}[name]
        equal(f"{name} [2, 2^18]",
              getattr(ntt, name)(re, im, 18, shift=shift), plain())
    one = re[0, :1 << 16]       # a 1-D slice, as the quotient's chunks are
    equal("coset_ntt of a 2^16 slice into 2^18",
          ntt.coset_ntt(one, im[0, :1 << 16], 18, shift=shift),
          ntt.ntt_plain(one, im[0, :1 << 16], 18, False, pre=shift))


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
        equal(f"m31_binary {op}", getattr(f, f"m31_{op}")(a, b), plain(a, b))
    n = a.numel()
    compare("m31_binary", lambda: f.m31_mul(a, b),
            lambda: f.mul_plain(a, b), 20, results,
            n_bytes=24 * n, n_ops=n)
    del a, b
    phase_binary_layouts(results, gen)
    phase_ntt(results, gen)
    phase_sums(results, gen)

    # K2 at the main path's shapes: a grinding batch, the row sponges of
    # the trace commit (2^18 rows of 2 x 596 words), the partial-sum commit
    # (4 x 119) and the range_lookup=False trace commit (2 x 493), the
    # first tree level.
    states = words(gen, (1 << 16, 16))
    # K2's operations: one permutation per state, per 8-word rate block
    # of a padded row (w words + the padding word -> w // 8 + 1), per
    # parent.
    perm = P2_INSTR_PER_PERMUTATION
    compare("p2_permute", lambda: p2.poseidon2_permute_batch(states),
            lambda: p2.permute_plain(states), 10, results,
            n_bytes=2 * 8 * states.numel(), n_ops=perm * states.shape[0])
    for w in (1192, 476, 986):
        rows = words(gen, (1 << 18, w))
        compare("p2_sponge_rows", lambda: merkle.hash_rows(rows),
                lambda: p2.sponge_rows_plain(rows), 2, results,
                n_bytes=8 * (rows.numel() + 8 * rows.shape[0]),
                n_ops=perm * rows.shape[0] * (w // 8 + 1),
                key=None if w == 1192 else f"p2_sponge_rows [2^18, {w}]")
        del rows
    leaves = words(gen, (1 << 18, 8))
    compare("p2_compress_level",
            lambda: p2.poseidon2_compress_level(leaves),
            lambda: p2.compress_level_plain(leaves), 10, results,
            n_bytes=8 * (leaves.numel() + leaves.numel() // 2),
            n_ops=perm * leaves.shape[0] // 2)
    del leaves
    phase_trees(results, gen)
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


def qm31_instructions() -> dict:
    """Instructions of one QM31 inversion in this build of
    ``csrc/qm31.cu`` (a SASS probe)."""
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.tools.sass_count import qm31_instructions as count

    out = count(_kernels._nvcc(), _kernels.CSRC, _kernels.BUILD / "probe")
    log(f"qm31.cu SASS: instructions an inversion {out}")
    return out


def qm31_edges(q4):
    """The front of a QM31 4-tuple of card tensors set to the edge words:
    QM31 zero, then 0, 1 and p - 1 in each coordinate in turn."""
    for c in q4:
        c[..., 0] = 0
    at = 1
    for k in range(4):
        for e in (0, 1, P - 1):
            q4[k][..., at] = e
            at += 1
    return q4


def phase_sums(results, gen) -> None:
    """The LogUp partial sums' two kernels against their plain versions on
    the card, word for word: ``qm31_inv_scaled`` at every partial-sum
    function's 2^16 shape (the channels' [92, 2^16] with the table's row
    for all and beta's coordinates 1-3 as immediates, aux [9, 2^16] with
    both sides, the crypto slots [11, 2^16] masked, the memory, I/O and
    program terms and the tape's [2^16]); ``m31_exclusive_scan`` at their
    row counts and at the streaming prover's 2^20 and 2^22 words a row, with
    rows of all p - 1; each one launch and no K1 launch; timed at the
    channels' shape beside its bound (bytes: the tensors passed read once,
    the output written once; operations: this build's SASS instructions of
    an inversion in a batch, and of one alone for the table's row once a
    column) and, for the scan, also at the streaming prover's [2^22] and
    [4, 2^22], each beside ``torch.cumsum`` over the same int64 rows."""
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.ops import qm31

    n = 1 << 16
    instr = qm31_instructions()

    def q4(shape):
        return qm31_edges(tuple(words(gen, shape) for _ in range(4)))

    def scale(shape):
        s = words(gen, shape)
        s[..., :3] = torch.tensor([0, 1, P - 1], device="cuda")
        return s

    def only(name, fn):
        """``fn()`` on the card is exactly one launch of ``name``."""
        torch.cuda.synchronize()
        _kernels.reset_launches()
        out = fn()
        launched = {k: v for k, v in _kernels.launches.items() if v}
        if launched != {name: 1}:
            raise AssertionError(f"{name}: the call launched {launched}")
        return out

    def launch_alone(name, call, iters, fix=None):
        """Milliseconds of ``name``'s launch alone (no wrapper) on the
        arguments its wrapper passes for ``call()``; ``fix(args)`` first
        (fresh buffers a launch uses up)."""
        real = _kernels.launch
        kept = []
        _kernels.launch = lambda k, *a: kept.append(a) or real(k, *a)
        try:
            out = call()
        finally:
            _kernels.launch = real
        args = list(kept[0])
        prepare = fix(args) if fix else (lambda: None)

        def once():
            prepare()
            real(name, *args)

        ms = cuda_ms(once, iters)
        del out
        return ms

    beta = [int(x) for x in words(gen, (4,)).tolist()]
    chan = (scale((92, n)),)                         # beta0 - witness
    table = (scale((1, n)),)                         # beta0 - t
    cases = {
        "channels [92, 2^16]": dict(
            x=(*chan, *beta[1:]), a=1, y=(*table, *beta[1:]),
            b=scale((92, n)), subtract=True),
        "aux [9, 2^16]": dict(x=q4((9, n)), a=1, y=q4((9, n)),
                              b=scale((9, n)), subtract=True),
        "crypto slots [11, 2^16]": dict(x=q4((11, n)), a=scale((11, n))),
        "memory [2^16]": dict(x=q4((n,)), a=scale((n,)), y=q4((n,)),
                              b=scale((n,)), subtract=True),
        "I/O [2^16]": dict(x=q4((n,)), a=scale((n,)), y=q4((n,)),
                           b=scale((n,))),
        "program [2^16]": dict(x=q4((n,)), a=1, y=q4((n,)), b=scale((n,)),
                               subtract=True),
        "crypto tape [2^16]": dict(x=q4((n,)), a=scale((n,))),
        "inverse only [2^16]": dict(x=q4((n,))),
    }
    for what, kw in cases.items():
        got = only("qm31_inv_scaled", lambda: qm31.qm31_inv_scaled(**kw))
        want = qm31.qm31_inv_scaled_plain(**kw)
        if what != "channels [92, 2^16]":
            equal(f"qm31_inv_scaled {what}", got, want)
            continue
        max_abs_err("qm31_inv_scaled", got, want)
        del got, want
        rows = 92
        # the witness, the table's row and the multiplicities; the three
        # immediates are no bytes
        passed = {id(t): t for t in (*kw["x"], kw["a"], *kw["y"], kw["b"])
                  if isinstance(t, torch.Tensor)}
        n_bytes = 8 * (sum(t.numel() for t in passed.values())
                       + 4 * rows * n)
        # the witness in batches, the table's row once a column alone
        ops = instr["qm31_inv_batch"] * rows * n + instr["qm31_inv"] * n
        compare("qm31_inv_scaled", lambda: qm31.qm31_inv_scaled(**kw),
                lambda: qm31.qm31_inv_scaled_plain(**kw), 20, results,
                plain_iters=2, n_bytes=n_bytes, n_ops=ops)
        r = results["qm31_inv_scaled"]
        r["launch_ms"] = launch_alone(
            "qm31_inv_scaled", lambda: qm31.qm31_inv_scaled(**kw), 20)
        log(f"qm31_inv_scaled: the launch alone {r['launch_ms']:.4f} ms, "
            f"{r['bound_ms'] / r['launch_ms']:.1%} of its bound")
        results["qm31_inv_scaled"].update(
            instructions_an_inversion=instr["qm31_inv"],
            instructions_an_inversion_in_a_batch=instr["qm31_inv_batch"],
            inversions=rows * n + n, bytes=n_bytes)
    # The stage's 2^16 inversions at once, for the record: 92 + 1 channel
    # rows, 18 aux, 11 slots, 2 x 3 memory/I/O/program, 1 tape.
    log(f"qm31_inv_scaled: {(93 + 18 + 11 + 6 + 1) * n:,} inversions in the "
        f"2^16 stage")

    def term(shape):
        t = tuple(words(gen, shape) for _ in range(4))
        t[1][...] = P - 1                            # rows of all p - 1
        front = t[2].view(-1)[:3]
        front[...] = torch.tensor([0, 1, P - 1], device="cuda")[:front.numel()]
        return t

    # the channels' shape (the kernels line) and the streaming prover's
    timed_at = {(92, n): "m31_exclusive_scan",
                (1 << 22,): "m31_exclusive_scan [2^22]",
                (4, 1 << 22): "m31_exclusive_scan [4, 2^22]"}
    for shape in ((92, n), (9, n), (n,), (1 << 20,), (1 << 22,),
                  (4, 1 << 22), (3, 1000), (5, 4097), (1,)):
        t = term(shape)
        got = only("m31_exclusive_scan", lambda: qm31.exclusive_cumsum4(t))
        want = qm31.exclusive_cumsum4_plain(t)
        key = timed_at.get(shape)
        if key is None:
            equal(f"m31_exclusive_scan {list(shape)}", got, want)
            continue
        max_abs_err(key, got, want)
        del got, want
        compare("m31_exclusive_scan", lambda: qm31.exclusive_cumsum4(t),
                lambda: qm31.exclusive_cumsum4_plain(t), 20, results,
                n_bytes=16 * 4 * t[0].numel(), key=key)
        def fresh(args):
            """Zero words for the tiles, zeroed before each launch (part
            of the scan's work)."""
            rows_, n_ = args[6], args[7]
            status = torch.zeros(4 * rows_ * -(-n_ // qm31.SCAN_TILE) + 1,
                                 dtype=torch.int64, device="cuda")
            args[5] = status.data_ptr()
            return status.zero_

        r = results[key]
        r["launch_ms"] = launch_alone(
            "m31_exclusive_scan", lambda: qm31.exclusive_cumsum4(t), 20,
            fresh)
        log(f"{key}: the launch alone (with its zero fill) "
            f"{r['launch_ms']:.4f} ms, {r['bound_ms'] / r['launch_ms']:.1%} "
            "of its bound")
        stacked = torch.stack(t)
        results[key]["library_ms"] = cuda_ms(
            lambda: torch.cumsum(stacked, dim=-1), 20)
        log(f"{key}: torch.cumsum over the same rows "
            f"{results[key]['library_ms']:.4f} ms")
        del stacked
    torch.cuda.empty_cache()


@contextlib.contextmanager
def sums_launches():
    """Launches by kernel inside each call of ``_sums_columns`` (the
    partial-sum stage, one-shot and streaming) in the block, in a list."""
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.prover import prover, streaming

    calls = []
    real = prover._sums_columns

    def spy(*args, **kwargs):
        before = dict(_kernels.launches)
        out = real(*args, **kwargs)
        calls.append({k: v - before.get(k, 0)
                      for k, v in _kernels.launches.items()
                      if v - before.get(k, 0)})
        return out

    prover._sums_columns = streaming._sums_columns = spy
    try:
        yield calls
    finally:
        prover._sums_columns = streaming._sums_columns = real


def phase_trees(results, gen) -> None:
    """``p2_merkle_tree`` against ``build_tree_plain`` word for word at
    every tree shape of the main path (2^18 .. 2^6 leaves) and at 2 and 4
    leaves, and against the per-level loop (``p2_compress_level``, a launch
    a level, the tree as the port built it before ``p2_merkle_tree``);
    both timed at 2^18, 2^17, 2^12, 2^6 and 2 leaves, the launch alone
    and with its wrapper, beside the bound and the latency floor: the
    levels times a narrow level's own latency (4 lanes a node, a
    permutation in the kernel's chain), the slope of the one-CTA trees
    from 2 to 2^6 leaves, so that a launch's own cost cancels."""
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.ops import merkle
    from zkir_tpu_torch.ops import poseidon2 as p2

    def per_level(leaves):
        levels = [leaves]
        while levels[-1].shape[0] > 1:
            levels.append(p2.poseidon2_compress_level(levels[-1]))
        return levels

    for log_n in (18, 17, 16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 2, 1):
        n = 1 << log_n
        leaves = words(gen, (n, 8))
        got = merkle.build_tree(leaves)
        for name, want in (("build_tree_plain", merkle.build_tree_plain),
                           ("the per-level loop", per_level)):
            want = want(leaves)
            if len(got) != len(want) or any(
                    not torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"p2_merkle_tree differs from {name} "
                                     f"at 2^{log_n} leaves")
        if log_n not in (18, 17, 12, 6, 1):
            log(f"p2_merkle_tree: exact at 2^{log_n} leaves")
            continue
        nodes = torch.empty((n - 1, 8), dtype=torch.int64, device="cuda")
        outs = [lv.clone() for lv in got[1:]]
        ins = [leaves] + outs[:-1]
        iters = 20 if log_n >= 17 else 100
        timed = {
            "launch_ms": cuda_ms(lambda: _kernels.launch(
                "p2_merkle_tree", leaves.data_ptr(), nodes.data_ptr(), n),
                iters),
            "ms": cuda_ms(lambda: merkle.build_tree(leaves), iters),
            "per_level_launches_ms": cuda_ms(lambda: [_kernels.launch(
                "p2_compress_level", a.data_ptr(), b.data_ptr(),
                b.shape[0]) for a, b in zip(ins, outs)], iters),
            "per_level_ms": cuda_ms(lambda: per_level(leaves), iters),
            "per_level_launches": log_n,
            "plain_ms": cuda_ms(lambda: merkle.build_tree_plain(leaves), 3),
            "levels": log_n, "max_abs_err": 0, "library_ms": None,
            # Leaves read once, every level written once; a permutation a
            # node.
            **bound(8 * 8 * (2 * n - 1), P2_INSTR_PER_PERMUTATION * (n - 1))}
        key = ("p2_merkle_tree" if log_n == 18
               else f"p2_merkle_tree [2^{log_n}]")
        results[key] = timed
        log(f"{key}: exact; launch alone {timed['launch_ms']:.4f} ms, with "
            f"its wrapper {timed['ms']:.4f} ms; the per-level loop "
            f"({log_n} launches) {timed['per_level_launches_ms']:.4f} ms "
            f"alone, {timed['per_level_ms']:.4f} ms with its wrappers; "
            f"plain {timed['plain_ms']:.4f} ms; bound "
            f"{timed['bound_ms']:.4f} ms by {timed['bound_by']}")
        del nodes, outs, ins
    lane_level = (results["p2_merkle_tree [2^6]"]["launch_ms"]
                  - results["p2_merkle_tree [2^1]"]["launch_ms"]) / 5
    results["p2_merkle_tree"]["narrow_level_ms"] = lane_level
    floors = {}
    for key, r in results.items():
        if key.startswith("p2_merkle_tree"):
            r["latency_floor_ms"] = floors[key] = r["levels"] * lane_level
    log(f"p2_merkle_tree: a narrow level (4 lanes a node) takes "
        f"{lane_level:.4f} ms; latency floors (levels times that) "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in floors.items()))


def interp_flat(state, trace, valid_only=True):
    """A machine state and the rows of a trace (the valid ones, or all)
    as a tuple of int64 tensors, for ``max_abs_err``."""
    import torch

    out = [t.to(torch.int64) for t in state]
    if trace is not None:
        valid = trace["valid"]
        out.append(valid.to(torch.int64))
        out += [(t[valid] if valid_only else t).to(torch.int64)
                for k, t in trace.items() if k != "valid"]
    return tuple(out)


def same_result(name, got, want) -> None:
    """Two result dicts of ``TpuInterpreter`` equal word for word: every
    key, and every trace column in shape, dtype and value."""
    import numpy as np

    if set(got) != set(want):
        raise AssertionError(f"{name}: keys {sorted(got)} != {sorted(want)}")
    for key in want:
        if key == "trace":
            for col, w in want["trace"].items():
                g = got["trace"][col]
                if g.shape != w.shape or g.dtype != w.dtype \
                        or not np.array_equal(g, w):
                    raise AssertionError(f"{name}: trace[{col!r}] differs")
        elif key == "outputs":
            if [list(map(int, o)) for o in got[key]] != \
                    [list(map(int, o)) for o in want[key]]:
                raise AssertionError(f"{name}: outputs differ")
        elif not np.array_equal(got[key], want[key]):
            raise AssertionError(f"{name}: {key} differs")


def interp_both(name, interp, inputs, max_cycles=None, must_halt=True):
    """Run ``interp`` from its initial state three ways on the card: chunk
    by chunk through the kernel (``interp_chunk``) and through the plain
    version side by side, holding state and valid trace rows equal after
    every chunk (and servicing paused syscalls in both); and whole through
    ``TpuInterpreter.run`` (``interp_run``), whose result and trace dicts
    must equal word for word those of the plain chunks in the reference's
    host loop (at most ``ceil(max_cycles / chunk)`` chunks, default 64;
    invalid rows 0).  Returns (cycles run, the run's result, the run's
    launches)."""
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.interp import (HALT_CYCLE_LIMIT, HALT_NONE,
                                       PAUSE_CRYPTO, interp_chunk,
                                       interp_chunk_plain)

    cfg = interp.config
    if max_cycles is None:
        max_cycles = 64 * cfg.chunk
    sk = sp = interp.init_state(inputs)
    traces = []
    for chunk in range(max(1, -(-max_cycles // cfg.chunk))):
        sk, tk = interp_chunk(interp.code, interp.n_words, sk, cfg)
        sp, tp = interp_chunk_plain(interp.code, interp.n_words, sp, cfg)
        torch.cuda.synchronize()
        max_abs_err(f"{name}, chunk {chunk}", interp_flat(sk, tk),
                    interp_flat(sp, tp))
        if tp is not None:
            traces.append({k: torch.where(
                tp["valid"].reshape(*tp["valid"].shape,
                                    *[1] * (v.dim() - 2)),
                v, torch.zeros_like(v)) for k, v in tp.items()})
        if bool((sk.halted == PAUSE_CRYPTO).any()):
            sk, sp = interp._service_crypto(sk), interp._service_crypto(sp)
            max_abs_err(f"{name}, syscalls of chunk {chunk}",
                        interp_flat(sk, None), interp_flat(sp, None))
        if not bool((sk.halted == HALT_NONE).any()):
            break
    else:
        if must_halt:
            raise AssertionError(f"{name}: still running after {chunk + 1} "
                                 "chunks")
        sp = sp._replace(halted=torch.where(
            sp.halted == HALT_NONE,
            torch.full_like(sp.halted, HALT_CYCLE_LIMIT), sp.halted))
    want = interp._collect(sp, traces, len(traces) * cfg.chunk)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    got = interp.run(inputs, max_cycles=max_cycles)
    launches = {k: v for k, v in _kernels.launches.items() if v}
    same_result(f"{name}, TpuInterpreter.run", got, want)
    return int(sk.cycles.sum()), got, launches


def lanes_program():
    """A memory, I/O and syscall program for many lanes: eight rounds of
    READ, stores and loads of every width in both memory windows, MUL,
    MULH, the divide family, shifts, compares and a WRITE; then a
    Poseidon2 syscall over a tape-dependent number of the stored bytes,
    its first digest word written out, and EXIT."""
    from zkir_tpu_torch.spec import Instruction as I, Op, Program

    ins = [
        I(Op.ADDI, rd=15, rs1=0, imm=0x6000),       # low-window scratch
        I(Op.ADDI, rd=14, rs1=0, imm=-1),           # = STACK_TOP (40 bits)
        I(Op.ADDI, rd=14, rs1=14, imm=-71),         # 8-aligned, 72 below
        I(Op.ADDI, rd=9, rs1=0, imm=8),             # round counter
    ]
    loop = [
        I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),        # READ -> r10
        I(Op.ADDI, rd=1, rs1=10, imm=0),
        I(Op.MUL, rd=2, rs1=1, rs2=1),
        I(Op.MULH, rd=3, rs1=2, rs2=1),
        I(Op.SD, rs1=15, rs2=2, imm=0), I(Op.SW, rs1=15, rs2=3, imm=8),
        I(Op.SH, rs1=15, rs2=1, imm=12), I(Op.SB, rs1=15, rs2=1, imm=14),
        I(Op.SD, rs1=14, rs2=3, imm=0), I(Op.SB, rs1=14, rs2=2, imm=71),
        I(Op.LB, rd=4, rs1=15, imm=1), I(Op.LBU, rd=5, rs1=15, imm=14),
        I(Op.LH, rd=6, rs1=15, imm=2), I(Op.LHU, rd=7, rs1=15, imm=12),
        I(Op.LW, rd=8, rs1=14, imm=4), I(Op.LD, rd=2, rs1=14, imm=0),
        I(Op.LBU, rd=11, rs1=14, imm=71),
        I(Op.ORI, rd=12, rs1=5, imm=1),
        I(Op.DIVU, rd=3, rs1=2, rs2=12), I(Op.REM, rd=4, rs1=4, rs2=12),
        I(Op.DIV, rd=6, rs1=6, rs2=12), I(Op.REMU, rd=7, rs1=8, rs2=12),
        I(Op.SRA, rd=5, rs1=4, rs2=9), I(Op.SLL, rd=8, rs1=8, rs2=9),
        I(Op.SRLI, rd=13, rs1=2, imm=3),
        I(Op.SLT, rd=12, rs1=4, rs2=6), I(Op.SGEU, rd=13, rs1=13, rs2=7),
        I(Op.CMOVNZ, rd=3, rs1=8, rs2=12), I(Op.CMOVZ, rd=3, rs1=5, rs2=13),
        I(Op.XOR, rd=11, rs1=11, rs2=3), I(Op.ADD, rd=11, rs1=11, rs2=6),
        I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL),        # WRITE r11
        I(Op.ADDI, rd=15, rs1=15, imm=16),
        I(Op.ADDI, rd=9, rs1=9, imm=-1),
    ]
    loop.append(I(Op.BNE, rs1=9, rs2=0, imm=-4 * len(loop)))
    tail = [
        I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),        # READ: length
        I(Op.ANDI, rd=12, rs1=10, imm=0x7F),
        I(Op.ADDI, rd=11, rs1=0, imm=0x6000),
        I(Op.ADDI, rd=13, rs1=0, imm=0x6100),
        I(Op.ADDI, rd=10, rs1=0, imm=4), I(Op.ECALL),        # POSEIDON2
        I(Op.LD, rd=11, rs1=13, imm=0),
        I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL),        # WRITE r11
        I(Op.ANDI, rd=11, rs1=11, imm=0xFF),
        I(Op.ADDI, rd=10, rs1=0, imm=0), I(Op.ECALL),        # EXIT
    ]
    return Program.from_instructions(ins + loop + tail)


def empty_crypto_program():
    """SHA-256 of zero bytes from an input pointer outside both memory
    windows (2^21), its first digest word written out: the reference reads
    no input byte and halts 1 with 0xe3b0c442."""
    from zkir_tpu_torch.spec import Instruction as I, Op, Program

    return Program.from_instructions([
        I(Op.ADDI, rd=11, rs1=0, imm=1), I(Op.SLLI, rd=11, rs1=11, imm=21),
        I(Op.ADDI, rd=10, rs1=0, imm=3), I(Op.ADDI, rd=12, rs1=0, imm=0),
        I(Op.ADDI, rd=13, rs1=0, imm=0x4000), I(Op.ECALL),
        I(Op.ADDI, rd=1, rs1=0, imm=0x4000), I(Op.LW, rd=11, rs1=1, imm=0),
        I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL), I(Op.EBREAK)])


def staggered_program():
    """Lanes that pause at different chunks: a busy loop of a
    tape-dependent length, then a tape-dependent number of rounds of
    READ, a store, a Poseidon2 syscall over it (a pause), a load of the
    digest and a WRITE; then EXIT."""
    from zkir_tpu_torch.spec import Instruction as I, Op, Program

    ins = [
        I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),        # READ -> r10
        I(Op.ANDI, rd=7, rs1=10, imm=0x3F),
        I(Op.ADDI, rd=7, rs1=7, imm=1),                      # 1..64
        I(Op.ANDI, rd=9, rs1=10, imm=0x3),
        I(Op.ADDI, rd=9, rs1=9, imm=1),                      # 1..4 rounds
        I(Op.ADDI, rd=7, rs1=7, imm=-1),                     # busy loop
        I(Op.BNE, rs1=7, rs2=0, imm=-4),
        I(Op.ADDI, rd=15, rs1=0, imm=0x6000),
    ]
    loop = [
        I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),        # READ -> r10
        I(Op.SD, rs1=15, rs2=10, imm=0),
        I(Op.ADDI, rd=11, rs1=15, imm=0),
        I(Op.ADDI, rd=12, rs1=0, imm=8),
        I(Op.ADDI, rd=13, rs1=0, imm=0x6100),
        I(Op.ADDI, rd=10, rs1=0, imm=4), I(Op.ECALL),        # POSEIDON2
        I(Op.LD, rd=11, rs1=13, imm=0),
        I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL),        # WRITE r11
        I(Op.ADDI, rd=15, rs1=15, imm=8),
        I(Op.ADDI, rd=9, rs1=9, imm=-1),
    ]
    loop.append(I(Op.BNE, rs1=9, rs2=0, imm=-4 * len(loop)))
    tail = [I(Op.ADDI, rd=11, rs1=15, imm=0),
            I(Op.ADDI, rd=10, rs1=0, imm=0), I(Op.ECALL)]    # EXIT
    return Program.from_instructions(ins + loop + tail)


# The crypto program's buffer: right after its code in the low window, room
# for the longest input; the lengths each hash is called with (block
# edges of SHA-256 and BLAKE3 at 55, 56, 64; of Keccak at 135, 136, 137; of
# a BLAKE3 chunk at 1,023, 1,024, 1,025); the syscalls in the order a lane
# calls them (from a tape-given start): SHA-256, Keccak-256, BLAKE3,
# Poseidon2.
CRYPTO_BUF = 0x1400
CRYPTO_FILL_WORDS = 376
CRYPTO_LENGTHS = (0, 55, 56, 64, 135, 136, 137, 1023, 1024, 1025, 3000)
CRYPTO_KINDS = (3, 5, 6, 4)


def crypto_lanes_program():
    """Fill the buffer with 376 tape words (3,008 bytes), then four times:
    READ a syscall number and a length, hash the buffer's first ``length``
    bytes into its first 32 (so each input starts with the previous
    digest), WRITE the digest image's first word; then EXIT 0."""
    from zkir_tpu_torch.spec import Instruction as I, Op, Program

    ins = [I(Op.ADDI, rd=15, rs1=0, imm=CRYPTO_BUF),
           I(Op.ADDI, rd=9, rs1=0, imm=CRYPTO_FILL_WORDS)]
    fill = [I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),    # READ -> r10
            I(Op.SD, rs1=15, rs2=10, imm=0),
            I(Op.ADDI, rd=15, rs1=15, imm=8),
            I(Op.ADDI, rd=9, rs1=9, imm=-1)]
    fill.append(I(Op.BNE, rs1=9, rs2=0, imm=-4 * len(fill)))
    hashes = [I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),  # the syscall
              I(Op.ADDI, rd=5, rs1=10, imm=0),
              I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),  # the length
              I(Op.ADDI, rd=12, rs1=10, imm=0),
              I(Op.ADDI, rd=11, rs1=0, imm=CRYPTO_BUF),
              I(Op.ADDI, rd=13, rs1=0, imm=CRYPTO_BUF),
              I(Op.ADDI, rd=10, rs1=5, imm=0), I(Op.ECALL),  # the hash
              I(Op.LW, rd=11, rs1=13, imm=0),
              I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL),  # WRITE r11
              I(Op.ADDI, rd=9, rs1=9, imm=-1)]
    hashes.append(I(Op.BNE, rs1=9, rs2=0, imm=-4 * len(hashes)))
    tail = [I(Op.ADDI, rd=11, rs1=0, imm=0),
            I(Op.ADDI, rd=10, rs1=0, imm=0), I(Op.ECALL)]    # EXIT 0
    program = Program.from_instructions(
        ins + fill + [I(Op.ADDI, rd=9, rs1=0, imm=4)] + hashes + tail)
    assert 0x1000 + 4 * len(program.code) <= CRYPTO_BUF
    return program


def crypto_tapes(lanes: int, seed: int):
    """uint64 ``[lanes, 384]``: the fill words, then (syscall, length) four
    times, the syscalls in ``CRYPTO_KINDS``' order from a seeded start."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fill = rng.integers(0, 1 << 64, size=(lanes, CRYPTO_FILL_WORDS),
                        dtype=np.uint64)
    start = rng.integers(0, 4, size=(lanes, 1))
    kinds = np.asarray(CRYPTO_KINDS)[(start + np.arange(4)) % 4]
    lengths = rng.choice(CRYPTO_LENGTHS, size=(lanes, 4))
    calls = np.stack([kinds, lengths], 2).reshape(lanes, 8)
    return np.concatenate([fill, calls.astype(np.uint64)], 1)


def crypto_expected(tapes):
    """The outputs ``crypto_lanes_program`` must write, recomputed on the
    host from the tapes: uint64 ``[lanes, 4]``.  SHA-256 by ``hashlib``;
    Keccak-256, BLAKE3 and Poseidon2 by the port's plain versions on the
    CPU; each image as ``prover/trace.py::crypto_digest`` gives it."""
    import hashlib

    import numpy as np

    from zkir_tpu_torch.ops import blake3, keccak
    from zkir_tpu_torch.ops import poseidon2 as p2

    lanes = tapes.shape[0]
    buf = np.ascontiguousarray(tapes[:, :CRYPTO_FILL_WORDS]).view(
        np.uint8).reshape(lanes, -1).copy()
    calls = tapes[:, CRYPTO_FILL_WORDS:].astype(np.int64).reshape(lanes, 4, 2)
    out = np.zeros((lanes, 4), dtype=np.uint64)
    for step in range(4):
        images = np.zeros((lanes, 32), dtype=np.uint8)
        for kind in CRYPTO_KINDS:
            rows = np.nonzero(calls[:, step, 0] == kind)[0]
            messages = [buf[r, :calls[r, step, 1]].tobytes() for r in rows]
            if kind == 3:               # big-endian words stored by write_u32
                got = [b"".join(d[i:i + 4][::-1] for i in range(0, 32, 4))
                       for d in (hashlib.sha256(m).digest()
                                 for m in messages)]
            elif kind == 4:
                words = p2.sponge_hash_bytes_batch(messages, "cpu").numpy()
                got = [row.astype("<u4").tobytes() for row in words]
            elif kind == 5:
                got = keccak.keccak256_many(messages, "cpu")
            else:
                got = blake3.blake3_many(messages, "cpu")
            images[rows] = np.frombuffer(b"".join(got), dtype=np.uint8
                                         ).reshape(-1, 32)
        buf[:, :32] = images
        out[:, step] = images[:, :4].copy().view("<u4")[:, 0]
    return out


@contextlib.contextmanager
def service_rounds(rounds: list):
    """Record each ``TpuInterpreter._service_crypto`` call into ``rounds``:
    its paused lanes, its seconds (the device synchronised before and
    after) and the launches of each kernel during it."""
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.interp import columnar

    cls = columnar.TpuInterpreter
    service = cls._service_crypto

    def timed(self, state):
        lanes = int((state.halted == columnar.PAUSE_CRYPTO).sum())
        before = dict(_kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = service(self, state)
        torch.cuda.synchronize()
        rounds.append({"lanes": lanes, "s": time.perf_counter() - t0,
                       "launches": {k: v - before.get(k, 0) for k, v in
                                    _kernels.launches.items()
                                    if v != before.get(k, 0)}})
        return state

    cls._service_crypto = timed
    try:
        yield rounds
    finally:
        cls._service_crypto = service


def interp_floor() -> dict:
    """Instructions every cycle executes in each layout of the built
    interpreter kernel (``tools/sass_count.py`` floor of its cycle loop):
    a warp per lane with a trace (the one-lane main path), a thread per
    lane without one (many lanes), and a warp per lane with a trace in the
    deferred model's build; each capped at ``INTERP_INSTR_PER_CYCLE``: the
    bound never loosens."""
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.tools.sass_count import cycle_loop_floor, instructions

    cuobjdump = pathlib.Path(_kernels._nvcc()).parent / "cuobjdump"
    sass = _kernels.BUILD / "interp.sass"
    sass.write_text(subprocess.run(
        [str(cuobjdump), "-sass", str(_kernels.library_path())],
        capture_output=True, text=True, check=True).stdout)
    out = {}
    # interp_kernel<WARP, COLLECT, DEFERRED>'s mangled names.
    for layout, name in (("warp", "interp_kernelILb1ELb1ELb0E"),
                         ("thread", "interp_kernelILb0ELb0ELb0E"),
                         ("warp_deferred", "interp_kernelILb1ELb1ELb1E")):
        static, floor = cycle_loop_floor(instructions(sass, name))
        out[layout] = {"static": static, "floor": floor,
                       "bound_instr": min(floor, INTERP_INSTR_PER_CYCLE)}
    log(f"interp_kernel SASS (static instructions of the cycle loop, the "
        f"floor every cycle executes): {out}")
    return out


def phase_interp(results) -> dict:
    """Kernel K3 against its plain version, the syscall path, the
    proof-of-work search, one lane's clocks, and the interpreter's
    throughput in both layouts."""
    import numpy as np
    import torch

    from zkir_tpu_torch.interp import (InterpConfig, TpuInterpreter,
                                       interp_run, interp_run_plain)
    from zkir_tpu_torch.interp import columnar
    from zkir_tpu_torch.ops import poseidon2 as p2
    from zkir_tpu_torch.prover import trace_to_matrix
    from zkir_tpu_torch.prover.benchtrace import exact_trace_program
    from zkir_tpu_torch.prover.challenger import Challenger
    from zkir_tpu_torch.spec import Program
    from zkir_tpu_torch.tools import interp_bench
    from zkir_tpu_torch.tools.fuzz_programs import generate_program

    stats = {"floor": interp_floor()}
    small = dict(low_bytes=1 << 15, stack_bytes=1 << 12, collect_trace=True)

    # (a) the fuzz corpus's 64 programs, two lanes with different tapes.
    t0 = time.perf_counter()
    cycles = 0
    for seed in range(64):
        program, inputs = generate_program(seed)
        interp = TpuInterpreter(program, InterpConfig(
            lanes=2, chunk=64, **small), device="cuda")
        cycles += interp_both(f"interp fuzz seed {seed}", interp,
                              [inputs, [x ^ 0x5A5A for x in inputs[::-1]]])[0]
    log(f"interp_chunk, interp_run: exact on 64 fuzz programs x 2 lanes "
        f"({cycles} cycles, {time.perf_counter() - t0:.1f} s)")

    # (b) memory, I/O and a Poseidon2 syscall on 1,024 lanes, through the
    # entry point a user calls: the Poseidon2 syscalls of all lanes in one
    # p2_sponge_bytes launch a service round, and no p2_permute.
    lanes = 1024
    rng = np.random.default_rng(SEED)
    tapes = [[int(v) for v in rng.integers(0, 1 << 40, size=9)]
             for _ in range(lanes)]
    interp = TpuInterpreter(lanes_program(), InterpConfig(
        lanes=lanes, chunk=128, **small), device="cuda")
    cycles, result, launches = interp_both("interp 1,024 lanes", interp,
                                           tapes)
    stats["syscall_path_launches"] = launches
    if not launches.get("p2_sponge_bytes") or not launches.get("interp_run") \
            or launches.get("p2_permute"):
        raise AssertionError(f"the syscall path launched {launches}")
    if set(result["halted"].tolist()) != {2} \
            or any(len(o) != 9 for o in result["outputs"]) \
            or len({int(o[8]) for o in result["outputs"]}) < lanes // 2:
        raise AssertionError("the 1,024-lane run did not exit with nine "
                             "outputs a lane")
    log(f"interp_chunk, interp_run: exact on the memory/I/O/syscall "
        f"program, {lanes} lanes ({cycles} cycles); syscall path: {launches}")

    # (c) lanes that pause at different chunks and run ahead of each
    # other, to their end and cut by a limit that is not a multiple of the
    # chunk; few lanes (a warp each) and many (a thread each: more than
    # WARP_LANES_TRACED).
    for lanes, chunk, limit in ((4, 16, None), (4, 16, 150),
                                (2048, 16, None), (2048, 16, 150)):
        tapes = [[int(v) for v in rng.integers(0, 1 << 40, size=5)]
                 for _ in range(lanes)]
        interp = TpuInterpreter(staggered_program(), InterpConfig(
            lanes=lanes, chunk=chunk, **small), device="cuda")
        cycles, result, launches = interp_both(
            f"interp staggered {lanes} lanes, max_cycles {limit}", interp,
            tapes, max_cycles=limit, must_halt=limit is None)
        halts = sorted(set(result["halted"].tolist()))
        if halts != ([2] if limit is None else [2, 3]):
            raise AssertionError(f"staggered run halted {halts}")
        log(f"interp_chunk, interp_run: exact on the staggered program, "
            f"{lanes} lanes, max_cycles {limit} ({cycles} cycles, halts "
            f"{halts}, {launches})")

    # (d) golden E's program: SHA-256 pause and resume.
    program = Program.from_bytes(
        (FIXTURES / "golden_e.program.zkir").read_bytes())
    cfg = InterpConfig(lanes=1, chunk=16, collect_trace=True)
    interp_both("interp golden e", TpuInterpreter(program, cfg,
                                                  device="cuda"), [[]])
    matrix = trace_to_matrix(
        TpuInterpreter(program, cfg, device="cuda").run([[]])["trace"],
        program=program)
    with np.load(FIXTURES / "golden_e.matrix.npz") as z:
        if not np.array_equal(matrix, z["matrix"]):
            raise AssertionError("golden e: the card-made matrix differs "
                                 "from the stored one")
    log("interp_chunk, interp_run: exact on golden e's program; matrix "
        "equal to the stored one")
    # (e) a crypto syscall with no input bytes and its pointer outside both
    # windows: K3 pauses, the host reads no input byte.
    _, result, _ = interp_both("interp empty crypto input", TpuInterpreter(
        empty_crypto_program(), InterpConfig(lanes=1, chunk=16),
        device="cuda"), [[]])
    if result["halted"].tolist() != [1] \
            or result["outputs"] != [[3820012610]]:
        raise AssertionError(f"SHA-256 of no bytes: halted "
                             f"{result['halted'].tolist()}, outputs "
                             f"{result['outputs']}")
    log("interp_chunk, interp_run: exact on SHA-256 of no input bytes from "
        "outside the windows (halt 1, output 3820012610)")

    # The main path's shape, timed: one lane with a trace, 1,024 cycles
    # (interp_run over a one-chunk segment), and the whole 2^16-cycle run
    # in one interp_run launch.
    interp = TpuInterpreter(exact_trace_program(16), InterpConfig(
        lanes=1, chunk=1024, collect_trace=True), device="cuda")
    state0 = interp.init_state([[]])
    state_bytes = sum(t.numel() * t.element_size() for t in state0)
    floor = stats["floor"]["warp" if columnar.warp_layout(1, True)
                           else "thread"]

    def fresh(chunks):
        """A copy of the initial state, each lane at chunk 0, and a zeroed
        trace of ``chunks`` chunks."""
        state = state0._replace(**{k: getattr(state0, k).clone()
                                   for k in columnar._MUTABLE})
        at = torch.zeros(1, dtype=torch.int32, device="cuda")
        return state, at, columnar._new_trace(1024 * chunks, 1, "cuda")

    def segment(run, chunks=1, kernel=True):
        state, at, trace = fresh(chunks)
        kw = {"decoded": interp.decoded} if kernel else {}
        state = run(interp.code, interp.n_words, state, at, 0, chunks,
                    interp.config, trace, **kw)
        return interp_flat(state, trace, valid_only=False) + (at,)

    compare("interp_run", lambda: segment(interp_run),
            lambda: segment(interp_run_plain, kernel=False), 20, results,
            plain_iters=1, bounds=interp_bound(
                2 * state_bytes + columnar.TRACE_ROW_BYTES * 1024, 1024, 1,
                floor["bound_instr"]))
    rows = 1 << 16
    chunks = rows // 1024
    # The interp_run call alone (state and trace made outside the timed
    # span), and with the set-up and interp_flat's conversions around it.
    ms = 0.0
    for it in range(6):
        state, at, trace = fresh(chunks)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        interp_run(interp.code, interp.n_words, state, at, 0, chunks,
                   interp.config, trace, decoded=interp.decoded)
        end.record()
        torch.cuda.synchronize()
        if int(state.cycles[0]) != rows:
            raise AssertionError(f"the 2^16 run ran {int(state.cycles[0])} "
                                 "cycles")
        if it:                  # the first launch is the warm-up
            ms += start.elapsed_time(end) / 5
    ms_setup = cuda_ms(lambda: segment(interp_run, chunks=chunks), 5)
    b = interp_bound(2 * state_bytes + columnar.TRACE_ROW_BYTES * rows,
                     rows, 1,
                     floor["bound_instr"])
    results["interp_run"].update(
        shape="1 lane x 1,024 cycles, a one-chunk segment", ms_2e16=ms,
        ms_2e16_with_setup=ms_setup, bound_ms_2e16=b["bound_ms"],
        cycles_2e16=rows)
    log(f"interp_run: the 2^16-cycle run, the launch alone {ms:.4f} ms, "
        f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
        f"({100 * b['bound_ms'] / ms:.1f}%); with the state's copy, the "
        f"trace's allocation and the int64 views {ms_setup:.4f} ms")

    # One lane's clocks a cycle, by phase (a stamped build of the kernel),
    # and the other layout at the same shape.
    source = ROOT / "zkir_tpu_torch" / "csrc" / "interp.cu"
    clk = interp_bench.clocks(source)
    other = interp_bench.clocks(source,
                                warp=not columnar.warp_layout(1, True),
                                stamps=False)
    if other["ms"] <= clk["ms"]:
        raise AssertionError(f"warp_layout picks the slower layout for one "
                             f"lane: {clk}, {other}")
    per_1024 = clk["ms"] * 1024 / clk["cycles"]
    share = results["interp_run"]["bound_ms"] / per_1024
    stamped_ms = clk["clocks_per_cycle"] * clk["cycles"] / SM_CLOCK_HZ * 1e3
    if not 0.5 < stamped_ms / clk["ms_stamped"] < 1.5 \
            or clk["ms"] <= results["interp_run"]["bound_ms"]:
        raise AssertionError(f"one lane's clocks do not add up: {clk}")
    stats["one_lane_clocks"] = {**clk, "ms_per_1024": per_1024,
                                "share_of_bound": share,
                                "other_layout": other}
    log(f"one lane ({clk['layout']} layout): {per_1024:.4f} ms per 1,024 "
        f"cycles as a launch alone ({other['layout']} layout "
        f"{other['ms']:.4f} ms), {100 * share:.1f}% of the bound; "
        f"{clk['clocks_per_cycle']:.1f} SM clocks a cycle stamped: "
        + ", ".join(f"{k} {v:.1f}" for k, v in clk["phases"].items()))

    # Throughput on the reference benchmark's loop program, no trace:
    # lanes x chunk cycles per launch, three chunks by CUDA events, through
    # chunk_fn (the layout the wrapper picks).  Then both layouts, the
    # kernel alone, without a trace and with one.
    for lanes in (65536, 8192):
        interp = TpuInterpreter(interp_bench.loop_program(), InterpConfig(
            lanes=lanes, chunk=512, low_bytes=1 << 13,
            stack_bytes=1 << 12), device="cuda")
        state = interp.init_state([[1]] * lanes)
        state, _ = interp.chunk_fn(state)           # warm
        holder = [state]

        def three_chunks():
            for _ in range(3):
                holder[0], _ = interp.chunk_fn(holder[0])

        ms = cuda_ms(three_chunks, 3)
        done = int(holder[0].cycles[0])
        if done != 512 * 13 or bool((holder[0].cycles != done).any()):
            raise AssertionError(f"loop program ran {done} cycles a lane")
        rate = 3 * 512 * lanes / (ms / 1e3)
        layout = "warp" if columnar.warp_layout(lanes, False) else "thread"
        results[f"chunk_fn loop program [{lanes} lanes x 512]"] = {
            "ms": ms / 3, "cycles_per_s": rate, "layout": layout,
            **interp_bound(2 * lanes * 16 * 12, 512, lanes,
                           stats["floor"][layout]["bound_instr"])}
        stats[f"interp_cycles_per_s_{lanes}_lanes"] = rate
        log(f"chunk_fn: {lanes} lanes x 512 cycles in {ms / 3:.3f} ms "
            f"a launch, {rate:.4g} cycles/s ({layout} layout)")
    sweep = [interp_bench.loop_rate(lanes, warp)
             for lanes in (1, 8, 64, 256, 1024, 2048, 8192, 65536)
             for warp in (True, False)]
    traced = [interp_bench.loop_rate(lanes, warp, trace=True)
              for lanes in (1, 2, 8, 64, 256, 512, 1024)
              for warp in (True, False)]
    stats["layouts"] = sweep
    stats["layouts_with_trace"] = traced
    for what, rates in (("", sweep), (" with a trace", traced)):
        log(f"loop program{what}, cycles/s by lanes, warp / thread layout: "
            + "; ".join(f"{a['lanes']}: {a['cycles_per_s']:.4g} / "
                        f"{b['cycles_per_s']:.4g}"
                        for a, b in zip(rates[::2], rates[1::2])))
    for a, b in zip(traced[::2], traced[1::2]):
        picked, other = (a, b) if columnar.warp_layout(a["lanes"], True) \
            else (b, a)
        if picked["cycles_per_s"] < other["cycles_per_s"]:
            raise AssertionError(f"warp_layout picks the slower layout with "
                                 f"a trace: {picked}, {other}")
    warp, thread = sweep[-2:]
    if warp["cycles_per_s"] >= thread["cycles_per_s"]:
        raise AssertionError(f"warp_layout picks the slower layout at "
                             f"65,536 lanes: {warp}, {thread}")

    # p2_grind against grind_plain: equal nonces, and check_pow accepts.
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    for bits in (2, 8, 16):
        for trial in range(3):
            state = words(gen, (16,)).tolist()
            nonce = p2.grind(state, bits, "cuda")
            want = p2.grind_plain(state, bits, "cuda")
            if nonce != want:
                raise AssertionError(f"p2_grind found {nonce}, grind_plain "
                                     f"{want} ({bits} bits)")
            ch = Challenger()
            ch._state = list(state)
            if not ch.check_pow(nonce, bits):
                raise AssertionError(f"check_pow refuses nonce {nonce}")
    log("p2_grind: nonces equal to grind_plain's for 2, 8 and 16 bits; "
        "check_pow accepts")
    state = words(gen, (16,)).tolist()
    trials = p2.grind_plain(state, 16, "cuda") + 1
    compare("p2_grind",
            lambda: torch.tensor([p2.grind(state, 16, "cuda")]),
            lambda: torch.tensor([p2.grind_plain(state, 16, "cuda")]),
            20, results, plain_iters=3, n_bytes=16 * 8 + 8,
            n_ops=P2_INSTR_PER_PERMUTATION * trials)
    results["p2_grind"]["trials"] = trials
    t0 = time.perf_counter()
    for _ in range(20):
        p2.grind(state, 16, "cuda")
    results["p2_grind"]["call_ms_host_clock"] = \
        (time.perf_counter() - t0) / 20 * 1e3
    log(f"p2_grind: 16 bits, {trials} trials; the whole call "
        f"{results['p2_grind']['call_ms_host_clock']:.4f} ms by the host "
        f"clock")
    return stats


def device_ms(fn, iters: int) -> dict:
    """Mean device milliseconds a call of ``fn()`` spends in each CUDA
    kernel it launches (``torch.profiler``), and their sum under
    ``"all"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {row.key: row.device_time_total / 1e3 / iters
           for row in prof.key_averages() if row.device_time_total}
    out["all"] = sum(out.values())
    return out


def crypto_instructions() -> dict:
    """Instructions of one SHA-256 block, keccak-f[1600] and BLAKE3
    compression in this build of ``csrc/crypto.cu`` (a SASS probe)."""
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.tools.sass_count import crypto_instructions as count

    out = count(_kernels._nvcc(), _kernels.CSRC, _kernels.BUILD / "probe")
    log(f"crypto.cu SASS: instructions a compression {out}")
    return out


def p2_instructions() -> dict:
    """Instructions of one Poseidon2 permutation in this build of
    ``csrc/poseidon2.cu`` (a SASS probe): one thread's (``one``) and four
    lanes' together (``four``)."""
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.tools.sass_count import p2_instructions as count

    out = count(_kernels._nvcc(), _kernels.CSRC, _kernels.BUILD / "probe")
    log(f"poseidon2.cu SASS: instructions a permutation {out}")
    return out


def phase_crypto(results) -> dict:
    """The batched hashes (``csrc/crypto.cu``, and ``p2_sponge_bytes`` of
    ``csrc/poseidon2.cu``): (a) each kernel against its plain version,
    exact, at the syscall path's shapes (SHA-256 over 65,536 messages of
    200 bytes and its witness over 65,536 blocks, Keccak over 65,536 x 300
    bytes, whole BLAKE3 messages of 65,536 x 1,025 and 4,096 x 3,000 bytes
    and of 33 to 129 chunks (also against the host oracle), a BLAKE3
    compression of 65,536 parents, the Poseidon2 sponge over 16,384 rows
    of the run's lengths and 4,096 x 3,000 bytes), timed beside the bound
    (bytes, or this build's SASS instructions a compression or permutation
    times their count; for the sponge also the latency floor), and the
    known answers (hashlib, the host oracles, Keccak("abc")); (b)
    ``crypto_lanes_program`` on 65,536 lanes at the reference
    benchmark's shape through ``TpuInterpreter.run``: every lane's outputs
    against the host recomputation, 8 lanes against the oracle VM, each
    service round's seconds and launches (exactly one launch of each of
    ``CRYPTO_KERNELS`` a round, none of ``p2_permute`` or
    ``b3_compress``)."""
    import hashlib

    import numpy as np
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.interp import HALT_EXIT, InterpConfig, TpuInterpreter
    from zkir_tpu_torch.ops import blake3, keccak, sha256
    from zkir_tpu_torch.ops import poseidon2 as p2
    from zkir_tpu_torch.runtime import VM, VMConfig
    from zkir_tpu_torch.runtime.crypto import blake3_digest, keccak256_digest

    t_phase = time.perf_counter()
    # (b)'s tapes, and their outputs recomputed on the host while the card
    # works through (a).
    lanes = 65536
    tapes = crypto_tapes(lanes, SEED)
    host = ThreadPoolExecutor(1)
    expected = host.submit(lambda: (time.perf_counter(),
                                    crypto_expected(tapes),
                                    time.perf_counter()))
    stats = {"instructions": crypto_instructions()}
    instr = stats["instructions"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)

    def rand_bytes(n):
        return torch.randint(0, 256, (n,), generator=gen, device="cuda",
                             dtype=torch.uint8)

    def rows(n, width):
        return np.arange(n, dtype=np.int64) * width, np.full(n, width)

    # (a) SHA-256: 65,536 messages of 200 bytes (4 blocks each), and their
    # digests against hashlib.
    n = 65536
    data, (offs, lens) = rand_bytes(n * 200), rows(n, 200)
    compare("sha256_blocks", lambda: sha256.sha256_rows(data, offs, lens),
            lambda: sha256.sha256_rows_plain(data, offs, lens)[0], 20,
            results, plain_iters=1, n_bytes=n * (200 + 16 + 64),
            n_ops=4 * n * instr["sha256_block"])
    results["sha256_blocks"]["shape"] = "65,536 messages x 200 bytes"
    alone = {"sha256_blocks": device_ms(
        lambda: sha256.sha256_rows(data, offs, lens), 20)}
    blob = data.cpu().numpy().tobytes()
    got = sha256.digests_to_bytes(sha256.sha256_rows(data, offs, lens).cpu()
                                  .numpy())
    if got != [hashlib.sha256(blob[o:o + 200]).digest() for o in offs]:
        raise AssertionError("sha256_blocks differs from hashlib")
    # The witness: 65,536 single blocks from seeded states.
    blocks = torch.randint(0, 1 << 32, (n, 16), generator=gen, device="cuda")
    states = torch.randint(0, 1 << 32, (n, 8), generator=gen, device="cuda")
    compare("sha256_blocks with witness [65536 x 1 block]",
            lambda: sha256.sha256_compress_batch_with_witness(blocks, states),
            lambda: sha256.sha256_rows_plain(
                sha256._block_bytes(blocks), *rows(n, 64), states, False,
                True),
            20, results, plain_iters=1,
            n_bytes=n * (64 + 16 + 64 + 64 + 64 * 64),
            n_ops=n * instr["sha256_block"])
    del data, blocks, states
    # Keccak-256: 65,536 x 300 bytes (3 blocks each).
    data, (offs, lens) = rand_bytes(n * 300), rows(n, 300)
    compare("keccak_absorb", lambda: keccak.keccak_rows(data, offs, lens),
            lambda: keccak.keccak_rows_plain(data, offs, lens), 20, results,
            plain_iters=1, n_bytes=n * (300 + 16 + 200),
            n_ops=3 * n * instr["keccak_f"])
    results["keccak_absorb"]["shape"] = "65,536 messages x 300 bytes"
    alone["keccak_absorb"] = device_ms(
        lambda: keccak.keccak_rows(data, offs, lens), 20)
    # BLAKE3, whole messages in one b3_rows launch: 65,536 x 1,025 bytes
    # (two chunks each), 4,096 x 3,000 (three), and messages of 33, 63, 65
    # and 129 chunks among short ones (trees of 2, 3 and 5 batches of 32
    # chunks), against the plain version (the chunk loop and the level
    # loop), the long ones also against the host oracle.  Bound: bytes,
    # or this build's instructions a compression times the compressions.
    def b3_ops(lengths):
        lengths = np.asarray(lengths)
        chunks = np.maximum(1, -(-lengths // 1024))
        last = lengths - 1024 * (chunks - 1)
        blocks = 16 * (chunks - 1) + np.maximum(1, -(-last // 64))
        return int((blocks + chunks - 1).sum()) * instr["b3_compress"]

    for key, n_msg, width in (("b3_rows", n, 1025),
                              ("b3_rows [4096 x 3000]", 4096, 3000)):
        data, (offs, lens) = rand_bytes(n_msg * width), rows(n_msg, width)
        compare(key, lambda: blake3.blake3_rows(data, offs, lens),
                lambda: blake3.blake3_rows_plain(data, offs, lens), 20,
                results, plain_iters=1, n_bytes=n_msg * (width + 32 + 64),
                n_ops=b3_ops(lens))
        results[key]["shape"] = f"{n_msg:,} messages x {width:,} bytes"
        alone[key] = device_ms(
            lambda: blake3.blake3_rows(data, offs, lens), 20)
    big = [33 * 1024, 63 * 1024 - 5, 64 * 1024 + 1, 129 * 1024 - 777]
    lens = np.array(big + [0, 1, 64, 1025, 3000] * 40 + big[::-1])
    offs = np.cumsum(lens) - lens + np.arange(lens.size) % 3
    data = rand_bytes(int((offs + lens).max()))
    compare("b3_rows [33, 63, 65, 129 chunks]",
            lambda: blake3.blake3_rows(data, offs, lens),
            lambda: blake3.blake3_rows_plain(data, offs, lens), 5, results,
            plain_iters=1, n_bytes=int(lens.sum()) + lens.size * 96,
            n_ops=b3_ops(lens))
    blob = data.cpu().numpy().tobytes()
    got = blake3.blake3_rows(data, offs, lens).cpu().numpy()
    for i in range(len(big)):
        if got[i].astype("<u4").tobytes() != blake3_digest(
                blob[offs[i]:offs[i] + lens[i]]):
            raise AssertionError(f"b3_rows differs from blake3_digest on "
                                 f"{lens[i]} bytes")
    log(f"b3_rows: equal to blake3_digest on {big} bytes")
    # b3_compress_batch, the reference's public compression: 65,536
    # parents of two chunks each.
    cvs = torch.randint(0, 1 << 32, (n, 16), generator=gen, device="cuda")
    level = [torch.zeros(n, dtype=torch.int64, device="cuda"),
             torch.zeros(n, dtype=torch.int64, device="cuda"),
             torch.full((n,), 64, dtype=torch.int64, device="cuda"),
             torch.full((n,), 12, dtype=torch.int64, device="cuda")]
    compare("b3_compress",
            lambda: blake3.b3_compress_batch(None, cvs, *level),
            lambda: blake3.b3_compress_plain(None, cvs, *level), 20, results,
            plain_iters=1, n_bytes=n * (128 + 32 + 64),
            n_ops=n * instr["b3_compress"])
    results["b3_compress"]["shape"] = "65,536 parents of 2 chunks"
    alone["b3_compress"] = device_ms(
        lambda: blake3.b3_compress_batch(None, cvs, *level), 20)
    del data, cvs, level
    # The Poseidon2 syscall sponge in one p2_sponge_bytes launch: 16,384
    # rows with lengths drawn from CRYPTO_LENGTHS and 4,096 x 3,000 bytes,
    # the rows at unaligned offsets, against the plain version (a batch of
    # permute_plain a block position).  Bound: the larger of bytes, the
    # blocks times the fewest instructions a permutation takes in this
    # build (one thread's), and the latency floor: the longest row's blocks
    # times one permutation's latency in the kernel's chain, the kernel
    # alone on that row less the kernel alone on a row of one block, over
    # the blocks between (a launch's own cost cancels).
    stats["p2_instructions"] = p2_instructions()
    rng = np.random.default_rng(SEED + 4)

    def sponge_alone(data, offs, lens, iters):
        times = device_ms(lambda: p2.sponge_hash_rows(data, offs, lens),
                          iters)
        return sum(v for k, v in times.items() if "sponge_bytes_kernel" in k)

    for key, lens in (
            ("p2_sponge_bytes", rng.choice(CRYPTO_LENGTHS, 16384)),
            ("p2_sponge_bytes [4096 x 3000]", np.full(4096, 3000))):
        offs = np.cumsum(lens) - lens + 2 * np.arange(lens.size) + 1
        data = rand_bytes(int(offs[-1] + lens[-1]) + 1)
        blocks = (lens + 3) // 4 // 8 + 1
        compare(key, lambda: p2.sponge_hash_rows(data, offs, lens),
                lambda: p2.sponge_hash_rows_plain(data, offs, lens), 20,
                results, plain_iters=1,
                n_bytes=int(lens.sum()) + lens.size * (24 + 64),
                n_ops=int(blocks.sum()) * stats["p2_instructions"]["one"])
        longest, most = int(np.argmax(lens)), int(blocks.max())
        row = offs[longest:longest + 1]
        longest_ms = sponge_alone(data, row, lens[longest:longest + 1], 50)
        one_ms = sponge_alone(data, row, np.array([16]), 50)
        latency = (longest_ms - one_ms) / (most - 1)
        results[key].update(
            shape=f"{lens.size:,} rows, {int(blocks.sum()):,} blocks, the "
                  f"longest {most}",
            longest_row_alone_ms=longest_ms, one_block_row_alone_ms=one_ms,
            permutation_latency_ms=latency, latency_floor_ms=most * latency)
        alone[key] = device_ms(
            lambda: p2.sponge_hash_rows(data, offs, lens), 20)
        del data
    # Each kernel alone on the device (torch.profiler), beside its wrapper.
    for name, symbol in (
            ("sha256_blocks", "sha256_kernel"),
            ("keccak_absorb", "keccak_kernel"),
            ("b3_rows", "b3_rows_kernel"),
            ("b3_rows [4096 x 3000]", "b3_rows_kernel"),
            ("b3_compress", "b3_compress_kernel"),
            ("p2_sponge_bytes", "sponge_bytes_kernel"),
            ("p2_sponge_bytes [4096 x 3000]", "sponge_bytes_kernel")):
        r = results[name]
        r["kernel_alone_ms"] = sum(v for k, v in alone[name].items()
                                   if symbol in k)
        r["device_ms_all"] = alone[name]["all"]
        bound = max(r["bound_ms"], r.get("latency_floor_ms", 0.0))
        log(f"{name}: the kernel alone {r['kernel_alone_ms']:.4f} ms on the "
            f"device ({100 * bound / r['kernel_alone_ms']:.1f}% of its "
            f"bound {bound:.4f} ms), every kernel of the call "
            f"{r['device_ms_all']:.4f} ms, the wrapper {r['ms']:.4f} ms"
            + (f"; {r['bound_by']} {r['bound_ms']:.4f} ms, latency floor "
               f"{r['latency_floor_ms']:.4f} ms "
               f"({r['permutation_latency_ms']:.6f} ms a permutation: the "
               f"longest row alone "
               f"{r['longest_row_alone_ms']:.4f} ms, a one-block row "
               f"{r['one_block_row_alone_ms']:.4f} ms)"
               if "latency_floor_ms" in r else ""))
    # Known answers: the reference tests' vectors against hashlib and the
    # host oracles, Keccak("abc"), and single compressions against their
    # plain versions from given states.
    pat = [bytes(i % 251 for i in range(k))
           for k in (0, 3, 55, 56, 63, 64, 65, 135, 136, 137, 200, 300, 1023,
                     1024, 1025, 1280, 3000)]
    if sha256.digests_to_bytes(sha256.sha256_many(pat, "cuda")) != [
            hashlib.sha256(x).digest() for x in pat] \
            or keccak.keccak256_many(pat, "cuda") != [
                keccak256_digest(x) for x in pat] \
            or blake3.blake3_many(pat, "cuda") != [
                blake3_digest(x) for x in pat] \
            or keccak.keccak256_many([b"abc"], "cuda")[0].hex() != (
                "4e03657aea45a94fc7d47ba826c8d667"
                "c0d1e6e33a64a036ec44f58fa12d6c45"):
        raise AssertionError("a hash kernel misses a known answer")
    st = torch.randint(-(1 << 62), 1 << 62, (64, 25), generator=gen,
                       device="cuda") * 2 + 1
    equal("keccak_absorb, keccak_f1600_batch", keccak.keccak_f1600_batch(st),
          keccak.keccak_f_plain(st))
    cv = torch.randint(0, 1 << 32, (64, 24), generator=gen, device="cuda")
    small = [torch.randint(0, 1 << 32, (64,), generator=gen, device="cuda")
             for _ in range(4)]
    equal("b3_compress from given chaining values",
          blake3.b3_compress_batch(cv[:, :8], cv[:, 8:], *small),
          blake3.b3_compress_plain(cv[:, :8], cv[:, 8:], *small))
    log("crypto known answers: hashlib, the host oracles and Keccak('abc') "
        "on 17 lengths from 0 to 3,000 bytes")
    torch.cuda.empty_cache()

    # (b) The program on the reference benchmark's interpreter shape.
    program = crypto_lanes_program()
    interp = TpuInterpreter(program, InterpConfig(
        lanes=lanes, chunk=512, low_bytes=1 << 13, stack_bytes=1 << 12,
        max_inputs=tapes.shape[1]), device="cuda")
    lists = tapes.tolist()
    rounds = []
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    with service_rounds(rounds):
        result = interp.run(lists)
    run_s = time.perf_counter() - t0
    launches = {k: v for k, v in _kernels.launches.items() if v}
    for i, r in enumerate(rounds):
        log(f"crypto service round {i}: {r['lanes']} lanes in "
            f"{r['s']:.4f} s, launches {r['launches']}")
    # Each round services lanes of every kind: one launch of each hash
    # kernel, and nothing of the replaced paths.
    for r in rounds:
        if any(r["launches"].get(k) != 1 for k in CRYPTO_KERNELS) \
                or r["launches"].get("p2_permute") \
                or r["launches"].get("b3_compress"):
            raise AssertionError(f"a service round launched {r}")
    if set(result["halted"].tolist()) != {HALT_EXIT}:
        raise AssertionError("the crypto lanes did not all exit")
    t1, want, t2 = expected.result()
    host.shutdown()
    host_s = t2 - t1
    got = np.asarray(result["outputs"], dtype=np.uint64)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = np.nonzero((got != want).any(1))[0] if got.shape == want.shape \
            else "shape"
        raise AssertionError(f"crypto outputs differ from the host's: {bad}")
    for lane in range(8):
        vm = VM(program, lists[lane], VMConfig())
        same_as_oracle(f"crypto lane {lane}", result, None, vm, vm.run(),
                       lane)
    stats.update(run_s=run_s, host_check_s=host_s, rounds=rounds,
                 launches=launches, lanes=lanes)
    phase_s = time.perf_counter() - t_phase
    log(f"crypto: {lanes} lanes x 4 hashes in {run_s:.3f} s of "
        f"TpuInterpreter.run ({sum(r['s'] for r in rounds):.4f} s in "
        f"{len(rounds)} service rounds), outputs equal to the host's "
        f"({host_s:.1f} s) and 8 lanes to the oracle VM; launches "
        f"{launches}; phase {phase_s:.1f} s")
    if phase_s > 90:
        raise AssertionError(f"the crypto phase took {phase_s:.1f} s of its "
                             "90 s")
    return stats


# ============================================================================
# The mesh phase: zkir_tpu_torch.parallel on the card
# ============================================================================

MESH_BUDGET_S = 90
MESH_GLOO_RANKS = 4


def _mesh_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One gloo rank of (b), on ``cuda:0`` with the others: the entry
    points at (b)'s shapes, each gathered and held against the
    single-device port; its launch counts and plain-version calls saved
    for the parent.  A difference raises, and the rank fails."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from zkir_tpu_torch import parallel as par
    from zkir_tpu_torch.tools import mesh_bench as mb

    par.join_local_group(port, rank, world, "gloo",
                         timeout=datetime.timedelta(seconds=60))
    try:
        mesh = par.make_mesh(world, device="cuda", backend="gloo")
        calls, single = mb.setup(mesh, mb.SHAPES["gloo"])
        with plain_calls() as plain:
            out, launches = mb.run_counted(calls, True)
        wholes = {name: mb.whole(name, out.pop(name), mesh)
                  for name in mb.ENTRY_POINTS}
        for name, got in wholes.items():
            max_abs_err(f"gloo rank {rank} {name}", got,
                        mb.as_tuple(name, single[name]()))
        torch.save({"launches": launches, "plain_calls": plain,
                    "device": str(mesh.device)},
                   pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def mesh_bounds(shape: dict, ins: dict, instr: int) -> dict:
    """Each entry point's bound at ``shape``: the function's inputs read
    once and outputs written once, or its operations (the NTTs'
    butterflies and products by this build's SASS, a permutation per
    sponge block and tree node, the interpreter's floor a cycle)."""
    log_ntt, (c, log_lde) = shape["log_ntt"], shape["lde"]
    n = 1 << log_lde
    rows, w = shape["merkle"]
    lanes, log_n = shape["lanes"], shape["log_step"]
    perm = P2_INSTR_PER_PERMUTATION
    ntt_bound = bound(8 * 4 * (1 << log_ntt), ntt_ops(ins, 1, log_ntt))
    return {
        "dist_ntt": ntt_bound, "dist_ntt_natural": ntt_bound,
        "dist_lde": bound(8 * c * (n + 2 * 4 * n),
                          ntt_ops(ins, c, log_lde)
                          + ntt_ops(ins, c, log_lde + 2, first=2,
                                    products=n)),
        "dist_merkle_root": bound(8 * (rows * w + 8),
                                  perm * (rows * (w // 8 + 1) + rows - 1)),
        "prove_step_sharded": bound(
            2 * lanes * 16 * 12 + 8 * 8,
            instr * 512 * lanes + ntt_ops(ins, 1, log_n)
            + perm * (2 * (1 << log_n) - 1)),
    }


def phase_mesh(results, floor=None) -> dict:
    """``zkir_tpu_torch.parallel`` on the card, through
    ``tools/mesh_bench.py``'s cases.  (a) A world of one NCCL rank at full
    width: ``dist_ntt`` and ``dist_ntt_natural`` of one CM31 column of
    2^24 against ``cm31_ntt``, ``dist_lde`` of the main path's 596
    columns [596, 2^16] -> 2^18 against ``lde``, ``dist_merkle_root`` of
    its committed rows [2^18, 1192] against ``p2_sponge_rows`` +
    ``p2_merkle_tree``, and ``prove_step_sharded`` at the reference
    benchmark's interpreter shape (loop program, 65,536 lanes, chunk 512,
    log_n 24) against the same composition on one device: word for word,
    each run with the launch counts set to 0 just before and read just
    after (its kernels and no other, no plain version on a card tensor),
    then timed by CUDA events beside the single-device time and the
    bound, with each kernel's device time (``torch.profiler``) for the
    NTTs and the step.  (b) 4 gloo ranks that all use ``cuda:0``,
    spawned here, at smaller shapes (2^20; [64, 2^16]; [2^16, 64]; 8,192
    lanes, log_n 16): every rank's results, gathered, equal to the
    single-device port's, every rank's launches checked.  (b)'s seconds
    are a correctness run's, not a scaling figure.  At most
    ``MESH_BUDGET_S`` seconds."""
    import datetime

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch import parallel as par
    from zkir_tpu_torch.tools import mesh_bench as mb
    from zkir_tpu_torch.tools.sass_count import ntt_instructions

    t_phase = time.perf_counter()
    ins = results.get("ntt_instructions") or ntt_instructions(
        _kernels._nvcc(), _kernels.CSRC, _kernels.BUILD / "sass_probe")
    instr = (floor or interp_floor())["thread"]["bound_instr"]
    shape = mb.SHAPES["full"]
    bounds = mesh_bounds(shape, ins, instr)
    shapes = {"dist_ntt": "[2^24]", "dist_ntt_natural": "[2^24]",
              "dist_lde": "[596, 2^16] -> 2^18",
              "dist_merkle_root": "[2^18, 1192]",
              "prove_step_sharded": "65536 lanes x 512, log_n 24"}

    # (a) A world of one NCCL rank, at full width.
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = par.make_mesh(1)
        calls, single = mb.setup(mesh, shape)
        t0 = time.perf_counter()
        with plain_calls() as plain:
            out, launches = mb.run_counted(calls, True)
        first_s = time.perf_counter() - t0
        if plain:
            raise AssertionError(f"the mesh path ran plain versions on card "
                                 f"tensors: {sorted(set(plain))}")
        if mb.launch_problems(launches, 1):
            raise AssertionError(f"mesh launches: "
                                 f"{mb.launch_problems(launches, 1)}")
        if bool((out["prove_step_sharded"][0].cycles != 512).any()):
            raise AssertionError("prove_step_sharded: the lanes did not all "
                                 "run 512 cycles")
        for name in mb.ENTRY_POINTS:
            err = max_abs_err(f"mesh {name}",
                              mb.whole(name, out.pop(name), mesh),
                              mb.as_tuple(name, single[name]()))
            iters = 3 if name in ("dist_merkle_root",
                                  "prove_step_sharded") else 5
            ms = cuda_ms(calls[name], iters)
            single_ms = cuda_ms(single[name], iters)
            key = f"mesh {name} {shapes[name]}"
            results[key] = {"max_abs_err": err, "ms": ms,
                            "single_ms": single_ms, **bounds[name],
                            "launches": launches[name]}
            if name in ("dist_ntt_natural", "prove_step_sharded"):
                # Where the time goes: each kernel's device time, the
                # copies and NCCL's among them, on both paths.
                results[key]["device_ms"] = device_ms(calls[name], 3)
                results[key]["single_device_ms"] = device_ms(single[name], 3)
            log(f"{key}: exact against one device; {ms:.4f} ms on a mesh "
                f"of one NCCL rank, {single_ms:.4f} ms on one device, "
                f"bound {bounds[name]['bound_ms']:.4f} ms by "
                f"{bounds[name]['bound_by']}; launches {launches[name]}")
        del calls, single, out
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    path = {}
    for counts in launches.values():
        for kname, v in counts.items():
            path[kname] = path.get(kname, 0) + v
    stats = {"nccl_first_run_s": first_s, "launches": path}

    # (b) 4 gloo ranks sharing cuda:0, spawned here.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        store = par.rendezvous_store()   # held until the ranks end
        ctx = mp.start_processes(
            _mesh_rank, args=(MESH_GLOO_RANKS, store.port, tmp),
            nprocs=MESH_GLOO_RANKS, join=False, start_method="spawn")
        deadline = t_phase + MESH_BUDGET_S
        try:
            while not ctx.join(timeout=max(1.0,
                                           deadline - time.perf_counter())):
                if time.perf_counter() > deadline:
                    raise AssertionError("the gloo ranks did not finish in "
                                         "the phase's budget")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [torch.load(pathlib.Path(tmp) / f"rank{r}.pt",
                            weights_only=False)
                 for r in range(MESH_GLOO_RANKS)]
    gloo_s = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        problems = mb.launch_problems(got["launches"], MESH_GLOO_RANKS)
        if got["plain_calls"] or got["device"] != "cuda:0" or problems:
            raise AssertionError(f"gloo rank {r} on {got['device']}: plain "
                                 f"versions {got['plain_calls']}, launches "
                                 f"{problems}")
    stats.update(gloo_ranks=MESH_GLOO_RANKS, gloo_correctness_run_s=gloo_s,
                 gloo_launches=[g["launches"] for g in ranks])
    phase_s = time.perf_counter() - t_phase
    log(f"mesh (b): {MESH_GLOO_RANKS} gloo ranks on cuda:0, every result "
        f"equal to one device's, each rank's launches as expected "
        f"({gloo_s:.1f} s, a correctness run); phase {phase_s:.1f} s")
    if phase_s > MESH_BUDGET_S:
        raise AssertionError(f"the mesh phase took {phase_s:.1f} s of its "
                             f"{MESH_BUDGET_S} s")
    return stats


def deferred_program():
    """ADD, SUB and ADDI chains that take the deferred-carry model into its
    corners: tape values read into a register that ADDI marks accumulated,
    registers that double until a limb reaches 2^30 (the overflow path
    normalizes both sources and writes them back), SUB wrapping its limbs,
    ADDI of a negative immediate, observation points with rs1 == rs2 and
    with R0, the raw accumulated words written out; then EXIT."""
    from zkir_tpu_torch.spec import Instruction as I, Op, Program

    ins = [
        I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),        # READ -> r10
        I(Op.ADDI, rd=2, rs1=10, imm=0),
        I(Op.ADDI, rd=10, rs1=0, imm=1), I(Op.ECALL),        # READ -> r10
        I(Op.ADD, rd=6, rs1=10, rs2=0),
        I(Op.ADDI, rd=14, rs1=0, imm=24),
    ]
    loop = [
        I(Op.ADD, rd=2, rs1=2, rs2=2),
        I(Op.ADD, rd=6, rs1=6, rs2=2),
        I(Op.SUB, rd=3, rs1=3, rs2=6),
        I(Op.ADDI, rd=4, rs1=4, imm=-3),
        I(Op.ADDI, rd=14, rs1=14, imm=-1),
    ]
    loop.append(I(Op.BNE, rs1=14, rs2=0, imm=-4 * len(loop)))
    tail = [
        I(Op.XOR, rd=7, rs1=2, rs2=3),
        I(Op.SLT, rd=8, rs1=6, rs2=6),
        I(Op.AND, rd=9, rs1=4, rs2=4),
        I(Op.SRAI, rd=12, rs1=3, imm=5),
        I(Op.SLTU, rd=13, rs1=0, rs2=3),
        I(Op.ADD, rd=11, rs1=7, rs2=12),
        I(Op.ADDI, rd=10, rs1=0, imm=2), I(Op.ECALL),        # WRITE r11
        I(Op.ADD, rd=11, rs1=2, rs2=4), I(Op.ECALL),          # WRITE r11
        I(Op.ANDI, rd=11, rs1=6, imm=0xFF),
        I(Op.ADDI, rd=10, rs1=0, imm=0), I(Op.ECALL),        # EXIT
    ]
    return Program.from_instructions(ins + loop + tail)


def oracle_events(result) -> list:
    """The oracle's normalization witnesses as tuples (cycle, register,
    accumulated limbs, normalized limbs, carries)."""
    return [(e.witness.cycle, e.witness.register,
             *e.witness.accumulated_limbs, *e.witness.normalized_limbs,
             *e.witness.carries) for e in result.normalization_witnesses]


def trace_events(trace, lane=0) -> list:
    """``oracle_events`` of an interpreter trace's ``norm_*`` columns."""
    import numpy as np

    keys = ("cycle", "norm_reg", "norm_acc0", "norm_acc1", "norm_n0",
            "norm_n1", "norm_c0", "norm_c1")
    rows = np.nonzero(trace["norm_valid"][:, lane])[0]
    return list(zip(*(map(int, trace[k][rows, lane]) for k in keys)))


def same_as_oracle(name, result, trace, vm, oracle, lane=0) -> None:
    """A lane of an interpreter run equal to the oracle VM's run of the
    same program: cycles, halt, exit code, outputs, final registers and
    bounds; with a trace, every row's cycle, pc, word, pre-state registers,
    bounds and accumulated registers, and the normalization witnesses."""
    import numpy as np

    from zkir_tpu_torch.interp import HALT_EBREAK, HALT_EXIT
    from zkir_tpu_torch.runtime import HaltReason

    halt = {HaltReason.EBREAK: HALT_EBREAK, HaltReason.EXIT: HALT_EXIT}
    want = {"cycles": oracle.cycles,
            "halted": halt[oracle.halt_reason.reason],
            "outputs": oracle.outputs,
            "regs": vm.state.regs,
            "bound_bits": [b.max_bits for b in vm.state.bounds]}
    got = {"cycles": int(result["cycles"][lane]),
           "halted": int(result["halted"][lane]),
           "outputs": [int(v) for v in result["outputs"][lane]],
           "regs": [int(v) for v in result["regs"][lane]],
           "bound_bits": [int(v) for v in result["bound_bits"][lane]]}
    if oracle.halt_reason.reason == HaltReason.EXIT:
        want["exit"] = oracle.halt_reason.code
        got["exit"] = int(result["exit_code"][lane])
    if got != want:
        raise AssertionError(f"{name}: {got} != the oracle's {want}")
    if trace is None:
        return
    rows = oracle.execution_trace
    valid = np.nonzero(trace["valid"][:, lane])[0]
    if len(valid) != len(rows):
        raise AssertionError(f"{name}: {len(valid)} trace rows, the oracle "
                             f"{len(rows)}")
    cols = {"cycle": [r.cycle for r in rows], "pc": [r.pc for r in rows],
            "word": [r.instruction for r in rows],
            "regs": [r.registers for r in rows],
            "bounds": [[b.max_bits for b in r.bounds] for r in rows]}
    if "accum_mask" in trace:
        cols["accum_mask"] = [sum(int(v) << k for k, v in enumerate(
            r.register_states)) for r in rows]
    for key, want_col in cols.items():
        got_col = trace[key][valid, lane]
        if not np.array_equal(got_col.astype(np.uint64),
                              np.asarray(want_col, dtype=np.uint64)):
            raise AssertionError(f"{name}: trace[{key!r}] differs from the "
                                 "oracle's rows")
    if "norm_valid" in trace and trace_events(trace, lane) \
            != oracle_events(oracle):
        raise AssertionError(f"{name}: the normalization witnesses differ "
                             "from the oracle's")


def phase_deferred(results, main_path, floor=None, log_rows=16,
                   seeds=range(64), oracle_log_rows=15) -> dict:
    """The deferred-carry model (``InterpConfig(deferred=True)``): (a) K3
    against its plain version on the fuzz programs (two lanes, a warp
    each) and on ``deferred_program`` (2 and 2,048 lanes, a warp or a
    thread each; lanes also against the oracle VM); (b) the one-lane
    ``exact_trace_program(oracle_log_rows)`` run against the port's
    oracle VM with the deferred model, the execution trace and range
    checks on, and the plain run of half as many cycles against the
    oracle without the deferred model (the oracle's cycles per second on
    this host; 2^15, not the path's 2^16: the oracle's trace scans its
    whole memory log every cycle, as the reference's does, so a run's
    time grows with the square of its cycles, 84 s deferred and 125 s
    plain at 2^16 on the H100 machine's host); (c) the deferred trace's
    matrix equal to the main path's, interpreted and proved with its
    program bound (launch counts set to 0 just before, read just after),
    the proof equal to the main path's and verified; (d) the 2^16
    ``interp_run`` launch with and without the deferred model, timed in
    turns beside the bound (``floor``: ``interp_floor()``'s, made here if
    not given), after one lane x 256 cycles against the plain version."""
    import numpy as np
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.interp import (InterpConfig, TpuInterpreter,
                                       interp_run)
    from zkir_tpu_torch.interp import columnar
    from zkir_tpu_torch.prover import (FriConfig, prove_trace,
                                       trace_to_matrix, verify_trace)
    from zkir_tpu_torch.prover.benchtrace import exact_trace_program
    from zkir_tpu_torch.runtime import VM, VMConfig
    from zkir_tpu_torch.tools.fuzz_programs import generate_program

    stats = {"floor": floor or interp_floor()}
    small = dict(low_bytes=1 << 15, stack_bytes=1 << 12, collect_trace=True,
                 deferred=True)

    # (a) the fuzz programs on two lanes with different tapes, and the
    # deferred model's corners on few and on many lanes.
    t0 = time.perf_counter()
    cycles = 0
    for seed in seeds:
        program, inputs = generate_program(seed)
        interp = TpuInterpreter(program, InterpConfig(
            lanes=2, chunk=64, **small), device="cuda")
        cycles += interp_both(f"deferred fuzz seed {seed}", interp,
                              [inputs, [x ^ 0x5A5A for x in inputs[::-1]]])[0]
    log(f"deferred: interp_chunk, interp_run exact on {len(seeds)} fuzz "
        f"programs x 2 lanes ({cycles} cycles, "
        f"{time.perf_counter() - t0:.1f} s)")
    rng = np.random.default_rng(SEED)
    program = deferred_program()
    for lanes in (2, 2048):
        tapes = [[int(v) for v in rng.integers(0, 1 << 40, size=2)]
                 for _ in range(lanes)]
        interp = TpuInterpreter(program, InterpConfig(
            lanes=lanes, chunk=16, **small), device="cuda")
        n, result, _ = interp_both(f"deferred corners, {lanes} lanes", interp,
                                   tapes)
        for lane in range(2):
            vm = VM(program, tapes[lane], VMConfig(
                enable_deferred_model=True, enable_execution_trace=True))
            same_as_oracle(f"deferred corners, lane {lane} of {lanes}",
                           result, result["trace"], vm, vm.run(), lane)
        log(f"deferred: interp_chunk, interp_run exact on the corners "
            f"program, {lanes} lanes ({n} cycles, "
            f"{'warp' if columnar.warp_layout(lanes, True) else 'thread'} "
            f"layout), lanes 0 and 1 equal to the oracle VM")
    stats["fuzz_and_corners_s"] = time.perf_counter() - t0

    # (b) the one-lane run against the port's oracle VM.
    for deferred, log_n in ((True, oracle_log_rows),
                            (False, oracle_log_rows - 1)):
        rows = 1 << log_n
        program = exact_trace_program(log_n)
        t0 = time.perf_counter()
        result = TpuInterpreter(program, InterpConfig(
            lanes=1, chunk=1024, collect_trace=True, deferred=deferred),
            device="cuda").run([[]], max_cycles=2 * rows)
        run_s = time.perf_counter() - t0
        vm = VM(program, [], VMConfig(
            max_cycles=2 * rows, enable_deferred_model=deferred,
            enable_execution_trace=True, enable_range_checking=True))
        t0 = time.perf_counter()
        oracle = vm.run()
        oracle_s = time.perf_counter() - t0
        name = f"2^{log_n} {'deferred ' if deferred else ''}run"
        same_as_oracle(name, result, result["trace"], vm, oracle)
        key = "deferred" if deferred else "plain"
        stats[f"oracle_{key}"] = {
            "cycles": oracle.cycles, "seconds": oracle_s,
            "cycles_per_s": oracle.cycles / oracle_s,
            "normalization_witnesses": len(oracle.normalization_witnesses),
            "range_check_witnesses": len(oracle.range_check_witnesses),
            "interp_run_s": run_s}
        log(f"deferred: {name} on the card equal to the oracle VM ("
            f"{oracle.cycles} cycles, {len(oracle.normalization_witnesses)} "
            f"normalization witnesses); the oracle {oracle_s:.2f} s, "
            f"{oracle.cycles / oracle_s:.0f} cycles/s on this host")

    # (c) the deferred path from program to proof, as a user drives it.
    rows = 1 << log_rows
    program = exact_trace_program(log_rows)

    def interpret(deferred=True):
        trace = TpuInterpreter(program, InterpConfig(
            lanes=1, chunk=1024, collect_trace=True, deferred=deferred),
            device="cuda").run([[]], max_cycles=2 * rows)["trace"]
        return trace_to_matrix(trace, program=program)

    made = {}

    def interpret_and_prove():
        matrix = made["matrix"] = interpret()
        if main_path is not None and not np.array_equal(
                matrix, main_path["matrix"]):
            raise AssertionError("the deferred trace's matrix differs from "
                                 "the main path's")
        return prove_trace(matrix, FriConfig(), range_lookup=True,
                           program=program, device="cuda")

    if main_path is not None:
        proof, path_s, launches = counted(interpret_and_prove,
                                          MAIN_PATH_KERNELS)
        warm, warm_s, stages, peak = logged_prove(lambda: prove_trace(
            made["matrix"], FriConfig(), range_lookup=True, program=program,
            device="cuda"))
        if proof != main_path["proof"] or warm != proof:
            raise AssertionError("the deferred trace proves to another proof "
                                 "than the main path's")
        if not verify_trace(proof, program, device="cuda"):
            raise AssertionError("the port's verifier rejects the deferred "
                                 "path's proof")
        stats["path"] = {"seconds": path_s, "launches": launches,
                         "prove_warm_s": warm_s, "peak_bytes": peak,
                         "stages_warm_s": stages}
        log(f"deferred: the 2^{log_rows} path (interpret, matrix, prove with "
            f"the program bound) in {path_s:.3f} s, the warm prove "
            f"{warm_s:.3f} s, peak device memory {peak / 2**30:.3f} GiB: "
            f"matrix and proof equal to the main path's, verified; launches "
            f"{launches}")
        del proof, warm
    elif not np.array_equal(interpret(), interpret(deferred=False)):
        raise AssertionError("the deferred trace's matrix differs from the "
                             "plain one")

    # (d) one lane x 256 cycles against the plain version (some 2 s a
    # run), then the 2^16 launch alone, deferred and plain in turns.
    interp = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=256, collect_trace=True, deferred=True),
        device="cuda")

    def segment(run, **kw):
        state = interp.init_state([[]])
        at = torch.zeros(1, dtype=torch.int32, device="cuda")
        trace = columnar._new_trace(256, 1, "cuda", deferred=True)
        state = run(interp.code, interp.n_words, state, at, 0, 1,
                    interp.config, trace, **kw)
        return interp_flat(state, trace, valid_only=False) + (at,)

    state_bytes = sum(t.numel() * t.element_size()
                      for t in interp.init_state([[]]))
    compare("interp_run deferred", lambda: segment(
        interp_run, decoded=interp.decoded),
        lambda: segment(columnar.interp_run_plain), 20, results,
        plain_iters=1, key="interp_run deferred [1 lane x 256]",
        bounds=interp_bound(
            2 * state_bytes + columnar.DEFERRED_ROW_BYTES * 256, 256, 1,
            stats["floor"]["warp_deferred"]["floor"]))
    times = {True: [], False: []}
    for deferred in (False, True, True, False) * 3:
        interp = TpuInterpreter(program, InterpConfig(
            lanes=1, chunk=1024, collect_trace=True, deferred=deferred),
            device="cuda")
        state = interp.init_state([[]])
        at = torch.zeros(1, dtype=torch.int32, device="cuda")
        trace = columnar._new_trace(rows, 1, "cuda", deferred)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        interp_run(interp.code, interp.n_words, state, at, 0, rows // 1024,
                   interp.config, trace, decoded=interp.decoded)
        end.record()
        torch.cuda.synchronize()
        if int(state.cycles[0]) != rows:
            raise AssertionError(f"the 2^{log_rows} run ran "
                                 f"{int(state.cycles[0])} cycles")
        times[deferred].append(start.elapsed_time(end))
    # The bound: each build's own floor at one instruction a clock.
    for deferred, floor_key, row_bytes in (
            (True, "warp_deferred", columnar.DEFERRED_ROW_BYTES),
            (False, "warp", columnar.TRACE_ROW_BYTES)):
        ms = times[deferred][1:]              # the first a warm-up
        b = interp_bound(2 * state_bytes + row_bytes * rows, rows, 1,
                         stats["floor"][floor_key]["floor"])
        key = "deferred" if deferred else "plain"
        stats[f"interp_run_2e{log_rows}_{key}"] = {
            "ms": sum(ms) / len(ms), "ms_min": min(ms), "ms_max": max(ms),
            **b, "instr_per_cycle": stats["floor"][floor_key]["floor"]}
        log(f"deferred: interp_run, the 2^{log_rows} run with a trace, "
            f"{key}: {sum(ms) / len(ms):.4f} ms ({min(ms):.4f}-{max(ms):.4f}) "
            f"the launch alone, bound {b['bound_ms']:.4f} ms by "
            f"{b['bound_by']} ({stats['floor'][floor_key]['floor']} "
            f"instructions a cycle)")
    return stats


def run_cli(workdir, *args, expect=0, env=None):
    """``python3 -m zkir_tpu_torch *args`` in ``workdir``, with ``env``
    added to the environment: (stdout, stderr, seconds); fails on another
    exit code than ``expect``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), ZKIR_PROVE_LOG="1",
               **(env or {}))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "zkir_tpu_torch", *args],
                         cwd=workdir, env=env, capture_output=True,
                         text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if res.returncode != expect:
        raise AssertionError(f"zkir_tpu_torch {' '.join(args)}: exit "
                             f"{res.returncode}, expected {expect}\n"
                             f"{res.stdout}\n{res.stderr}")
    return res.stdout, res.stderr, seconds


def phase_cli() -> dict:
    """The CLI as a user runs it, each command a fresh process."""
    fib = str(ROOT / "examples" / "fibonacci.zkasm")
    other = str(FIXTURES / "golden_e.program.zkir")
    stats = {}

    def same(path, golden):
        want = json.loads((FIXTURES / f"{golden}.proof.json").read_text())
        if json.loads(pathlib.Path(path).read_text()) != want:
            raise AssertionError(f"{path} differs from {golden}")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        out, _, _ = run_cli(tmp, "asm", fib, "-o", "fib.zkir")
        if "assembled" not in out or not (tmp / "fib.zkir").exists():
            raise AssertionError(f"asm: {out}")
        out, _, _ = run_cli(tmp, "disasm", "fib.zkir")
        if "ecall" not in out:
            raise AssertionError(f"disasm: {out}")
        # run: the gpu engine (the default on the card) and the native
        # one; at a cycle limit the native engine prints the reference's
        # line and exits 1, the gpu engine stops between chunks (the
        # reference's tpu engine does the same); the host engine with an
        # explicit --device cuda is refused.
        for engine in ("native", "gpu"):
            out, _, stats[f"cli_run_{engine}_s"] = run_cli(
                tmp, "run", "fib.zkir", "--input", "10", "--engine", engine)
            if out.strip() != "halt=2 cycles=62 exit=0 outputs=[55]":
                raise AssertionError(f"run --engine {engine}: {out}")
        for engine, line, code in (
                ("native", "halt=3 cycles=5 exit=0 outputs=[]", 1),
                ("gpu", "halt=2 cycles=62 exit=0 outputs=[55]", 0),
                (None, "halt=2 cycles=62 exit=0 outputs=[55]", 0)):
            flags = ("--engine", engine) if engine else ()
            out, _, _ = run_cli(tmp, "run", "fib.zkir", "--input", "10",
                                "--max-cycles", "5", *flags, expect=code)
            if out.strip() != line:
                raise AssertionError(f"run --max-cycles 5 --engine {engine}: "
                                     f"{out}")
        _, err, _ = run_cli(tmp, "--device", "cuda", "run", "fib.zkir",
                            "--engine", "native", expect=1)
        if "runs on the host" not in err:
            raise AssertionError(f"--device cuda run --engine native: {err}")
        # The oracle engine: the reference's line (the halt by name) and
        # exit code 0, the native engine's cycles, exit code and outputs.
        native = run_cli(tmp, "run", "fib.zkir", "--input", "10",
                         "--engine", "native")[0].split()
        for limit, line in ((None, "halt=exit cycles=62 exit=0 outputs=[55]"),
                            ("5", "halt=cycle_limit cycles=5 exit=0 "
                                  "outputs=[]")):
            flags = ("--max-cycles", limit) if limit else ()
            out, _, t = run_cli(tmp, "run", "fib.zkir", "--input", "10",
                                "--engine", "oracle", *flags)
            if out.strip() != line or (
                    limit is None and out.split()[1:] != native[1:]):
                raise AssertionError(f"run --engine oracle {flags}: {out}")
            stats.setdefault("cli_run_oracle_s", t)
        _, err, _ = run_cli(tmp, "--device", "cuda", "run", "fib.zkir",
                            "--engine", "oracle", expect=1)
        if "runs on the host" not in err:
            raise AssertionError(f"--device cuda run --engine oracle: {err}")
        out, _, stats["cli_prove_bind_s"] = run_cli(
            tmp, "prove", fib, "--input", "10", "--bind", "-o", "d.json")
        if out.strip() != "proved 62 trace rows (62 cycles) -> d.json":
            raise AssertionError(f"prove --bind: {out}")
        same(tmp / "d.json", "golden_d")
        out, _, stats["cli_verify_s"] = run_cli(tmp, "verify", "d.json",
                                                "--binary", "fib.zkir")
        if out.strip() != "VALID":
            raise AssertionError(f"verify: {out}")
        out, _, _ = run_cli(tmp, "verify", "d.json", "--binary", other,
                            expect=1)
        if out.strip() != "INVALID":
            raise AssertionError(f"verify with another program: {out}")
        out, _, _ = run_cli(tmp, "verify", "d.json", expect=1)
        if "requires the public program" not in out:
            raise AssertionError(f"verify without --binary: {out}")
        _, _, stats["cli_prove_s"] = run_cli(tmp, "prove", "fib.zkir",
                                             "--input", "10", "-o", "a.json")
        same(tmp / "a.json", "golden_a")
        out, _, stats["cli_prove_streaming_bind_s"] = run_cli(
            tmp, "prove", fib, "--input", "10", "--streaming", "--bind",
            "-o", "ds.json")
        if out.strip() != "proved 62 trace rows (62 cycles) -> ds.json":
            raise AssertionError(f"prove --streaming --bind: {out}")
        same(tmp / "ds.json", "golden_d")
        _, err, _ = run_cli(tmp, "prove", fib, "--input", "10", "--streaming",
                            "--checkpoint-dir", "sck", expect=1)
        if "writes no stage checkpoints" not in err or (tmp / "sck").exists():
            raise AssertionError(f"prove --streaming --checkpoint-dir: {err}")
        log("CLI: asm, disasm, run (native, oracle and gpu engines, with "
            "and without a cycle limit, gpu the default, the host engines "
            "refused with --device cuda), prove (goldens D and A "
            "reproduced; golden D also by --streaming --bind, and "
            "--streaming refusing "
            "--checkpoint-dir), verify VALID / INVALID with another "
            "program")

        # A checkpointed prove, resumed after its last stage was lost.
        ck = ["prove", fib, "--input", "10", "--bind", "--checkpoint-dir",
              "ck", "-o"]
        _, err, _ = run_cli(tmp, *ck, "ck1.json")
        if "resumed" in err:
            raise AssertionError("a first checkpointed prove resumed")
        stages = sorted(f.name.split(".")[-2] for f in (tmp / "ck").iterdir())
        if stages != ["commit", "fri", "quotient", "sums"]:
            raise AssertionError(f"checkpoint stages {stages}")
        next((tmp / "ck").glob("*.fri.pkl")).unlink()
        _, err, stats["cli_prove_resumed_s"] = run_cli(tmp, *ck, "ck2.json")
        resumed = re.findall(r"stage (\w+) resumed", err)
        if resumed != ["commit", "sums", "quotient"]:
            raise AssertionError(f"the second prove resumed {resumed}")
        same(tmp / "ck1.json", "golden_d")
        same(tmp / "ck2.json", "golden_d")
        log(f"CLI: prove --checkpoint-dir resumed {resumed} and gave the "
            "unbroken proof")
    log(f"CLI seconds, fresh processes: {stats}")
    return stats


def phase_quotient_build() -> dict:
    """Generate and build the quotient's kernels for its plans (three
    feature sets on the whole LDE domain, two on one coset) from an empty
    build directory (every part at once, one nvcc each), then time their
    load in a fresh process with the libraries built; each part's stages,
    global column reads a
    point (the staging plan's copies and the 1/Z rows), shared memory,
    registers, spills (``-Xptxas -v``) and SASS instructions
    (``tools/sass_count.py``); and each helper's instructions, which the
    operation bound counts."""
    import shutil

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.prover import quotient_codegen as qc
    from zkir_tpu_torch.tools.sass_count import (helper_instructions,
                                                 instructions)

    keys = list(QUOTIENT_PLANS.values())
    shutil.rmtree(qc.build_dir(), ignore_errors=True)
    t0 = time.perf_counter()
    qc.prepare(*keys)
    cold = time.perf_counter() - t0
    code = ("import json, sys, time; sys.path.insert(0, sys.argv[1]); "
            "from zkir_tpu_torch.prover import quotient_codegen as qc; "
            "t0 = time.perf_counter(); qc.prepare(*json.loads(sys.argv[2])); "
            "print(time.perf_counter() - t0, qc.compiles)")
    res = subprocess.run(
        [sys.executable, "-c", code, str(ROOT),
         json.dumps([[list(f), b] for f, b in keys])],
        capture_output=True, text=True, check=True, timeout=600)
    warm, recompiled = res.stdout.split()
    if int(recompiled):
        raise AssertionError(f"the warm load compiled {recompiled} parts")
    cuobjdump = pathlib.Path(_kernels._nvcc()).parent / "cuobjdump"

    def sass_instructions(base):
        sass = base.with_suffix(".sass")
        sass.write_text(subprocess.run(
            [str(cuobjdump), "-sass", str(base.with_suffix(".so"))],
            capture_output=True, text=True, check=True).stdout)
        return len(instructions(sass, "quotient_part_kernel"))

    # Each part's SASS, one cuobjdump a part, as many at once as the host
    # has cores (a part's dump takes seconds).
    bases = sorted({qc.build_dir() / f"part_{part.key}"
                    for key in QUOTIENT_PLANS.values()
                    for part in qc.prepare(key)[0].parts})
    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        sass_counts = dict(zip(bases, pool.map(sass_instructions, bases)))
    parts = {}
    for name, key in QUOTIENT_PLANS.items():
        kernel = qc.prepare(key)[0]
        rows = []
        for part in kernel.parts:
            base = qc.build_dir() / f"part_{part.key}"
            ptxas = base.with_suffix(".log").read_text()
            regs = re.search(r"Used (\d+) registers", ptxas)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", ptxas)
            span = qc.TILE + (1 << key[1])
            rows.append({
                "terms": [part.lo, part.hi], "stages": len(part.stages),
                "m31_ops": part.n_ops, "reads": part.reads,
                "slots": part.staging.slots,
                "smem_bytes": 4 * span * part.staging.slots,
                "registers": int(regs[1]),
                "spill_stores": int(spill[1]), "spill_loads": int(spill[2]),
                "sass": sass_counts[base]})
        parts[name] = rows
        log(f"quotient {name}: {len(rows)} parts, a launch each, "
            f"{sum(r['reads'] for r in rows)} global column reads a point; "
            f"each part's terms, stages, registers, spills (bytes "
            f"stored/loaded), shared memory, SASS instructions: "
            + "; ".join(f"{r['terms']} {r['stages']} "
                        f"{r['registers']} {r['spill_stores']}/"
                        f"{r['spill_loads']} {r['smem_bytes']} {r['sass']}"
                        for r in rows))
    helpers = helper_instructions(_kernels._nvcc(), _kernels.CSRC,
                                  qc.build_dir() / "helpers")
    log(f"quotient helpers' instructions a call: {helpers}")
    log(f"quotient kernels: {qc.compiles} parts compiled from an empty "
        f"build directory in {cold:.1f} s; loaded in a fresh process with "
        f"the libraries built in {float(warm):.2f} s")
    return {"cold_build_s": cold, "warm_load_s": float(warm),
            "compiled": qc.compiles, "parts": parts,
            "helper_instructions": helpers}


@contextlib.contextmanager
def quotient_calls(module=None):
    """The arguments of every quotient evaluation the prover (``module``:
    ``prover.prover`` by default, or ``prover.streaming``) makes inside the
    block, in a list."""
    from zkir_tpu_torch.prover import prover as prover_mod

    module = module or prover_mod
    calls = []
    real = module.quotient_evals

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    module.quotient_evals = spy
    try:
        yield calls
    finally:
        module.quotient_evals = real


def quotient_bytes(kernel, n: int) -> int:
    """The bytes the quotient must move at n points, in int64 words: each
    column the recording reads once, the real and imaginary 1/Z rows of
    each divisor tag its terms use once, and the [4, n] output once."""
    tags = {tag for tag, _ in kernel.rec.terms}
    return 8 * n * (len(kernel.rec.alg.leaves) + 2 * len(tags) + 4)


def quotient_ops(kernel, helpers) -> float:
    """The integer instructions one point of the quotient needs whatever
    the kernel's design: each helper call of
    ``quotient_codegen.operation_counts`` (every M31 node once, one
    accumulation a term, one division a tag, one store) at its
    instructions in a probe built from the headers
    (``tools/sass_count.py helper_instructions``)."""
    from zkir_tpu_torch.prover import quotient_codegen as qc

    return sum(n * helpers[name]
               for name, n in qc.operation_counts(kernel.rec).items())


def compare_quotient(what, call, results, quotient_stats, key=None) -> None:
    """The generated quotient kernels against the plain ``VecAlg`` path on
    the same card tensors, all four QM31 words at every point.  One
    evaluation must launch one ``quotient_part`` per part, and nothing
    else.  Bound: ``quotient_bytes`` at the memory rate, or
    ``quotient_ops`` a point at the card's instruction rate.  The
    parts' re-reads of the columns they share, by the staging plan, are a
    cost of the design, not of the function: ``plan_bytes_ms`` reports
    them apart, and ``sass_ms`` the parts' own SASS a point at the
    instruction rate."""
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.prover import constraints as cs
    from zkir_tpu_torch.prover import quotient_codegen as qc

    args, kwargs = call
    plan = (qc.features_of({**dict.fromkeys(qc.FEATURES), **kwargs}),
            args[3])
    name = next((k for k, v in QUOTIENT_PLANS.items() if v == plan), None)
    if name is None:
        raise AssertionError(f"quotient of {what}: no plan {plan} was built")
    kernel = qc.prepare(plan)[0]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    cs.quotient_evals(*args, **kwargs)
    torch.cuda.synchronize()
    launched = {k: v for k, v in _kernels.launches.items() if v}
    if launched != {"quotient_part": len(kernel.parts)}:
        raise AssertionError(f"quotient of {what}: launched {launched}, "
                             f"{len(kernel.parts)} parts")
    n = args[0].shape[1]
    rows = quotient_stats["parts"][name]
    reads = sum(p.reads for p in kernel.parts)
    ops = quotient_ops(kernel, quotient_stats["helper_instructions"])
    compare("quotient_part", lambda: cs.quotient_evals(*args, **kwargs),
            lambda: cs.quotient_evals_plain(*args, **kwargs), 10, results,
            plain_iters=2, key=key or f"quotient_part {what}",
            bounds=bound(quotient_bytes(kernel, n), n * ops))
    # The wrapper's two halves apart: the host's table (alpha powers,
    # challenge words, column addresses), each piece beside the plain way
    # (a Python loop of QM31 products; the scalar program interpreted),
    # and the parts' launches alone.
    A, keys = cs._vec_alg(args[0], args[1], args[3], **kwargs)
    alpha, n_terms = args[5], len(kernel.rec.terms)
    inputs = qc.challenge_words(keys)

    def best_ms(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return 1e3 * min(times)

    host = {
        "host_table_ms": best_ms(lambda: kernel.table(A, keys, alpha)),
        "alpha_powers_ms": best_ms(lambda: qc.alpha_powers(alpha, n_terms)),
        "alpha_powers_loop_ms": best_ms(
            lambda: cs._alpha_powers_np(alpha, n_terms)),
        "challenge_words_ms": best_ms(lambda: kernel._words(inputs)),
        "challenge_words_interpreted_ms": best_ms(
            lambda: kernel.rec.scalars.evaluate(inputs)),
        "column_addresses_ms": best_ms(lambda: qc._leaf_pointers(
            A, kernel.leaf_groups, len(kernel.rec.alg.leaves), A.big))}
    tables = kernel.table(A, keys, alpha)
    dinv = qc._dinv_rows(args[2], args[3], tuple(args[4]), args[0].device)
    launches_ms = cuda_ms(lambda: kernel.launch(tables, dinv, n), 10)
    r = results[key or f"quotient_part {what}"]
    r.update(points=n, parts=len(kernel.parts),
             launches=len(kernel.parts),
             column_reads=reads, ops_per_point=ops,
             plan_bytes_ms=8 * n * (reads + 4) / HBM_BYTES_PER_S * 1e3,
             sass_ms=n * sum(row["sass"] for row in rows)
             / INT_OPS_PER_S * 1e3, launches_only_ms=launches_ms, **host)
    log(f"quotient_part {what}: host table {host['host_table_ms']:.3f} ms "
        f"({host}), the {len(kernel.parts)} launches alone "
        f"{launches_ms:.4f} ms; {reads} global column reads a point, "
        f"{ops:.0f} instructions a point by the recording")


def phase_goldens(results, quotient_stats) -> None:
    """Goldens A-E on the card: the port's proof equals the reference's
    stored one, and the port's verifier accepts it; the quotient kernels
    against their plain version on golden C's and E's inputs."""
    from zkir_tpu_torch.convert import fixture_from_reference, proof_to_json
    from zkir_tpu_torch.prover import prove_trace, verify_trace

    for name in "abcde":
        fx = fixture_from_reference(FIXTURES, f"golden_{name}")
        t0 = time.perf_counter()
        with quotient_calls() as calls:
            proof = prove_trace(fx["matrix"], fx["config"],
                                range_lookup=fx["want"]["range_lookup"],
                                program=fx["program"], device="cuda")
        dt = time.perf_counter() - t0
        if name in "ce":
            compare_quotient(f"golden {name}", calls[0], results,
                             quotient_stats)
        del calls
        if json.loads(proof_to_json(proof)) != fx["want"]:
            raise AssertionError(f"golden {name}: proof differs from the "
                                 "reference proof")
        if not verify_trace(proof, fx["program"], device="cuda"):
            raise AssertionError(f"golden {name}: the port's verifier "
                                 "rejects the proof")
        log(f"golden {name}: proof equal to the reference and verified "
            f"({fx['matrix'].shape[0]} rows, range_lookup="
            f"{fx['want']['range_lookup']}, program bound: "
            f"{fx['program'] is not None}, {dt:.3f} s)")

    # The prove-time self-check under the full constraint set: golden E
    # with one digest byte of its SHA-256 row changed must be refused, the
    # violated terms named (``diagnose_violations`` with every lookup
    # argument).
    from zkir_tpu_torch.prover.prover import ConstraintViolation
    from zkir_tpu_torch.prover.trace import COL_CWD0, COL_ECR

    fx = fixture_from_reference(FIXTURES, "golden_e")
    bad = fx["matrix"].copy()
    bad[int(bad[:, COL_ECR].nonzero()[0][0]), COL_CWD0] ^= 1
    try:
        prove_trace(bad, fx["config"], range_lookup=True,
                    program=fx["program"], device="cuda")
    except ConstraintViolation as exc:
        if "term #" not in str(exc):
            raise AssertionError(f"violation without a term: {exc}")
        log(f"golden e with a changed digest byte: refused ({exc})")
    else:
        raise AssertionError("a trace with a wrong digest byte was proved")


def logged_prove(prove):
    """Run ``prove()`` with ``ZKIR_PROVE_LOG`` on: (proof, seconds, stage
    seconds and stage launches by message, peak device bytes).  Fails if
    a tree was not one launch."""
    import torch

    from zkir_tpu_torch import _kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    os.environ["ZKIR_PROVE_LOG"] = "1"     # stage times on stderr
    captured = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(captured), tree_sizes() as sizes:
            proof = prove()
    finally:
        del os.environ["ZKIR_PROVE_LOG"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check_trees("warm prove", _kernels.launches, sizes)
    sys.stderr.write(captured.getvalue())
    # "[prove   0.0123s] message [launches 45]": seconds and kernel
    # launches since the prove began.
    marks = [(float(m.group(1)), m.group(2), int(m.group(3)))
             for m in re.finditer(
                 r"\[prove\s+([0-9.]+)s\] (.*) \[launches (\d+)\]",
                 captured.getvalue())]
    stages = {msg: {"s": t1 - t0, "launches": n1 - n0}
              for (t0, _, n0), (t1, msg, n1)
              in zip([(0.0, "", 0)] + marks, marks)}
    return proof, seconds, stages, peak


@contextlib.contextmanager
def tree_sizes():
    """The leaf count of every tree ``merkle.build_tree`` builds inside the
    block, in a list."""
    from zkir_tpu_torch.ops import merkle

    sizes = []
    real = merkle.build_tree

    def spy(leaves):
        sizes.append(leaves.shape[0])
        return real(leaves)

    merkle.build_tree = spy
    try:
        yield sizes
    finally:
        merkle.build_tree = real


def check_trees(what, launches, sizes) -> None:
    """One ``p2_merkle_tree`` launch a tree of two leaves or more, and no
    tree built level by level."""
    trees = sum(1 for n in sizes if n > 1)
    if launches.get("p2_merkle_tree", 0) != trees \
            or launches.get("p2_compress_level", 0):
        raise AssertionError(f"{what}: {trees} trees took {launches}")
    log(f"{what}: {trees} trees (leaves {sizes}), one p2_merkle_tree "
        f"launch each, no p2_compress_level")


def counted(prove, kernels):
    """Run ``prove()`` with every launch count set to 0 just before and
    read just after: (proof, seconds, launches).  Fails if one of
    ``kernels`` was not launched, or if a tree was not one launch."""
    import torch

    from zkir_tpu_torch import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    with tree_sizes() as sizes:
        proof = prove()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    missing = [k for k in kernels if not launches.get(k)]
    if missing:
        raise AssertionError(f"kernels not launched by the path: {missing}")
    check_trees("first prove", launches, sizes)
    return proof, seconds, launches


def phase_full(results, quotient_stats):
    """The 2^16 proves (phases 6 and 7): their figures, and the main path's
    matrix, program and proof for the streaming phase."""
    import torch

    from zkir_tpu_torch import _kernels
    import numpy as np

    from zkir_tpu_torch.convert import trace_from_reference
    from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter
    from zkir_tpu_torch.prover import (FriConfig, prove_trace,
                                       trace_to_matrix, verify_trace)
    from zkir_tpu_torch.prover.benchtrace import exact_trace_program
    from zkir_tpu_torch.spec import Program

    # The reference interpreter's trace of the same program, made on a
    # CPU: the card-made trace is held to it, and the range_lookup=False
    # prove still reads it.
    ref_trace = trace_from_reference(FIXTURES / "trace_exact_2e16.npz")
    ref_matrix = trace_to_matrix(ref_trace)
    if ref_matrix.shape != (1 << 16, 493):
        raise AssertionError(f"trace matrix shape {ref_matrix.shape}")
    program = exact_trace_program(16)
    if program.to_bytes() != (
            FIXTURES / "trace_exact_2e16.program.zkir").read_bytes():
        raise AssertionError("exact_trace_program(16) differs from the "
                             "stored program")
    rows = ref_matrix.shape[0]

    seconds = {}

    def interpret():
        """The main path's first stage: program -> trace -> matrix, the
        seconds of both steps left in ``seconds``."""
        t0 = time.perf_counter()
        interp = TpuInterpreter(program, InterpConfig(
            lanes=1, chunk=1024, collect_trace=True), device="cuda")
        trace = interp.run([[]], max_cycles=2 * rows)["trace"]
        t1 = time.perf_counter()
        matrix = trace_to_matrix(trace)
        seconds.update(run_s=t1 - t0, matrix_s=time.perf_counter() - t1)
        return trace, matrix

    _kernels.reset_launches()
    trace, matrix = interpret()
    first = dict(seconds)
    launched = {k: v for k, v in _kernels.launches.items() if v}
    if launched != {"interp_run": 1}:
        raise AssertionError(f"the 2^16 trace took {launched}")
    valid = ref_trace["valid"]
    if set(trace) != set(ref_trace):
        raise AssertionError(f"trace keys {sorted(trace)}")
    for key, want in ref_trace.items():
        got = trace[key]
        if got.shape != want.shape or got.dtype != want.dtype \
                or not np.array_equal(got[valid], want[valid]):
            raise AssertionError(f"the card-made trace differs from the "
                                 f"reference's in {key!r}")
    if not np.array_equal(trace["valid"], valid) \
            or not np.array_equal(matrix, ref_matrix):
        raise AssertionError("the card-made trace matrix differs from the "
                             "reference's")
    # The CLI's configuration (chunk 256, prove's default max_cycles):
    # one launch too, and the same matrix.
    _kernels.reset_launches()
    cli_trace = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=256, collect_trace=True), device="cuda").run(
        [[]], max_cycles=100_000)["trace"]
    launched = {k: v for k, v in _kernels.launches.items() if v}
    if launched != {"interp_run": 1} \
            or not np.array_equal(trace_to_matrix(cli_trace), ref_matrix):
        raise AssertionError(f"the CLI's configuration took {launched} or "
                             "made another matrix")
    interpret()
    warm = dict(seconds)
    log(f"interpreter: 2^16-cycle trace on the card equal to the "
        f"reference's (one interp_run launch, also with the CLI's 256-cycle "
        f"chunks; TpuInterpreter.run first "
        f"{first['run_s']:.3f} s, warm {warm['run_s']:.3f} s; "
        f"trace_to_matrix {warm['matrix_s']:.3f} s); matrix "
        f"{matrix.shape}, program of {len(program.code)} instructions")

    # The NTT family launches its own kernel and nothing else.
    from zkir_tpu_torch.ops import ntt
    from zkir_tpu_torch.prover.prover import _coset_shift

    x = torch.arange(3 << 14, device="cuda").reshape(3, 1 << 14)
    _kernels.reset_launches()
    ntt.lde(x, None, 14, 2, shift=_coset_shift())
    ntt.coset_ntt(x, x, 14, shift=_coset_shift())
    ntt.coset_intt(x, x, 14, shift=_coset_shift())
    ntt.ntt(x, x, 14)
    ntt.intt(x, x, 14)
    family = {k: v for k, v in _kernels.launches.items() if v}
    if family != {"cm31_ntt": 6}:
        raise AssertionError(f"the NTT family launched {family}")
    log(f"NTT family (lde, coset_ntt, coset_intt, ntt, intt): {family}")

    stats = {"interpret_2e16": {"rows": rows, "first": first, "warm": warm}}
    for key, kwargs in (
            ("prove_2e16", {}),
            ("prove_2e16_bound", {"range_lookup": True,
                                  "program": program})):
        bound_program = kwargs.get("program")
        if bound_program is None:
            def prove():
                return prove_trace(ref_matrix, FriConfig(), device="cuda")

            with quotient_calls() as calls:
                proof, first_s, launches = counted(
                    prove, [k for k in PROVER_KERNELS
                            if k not in SUMS_KERNELS])
            compare_quotient("[2^18] range_lookup=False", calls[0], results,
                             quotient_stats)
        else:
            # The main path, as the CLI's prove drives it: interpret on
            # the card, build the matrix, prove it with the program bound.
            def prove():
                return prove_trace(matrix, FriConfig(), device="cuda",
                                   **kwargs)

            def interpret_and_prove():
                return prove_trace(interpret()[1], FriConfig(),
                                   device="cuda", **kwargs)

            with quotient_calls() as calls:
                proof, first_s, launches = counted(interpret_and_prove,
                                                   MAIN_PATH_KERNELS)
            compare_quotient("main path [2^18]", calls[0], results,
                             quotient_stats, key="quotient_part")
        del calls
        log(f"{key}: launches in the first prove: {launches}")
        with sums_launches() as sums:
            warm, warm_s, stages, peak = logged_prove(prove)
        warm_launches = sum(v["launches"] for v in stages.values())
        log(f"{key}: warm prove stages: {stages}")
        log(f"{key}: warm prove launches {warm_launches}; the partial-sum "
            f"stage's by kernel {sums}")
        if bound_program is not None:
            check_sums_stage(key, sums)
        if warm != proof:
            raise AssertionError(f"{key}: cold and warm proofs differ")
        t0 = time.perf_counter()
        ok = verify_trace(proof, bound_program, device="cuda")
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
        if not ok:
            raise AssertionError(f"{key}: the port's verifier rejects the "
                                 "2^16 proof")
        if bound_program is not None and verify_trace(
                proof, Program.from_bytes(
                    (FIXTURES / "golden_d.program.zkir").read_bytes()),
                device="cuda"):
            raise AssertionError(f"{key}: the proof verifies against "
                                 "another program")
        stats[key] = {
            "rows": rows, "n_cols": proof["n_cols"],
            "prove_first_s": first_s, "prove_warm_s": warm_s,
            "rows_per_s_warm": rows / warm_s, "verify_s": verify_s,
            "peak_bytes": peak, "stages_warm_s": stages,
            "launches": launches, "warm_launches": warm_launches,
            "sums_stage_launches": sums}
        log(f"{key}: first {first_s:.3f} s, warm {warm_s:.3f} s "
            f"({rows / warm_s:.1f} rows/s), verify {verify_s:.3f} s (True), "
            f"peak device memory {peak / 2**30:.3f} GiB")
        if bound_program is not None:
            main_path = {"matrix": matrix, "program": program,
                         "proof": proof}
        del proof, warm
    return stats, main_path


def check_sums_stage(what, sums) -> None:
    """The partial-sum stage of a prove with the program bound: seven
    inversions (channels, aux, slots, memory, I/O, tape, program) and six
    scans (channels, aux, memory, I/O, tape, program), each one launch."""
    if len(sums) != 1 or sums[0].get("qm31_inv_scaled") != 7 \
            or sums[0].get("m31_exclusive_scan") != 6:
        raise AssertionError(f"{what}: the partial-sum stage launched {sums}")


@contextlib.contextmanager
def plain_calls():
    """Every call, inside the block, of a kernel's plain version with a
    tensor on the card, by name, in a list: a path that is to run on the
    card's kernels must leave it empty."""
    from zkir_tpu_torch.ops import field_ops, merkle, ntt
    from zkir_tpu_torch.ops import poseidon2 as p2
    from zkir_tpu_torch.prover import constraints

    calls = []

    def on_card(values):
        for v in values:
            if isinstance(v, (tuple, list)):
                if on_card(v):
                    return True
            elif getattr(v, "is_cuda", False):
                return True
        return False

    def spy(name, real):
        def plain(*args, **kwargs):
            if on_card(list(args) + list(kwargs.values())):
                calls.append(name)
            return real(*args, **kwargs)
        return plain

    from zkir_tpu_torch.ops import qm31

    patched = [(ntt, "ntt_plain"), (merkle, "build_tree_plain"),
               (constraints, "quotient_evals_plain"),
               (qm31, "qm31_inv_scaled_plain"),
               (qm31, "exclusive_cumsum4_plain")]
    patched += [(p2, name) for name in (
        "permute_plain", "sponge_rows_plain", "sponge_absorb_plain",
        "compress_level_plain")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in patched]
    tables = [field_ops._PLAIN, field_ops._CM31_PLAIN]
    saved_tables = [dict(t) for t in tables]
    for mod, name, real in saved:
        setattr(mod, name, spy(name, real))
    for table, label in zip(tables, ("m31", "cm31")):
        for op, real in list(table.items()):
            table[op] = spy(f"{label} {op}", real)
    try:
        yield calls
    finally:
        for mod, name, real in saved:
            setattr(mod, name, real)
        for table, old in zip(tables, saved_tables):
            table.update(old)


def phase_sponge_absorb(results) -> None:
    """``p2_sponge_absorb`` against ``sponge_absorb_plain``, exactly: at
    [2^18 rows, 128 words] (a 64-column block of 2^18 points) from zero
    and from non-zero states, with and without the padding block, and at
    odd widths with the padding; timed beside its bound at that shape and
    at the 2^16 streaming prove's [2^16, 128]."""
    import torch

    from zkir_tpu_torch.ops import poseidon2 as p2

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)

    def check(what, states, blocks, pad):
        got = states.clone()
        p2.sponge_absorb(got, blocks, pad)
        want = p2.sponge_absorb_plain(states, blocks, pad)
        torch.cuda.synchronize()
        return max_abs_err(f"p2_sponge_absorb {what}", got, want)

    n = 1 << 18
    blocks = words(gen, (n, 128))
    err = 0
    for label, states in (
            ("zero", torch.zeros((n, 16), dtype=torch.int64, device="cuda")),
            ("non-zero", words(gen, (n, 16)))):
        for pad in (False, True):
            err = max(err, check(f"[2^18, 128] from {label} states, "
                                 f"pad={pad}", states, blocks, pad))
    for rows, width in ((4099, 1), (4099, 7), (999, 92), (1 << 12, 1191),
                        (1 << 12, 0)):
        err = max(err, check(f"[{rows}, {width}], pad", words(gen, (rows, 16)),
                             words(gen, (rows, width)), True))
    log("p2_sponge_absorb: exact against its plain version at [2^18, 128] "
        "from zero and non-zero states with and without padding, and at "
        "odd widths with padding")
    perm = P2_INSTR_PER_PERMUTATION
    for rows, key in ((n, "p2_sponge_absorb"),
                      (1 << 16, "p2_sponge_absorb [2^16, 128]")):
        states = words(gen, (rows, 16))
        x = blocks[:rows]
        ms = cuda_ms(lambda: p2.sponge_absorb(states, x, False), 10)
        plain_ms = cuda_ms(lambda: p2.sponge_absorb_plain(states, x, False),
                           2)
        results[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        **bound(8 * (2 * rows * 16 + rows * 128),
                                perm * rows * 16),
                        "library_ms": None}
        r = results[key]
        log(f"{key}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ([{rows}, 128] from "
            f"non-zero states, no padding)")


def phase_streaming(results, quotient_stats, main_path) -> dict:
    """The streaming prover on the card: ``p2_sponge_absorb`` against its
    plain version; goldens C and E proved by streaming, equal to the
    stored proofs and verified; the 2^16 main path proved by streaming,
    equal to the one-shot proof, verified, through the card's kernels
    only; the quotient on one coset (log_blowup 0) against the plain
    version on golden E's and the 2^16 main path's inputs; and a 2^20-row
    trace interpreted on the card, proved by streaming with its program
    bound and verified."""
    import numpy as np
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.convert import fixture_from_reference, proof_to_json
    from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter
    from zkir_tpu_torch.prover import (FriConfig, quotient_codegen,
                                       streaming, trace_to_matrix,
                                       verify_trace)
    from zkir_tpu_torch.prover.benchtrace import exact_trace_program

    phase_sponge_absorb(results)
    stats = {}
    for name, col_block in (("c", 37), ("e", 64)):
        fx = fixture_from_reference(FIXTURES, f"golden_{name}")
        t0 = time.perf_counter()
        with quotient_calls(streaming) as calls, plain_calls() as plain:
            proof = streaming.prove_trace_streaming(
                fx["matrix"], fx["config"], program=fx["program"],
                col_block=col_block, device="cuda")
        dt = time.perf_counter() - t0
        if plain:
            raise AssertionError(f"streaming golden {name} ran plain "
                                 f"versions on the card: {sorted(set(plain))}")
        if len(calls) != 4 or any(c[0][3] != 0 for c in calls):
            raise AssertionError(f"streaming golden {name}: quotient calls "
                                 f"{[c[0][3] for c in calls]}")
        if name == "e":
            compare_quotient("golden e, one coset", calls[0], results,
                             quotient_stats)
        del calls
        if json.loads(proof_to_json(proof)) != fx["want"]:
            raise AssertionError(f"streaming golden {name}: proof differs "
                                 "from the reference proof")
        if not verify_trace(proof, fx["program"], device="cuda"):
            raise AssertionError(f"streaming golden {name}: the port's "
                                 "verifier rejects the proof")
        log(f"streaming golden {name} (col_block {col_block}): proof equal "
            f"to the reference and verified ({dt:.3f} s)")

    # The 2^16 main path by streaming: the same proof as the one-shot
    # prove of phase 7, verified, through the card's kernels only.
    def prove():
        return streaming.prove_trace_streaming(
            main_path["matrix"], FriConfig(), program=main_path["program"],
            col_block=64, device="cuda")

    compiled = quotient_codegen.compiles
    with quotient_calls(streaming) as calls, plain_calls() as plain:
        proof, first_s, launches = counted(prove, STREAMING_KERNELS)
    if plain:
        raise AssertionError(f"the 2^16 streaming prove ran plain versions "
                             f"on the card: {sorted(set(plain))}")
    if quotient_codegen.compiles != compiled:
        raise AssertionError("the streaming prove compiled quotient parts")
    others = {k for k, v in launches.items() if v} - set(STREAMING_KERNELS)
    if others:
        raise AssertionError(f"the streaming prove launched {others}")
    compare_quotient("main path, one coset [2^16]", calls[0], results,
                     quotient_stats, key="quotient_part one coset")
    del calls
    if proof != main_path["proof"]:
        raise AssertionError("the 2^16 streaming proof differs from the "
                             "one-shot proof")
    with sums_launches() as sums:
        warm, warm_s, stages, peak = logged_prove(prove)
    if warm != proof:
        raise AssertionError("the 2^16 streaming proves differ")
    check_sums_stage("stream_2e16_bound", sums)
    warm_launches = sum(v["launches"] for v in stages.values())
    log(f"stream_2e16_bound: warm prove launches {warm_launches}; the "
        f"partial-sum stage's by kernel {sums}")
    t0 = time.perf_counter()
    if not verify_trace(proof, main_path["program"], device="cuda"):
        raise AssertionError("the port's verifier rejects the 2^16 streaming "
                             "proof")
    verify_s = time.perf_counter() - t0
    rows = main_path["matrix"].shape[0]
    stats["stream_2e16_bound"] = {
        "rows": rows, "col_block": 64, "prove_first_s": first_s,
        "prove_warm_s": warm_s, "rows_per_s_warm": rows / warm_s,
        "verify_s": verify_s, "peak_bytes": peak, "stages_warm_s": stages,
        "launches": launches, "warm_launches": warm_launches,
        "sums_stage_launches": sums}
    log(f"stream_2e16_bound: proof equal to the one-shot proof and verified; "
        f"first {first_s:.3f} s, warm {warm_s:.3f} s ({rows / warm_s:.1f} "
        f"rows/s), peak device memory {peak / 2**30:.3f} GiB; launches "
        f"{launches}; warm stages {stages}")
    del proof, warm

    # 2^20 rows, made on the card and proved by streaming, program bound.
    log_rows = 20
    program = exact_trace_program(log_rows)
    t0 = time.perf_counter()
    trace = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=1024, collect_trace=True), device="cuda").run(
            [[]], max_cycles=2 << log_rows)["trace"]
    t1 = time.perf_counter()
    matrix = trace_to_matrix(trace)
    matrix_s = time.perf_counter() - t1
    del trace
    if matrix.shape[0] != 1 << log_rows or not np.all(matrix[-1, 2] == 0x51):
        raise AssertionError(f"the 2^{log_rows} trace has shape "
                             f"{matrix.shape}")
    big, big_s, big_stages, big_peak = logged_prove(
        lambda: streaming.prove_trace_streaming(
            matrix, FriConfig(), program=program, col_block=64,
            device="cuda"))
    big_launches = sum(_kernels.launches.values())
    t0v = time.perf_counter()
    if not verify_trace(big, program, device="cuda"):
        raise AssertionError(f"the port's verifier rejects the 2^{log_rows} "
                             "streaming proof")
    big_verify_s = time.perf_counter() - t0v
    stats[f"stream_2e{log_rows}_bound"] = {
        "rows": matrix.shape[0], "col_block": 64, "run_s": t1 - t0,
        "matrix_s": matrix_s, "prove_s": big_s,
        "rows_per_s": matrix.shape[0] / big_s, "verify_s": big_verify_s,
        "peak_bytes": big_peak, "stages_s": big_stages,
        "launches": big_launches}
    log(f"stream_2e{log_rows}_bound: interpreted in {t1 - t0:.3f} s, matrix "
        f"{matrix_s:.3f} s, proved by streaming in {big_s:.3f} s "
        f"({matrix.shape[0] / big_s:.1f} rows/s, {big_launches} launches), "
        f"verified in {big_verify_s:.3f} s; peak device memory "
        f"{big_peak / 2**30:.3f} GiB; stages {big_stages}")
    del big, matrix
    torch.cuda.empty_cache()
    return stats


# ============================================================================
# The sharded prover on the card
# ============================================================================

MESH_PROVE_BUDGET_S = 150
# Goldens the gloo ranks of the mesh-prove phase prove: (name, col_block
# of a streaming prove, or None for one-shot).  B has 493 columns, so every
# rank's block is padded; C's blocks of 6 columns are padded on 4 ranks.
MESH_PROVE_GOLDENS = (("b", None), ("e", None), ("c", 6))


def _mesh_prove_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One gloo rank of the mesh-prove phase (b), on ``cuda:0`` with the
    others: goldens B and E one-shot and C by streaming on the mesh, each
    proof held to the stored reference proof (a difference raises, and
    the rank fails); its launches, plain-version calls and seconds saved
    for the parent."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch import parallel as par
    from zkir_tpu_torch.convert import fixture_from_reference, proof_to_json
    from zkir_tpu_torch.prover import prove_trace
    from zkir_tpu_torch.prover.streaming import prove_trace_streaming

    par.join_local_group(port, rank, world, "gloo",
                         timeout=datetime.timedelta(seconds=120))
    try:
        mesh = par.make_mesh(world, device="cuda", backend="gloo")
        seconds = {}
        _kernels.reset_launches()
        with plain_calls() as plain:
            for name, col_block in MESH_PROVE_GOLDENS:
                fx = fixture_from_reference(FIXTURES, f"golden_{name}")
                t0 = time.perf_counter()
                if col_block:
                    proof = prove_trace_streaming(
                        fx["matrix"], fx["config"], program=fx["program"],
                        col_block=col_block, mesh=mesh, device="cuda")
                else:
                    proof = prove_trace(
                        fx["matrix"], fx["config"], mesh=mesh,
                        range_lookup=fx["want"]["range_lookup"],
                        program=fx["program"], device="cuda")
                seconds[name] = time.perf_counter() - t0
                if json.loads(proof_to_json(proof)) != fx["want"]:
                    raise AssertionError(f"gloo rank {rank}: golden {name} "
                                         "differs from the reference proof")
        torch.save({"launches": {k: v for k, v in _kernels.launches.items()
                                 if v},
                    "plain_calls": plain, "seconds": seconds,
                    "device": str(mesh.device)},
                   pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_mesh_prove(main_path) -> dict:
    """The sharded prover (``prove_trace(mesh=)``,
    ``prove_trace_streaming(mesh=)``, ``prove --mesh``) on the card.
    (a) A world of one NCCL rank at full width: the 2^16 main path's
    matrix proved one-shot with its program bound and by streaming
    (``col_block=64``) on ``make_mesh(1)``, each equal to the single-device
    proof, no plain version on a card tensor, and each warm prove's
    launches by kernel equal to the single-device warm prove's (timed in
    turns: one device, mesh, mesh, one device), with the peak device
    memory; the first prove on the mesh builds as many trees as a warm
    one (the aux table's tree cached for the card whatever its name).  (b) 4 gloo ranks sharing ``cuda:0``, spawned here: goldens B
    and E one-shot and C by streaming with ``col_block=6``, each rank's
    proof equal to the stored reference proof.  (c) The CLI in fresh
    processes: ``prove --bind --mesh 1`` writes golden D as ``prove
    --bind`` does; ``warm --log-rows 12 --streaming --cache-dir`` an empty
    directory builds the streaming plan's quotient parts there, and a
    later ``prove --streaming`` with that ``ZKIR_CACHE_DIR`` builds none.
    At most ``MESH_PROVE_BUDGET_S`` seconds."""
    import datetime

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch import parallel as par
    from zkir_tpu_torch.prover import FriConfig, prove_trace, streaming

    t_phase = time.perf_counter()
    matrix, program = main_path["matrix"], main_path["program"]
    stats = {}

    # (a) A world of one NCCL rank, at full width.
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = par.make_mesh(1)
        for path, kernels, prove in (
                ("one-shot", PROVER_KERNELS,
                 lambda mesh: prove_trace(matrix, FriConfig(), mesh=mesh,
                                          range_lookup=True, program=program,
                                          device="cuda")),
                ("streaming", STREAMING_KERNELS,
                 lambda mesh: streaming.prove_trace_streaming(
                     matrix, FriConfig(), program=program, col_block=64,
                     mesh=mesh, device="cuda"))):
            with plain_calls() as plain:
                proof, first_s, first = counted(lambda: prove(mesh), kernels)
            if plain:
                raise AssertionError(f"the {path} mesh prove ran plain "
                                     f"versions on the card: "
                                     f"{sorted(set(plain))}")
            if proof != main_path["proof"]:
                raise AssertionError(f"the {path} proof on a mesh of one "
                                     "rank differs from the single-device "
                                     "proof")
            runs = {}
            for where in ("device", "mesh", "mesh", "device"):
                got, s, stages, peak = logged_prove(
                    lambda: prove(mesh if where == "mesh" else None))
                if got != proof:
                    raise AssertionError(f"the {path} warm proves differ")
                runs.setdefault(where, []).append({
                    "s": s, "peak_bytes": peak, "stages": stages,
                    "launches": {k: v for k, v in _kernels.launches.items()
                                 if v}})
            warm = {where: [r["launches"] for r in rs]
                    for where, rs in runs.items()}
            if any(w != warm["device"][0]
                   for w in warm["device"] + warm["mesh"]):
                raise AssertionError(f"{path}: launches on a mesh of one "
                                     f"rank {warm['mesh']}, on one device "
                                     f"{warm['device']}")
            # The aux table's tree is cached by the card with its index, so
            # the first prove on the mesh (device cuda:0) reuses the one
            # the single-device proves (device cuda) built.
            if first["p2_merkle_tree"] != warm["device"][0]["p2_merkle_tree"]:
                raise AssertionError(
                    f"{path}: the first prove on the mesh built "
                    f"{first['p2_merkle_tree']} trees, a warm prove "
                    f"{warm['device'][0]['p2_merkle_tree']}")
            stats[path] = {
                "first_launches": first, "first_s": first_s,
                "warm_launches": warm["mesh"][0],
                "warm_launches_total": sum(warm["mesh"][0].values()),
                "mesh_warm_s": [r["s"] for r in runs["mesh"]],
                "device_warm_s": [r["s"] for r in runs["device"]],
                "mesh_peak_bytes": max(r["peak_bytes"] for r in runs["mesh"]),
                "device_peak_bytes": max(r["peak_bytes"]
                                         for r in runs["device"]),
                "mesh_stages": runs["mesh"][-1]["stages"]}
            log(f"mesh prove (a) {path}: a mesh of one NCCL rank gives the "
                f"single-device proof; warm launches "
                f"{stats[path]['warm_launches_total']}, equal by kernel to "
                f"one device's; warm s on the mesh {stats[path]['mesh_warm_s']}"
                f", on one device {stats[path]['device_warm_s']}; peak "
                f"{stats[path]['mesh_peak_bytes'] / 2**30:.3f} GiB against "
                f"{stats[path]['device_peak_bytes'] / 2**30:.3f}")
        del proof, got
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (b) 4 gloo ranks sharing cuda:0, spawned here.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        store = par.rendezvous_store()   # held until the ranks end
        ctx = mp.start_processes(
            _mesh_prove_rank, args=(MESH_GLOO_RANKS, store.port, tmp),
            nprocs=MESH_GLOO_RANKS, join=False, start_method="spawn")
        deadline = t0 + MESH_PROVE_BUDGET_S / 2
        try:
            while not ctx.join(timeout=max(1.0,
                                           deadline - time.perf_counter())):
                if time.perf_counter() > deadline:
                    raise AssertionError("the gloo ranks did not prove in "
                                         "their budget")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [torch.load(pathlib.Path(tmp) / f"rank{r}.pt",
                            weights_only=False)
                 for r in range(MESH_GLOO_RANKS)]
    for r, got in enumerate(ranks):
        if got["plain_calls"] or got["device"] != "cuda:0" \
                or not set(PROVER_KERNELS + ["p2_sponge_absorb"]) <= set(
                    got["launches"]):
            raise AssertionError(f"gloo rank {r} on {got['device']}: plain "
                                 f"versions {got['plain_calls']}, launches "
                                 f"{got['launches']}")
    stats["gloo"] = {"ranks": MESH_GLOO_RANKS,
                     "correctness_run_s": time.perf_counter() - t0,
                     "seconds": [g["seconds"] for g in ranks],
                     "launches": [g["launches"] for g in ranks]}
    log(f"mesh prove (b): {MESH_GLOO_RANKS} gloo ranks on cuda:0, goldens "
        f"B and E one-shot and C by streaming (col_block 6) equal to the "
        f"reference proofs on every rank "
        f"({stats['gloo']['correctness_run_s']:.1f} s, a correctness run)")

    # (c) The CLI: prove --mesh 1, and warm into a fresh cache directory.
    fib = str(ROOT / "examples" / "fibonacci.zkasm")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        out, _, stats["cli_prove_bind_mesh_1_s"] = run_cli(
            tmp, "prove", fib, "--input", "10", "--bind", "--mesh", "1",
            "-o", "m.json")
        if out.strip() != "proved 62 trace rows (62 cycles) -> m.json":
            raise AssertionError(f"prove --bind --mesh 1: {out}")
        want = json.loads((FIXTURES / "golden_d.proof.json").read_text())
        if json.loads((tmp / "m.json").read_text()) != want:
            raise AssertionError("prove --bind --mesh 1 differs from prove "
                                 "--bind's golden D")
        cache = tmp / "cache"
        out, _, stats["cli_warm_streaming_s"] = run_cli(
            tmp, "warm", "--log-rows", "12", "--streaming", "--cache-dir",
            str(cache))
        if not re.fullmatch(r"warmed prove kernels for 2\^12 rows in "
                            r"\d+\.\ds", out.strip()):
            raise AssertionError(f"warm: {out}")
        built = sorted(cache.glob("quotient/part_*.so"))
        if not built:
            raise AssertionError("warm built no quotient part in its cache "
                                 "directory")
        _, _, stats["cli_prove_streaming_after_warm_s"] = run_cli(
            tmp, "prove", fib, "--input", "10", "--streaming", "-o", "s.json",
            env={"ZKIR_CACHE_DIR": str(cache)})
        if sorted(cache.glob("quotient/part_*.so")) != built:
            raise AssertionError("a prove after warm built quotient parts")
        stats["cli_warm_parts"] = len(built)
    log(f"mesh prove (c): prove --bind --mesh 1 wrote golden D; warm "
        f"--log-rows 12 --streaming built {len(built)} quotient parts in its "
        f"cache directory ({stats['cli_warm_streaming_s']:.1f} s), and a "
        f"prove --streaming after it built none")
    phase_s = time.perf_counter() - t_phase
    stats["phase_s"] = phase_s
    if phase_s > MESH_PROVE_BUDGET_S:
        raise AssertionError(f"the mesh-prove phase took {phase_s:.1f} s of "
                             f"its {MESH_PROVE_BUDGET_S} s")
    return stats


def main_path_alone() -> dict:
    """The 2^16 main path's matrix, program and one-shot proof, made on the
    card without the phases before it (``--mesh``)."""
    from zkir_tpu_torch.prover import FriConfig, prove_trace
    from zkir_tpu_torch.prover.benchtrace import (exact_trace_matrix,
                                                  exact_trace_program)

    program = exact_trace_program(16)
    matrix = exact_trace_matrix(16, device="cuda")
    return {"matrix": matrix, "program": program,
            "proof": prove_trace(matrix, FriConfig(), range_lookup=True,
                                 program=program, device="cuda")}


def quotient_only(results) -> dict:
    """``--quotient``: the quotient's build, then its kernels against the
    plain version on golden C's and E's inputs and on the 2^16 main
    path's."""
    from zkir_tpu_torch.convert import (fixture_from_reference,
                                        trace_from_reference)
    from zkir_tpu_torch.prover import FriConfig, prove_trace, trace_to_matrix
    from zkir_tpu_torch.prover.benchtrace import exact_trace_program

    quotient_stats = phase_quotient_build()
    for name in "ce":
        fx = fixture_from_reference(FIXTURES, f"golden_{name}")
        with quotient_calls() as calls:
            prove_trace(fx["matrix"], fx["config"], range_lookup=True,
                        program=fx["program"], device="cuda")
        compare_quotient(f"golden {name}", calls[0], results, quotient_stats)
    matrix = trace_to_matrix(trace_from_reference(
        FIXTURES / "trace_exact_2e16.npz"))
    with quotient_calls() as calls:
        prove_trace(matrix, FriConfig(), device="cuda", range_lookup=True,
                    program=exact_trace_program(16))
    compare_quotient("main path [2^18]", calls[0], results, quotient_stats,
                     key="quotient_part")
    return {"quotient": quotient_stats, "kernel_cases": results}


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

    from zkir_tpu_torch.prover import quotient_codegen

    results = {}
    if sys.argv[1:] == ["--crypto"]:
        stats = phase_crypto(results)
        print(json.dumps({"crypto": stats, "kernel_cases": results,
                          "card": card}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--mesh"]:
        stats = phase_mesh(results)
        t0 = time.perf_counter()
        quotient_codegen.prepare(*QUOTIENT_PLANS.values())
        log(f"quotient plans built in {time.perf_counter() - t0:.1f} s")
        prove_stats = phase_mesh_prove(main_path_alone())
        print(json.dumps({"mesh": stats, "mesh_prove": prove_stats,
                          "kernel_cases": results, "card": card}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--sums"]:
        phase_sums(results, torch.Generator(device="cuda").manual_seed(SEED))
        print(json.dumps({"kernel_cases": results, "card": card}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--quotient"]:
        print(json.dumps({**quotient_only(results), "card": card}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    quotient_stats = timed("quotient build", phase_quotient_build)
    timed("kernels", phase_kernels, results)
    timed("goldens", phase_goldens, results, quotient_stats)
    interp_stats = timed("interpreter", phase_interp, results)
    crypto_stats = timed("crypto", phase_crypto, results)
    mesh_stats = timed("mesh", phase_mesh, results, interp_stats["floor"])
    full_stats, main_path = timed("2^16 proves", phase_full, results,
                                  quotient_stats)
    stream_stats = timed("streaming", phase_streaming, results,
                         quotient_stats, main_path)
    mesh_prove_stats = timed("mesh prove", phase_mesh_prove, main_path)
    deferred_stats = timed("deferred", phase_deferred, results, main_path,
                           interp_stats["floor"])
    del main_path
    stats = {**full_stats, **stream_stats, "interp": interp_stats,
             "crypto": crypto_stats, "mesh": mesh_stats,
             "mesh_prove": mesh_prove_stats, "deferred": deferred_stats,
             "cli": timed("cli", phase_cli), "quotient": quotient_stats,
             "phase_s": phase_s}
    if quotient_codegen.compiles != quotient_stats["compiled"]:
        raise AssertionError("a prove compiled quotient parts: "
                             f"{quotient_codegen.compiles} compiled, "
                             f"{quotient_stats['compiled']} in the build")

    # launches: the path that owns the kernel (interpret and prove with
    # range_lookup=True and the program bound; for the hash kernels the
    # crypto phase's 65,536-lane run; for p2_sponge_absorb the 2^16
    # streaming prove; 0 for PATHLESS); launches_plain_path: the range_lookup=False
    # prove; launches_streaming_path: the 2^16 streaming prove;
    # launches_deferred_path: the deferred model's 2^16 trace interpreted
    # and proved with its program bound; launches_mesh_path: the mesh
    # phase's distributed entry points on a world of one NCCL rank;
    # launches_mesh_prove_path and launches_mesh_streaming_path: the first
    # one-shot and streaming proves of the 2^16 main path on that world.
    streamed = stats["stream_2e16_bound"]["launches"]
    deferred_path = deferred_stats["path"]["launches"]
    # interp_run's deferred build: the 2^16 launch alone and its bound,
    # beside the plain build's in the same call.
    extra = {"interp_run": {
        f"{k}_2e16_{model}": deferred_stats[f"interp_run_2e16_{model}"][k]
        for model in ("deferred", "plain") for k in ("ms", "bound_ms")},
        # The chains of the sponge and the tree: a kernel's bound is the
        # larger of bound_ms and latency_floor_ms.
        "p2_sponge_bytes": {k: results["p2_sponge_bytes"][k] for k in (
            "latency_floor_ms", "permutation_latency_ms")},
        "p2_merkle_tree": {k: results["p2_merkle_tree"][k] for k in (
            "latency_floor_ms", "narrow_level_ms")},
        # the LogUp partial sums' kernels: the launch alone (``ms`` is the
        # call with its wrapper, which the host bounds)
        **{name: {"launch_ms": results[name]["launch_ms"]}
           for name in ("qm31_inv_scaled", "m31_exclusive_scan")}}
    main_path = dict(stats["prove_2e16_bound"]["launches"],
                     p2_sponge_absorb=streamed["p2_sponge_absorb"],
                     **{k: crypto_stats["launches"][k]
                        for k in CRYPTO_KERNELS})
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces,
                "launches": main_path.get(name, 0),
                "launches_plain_path":
                    stats["prove_2e16"]["launches"][name],
                "launches_streaming_path": streamed[name],
                "launches_deferred_path": deferred_path.get(name, 0),
                "launches_mesh_path": mesh_stats["launches"].get(name, 0),
                "launches_mesh_prove_path": mesh_prove_stats["one-shot"]
                ["first_launches"].get(name, 0),
                "launches_mesh_streaming_path": mesh_prove_stats["streaming"]
                ["first_launches"].get(name, 0),
                **{k: results[name][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}, **extra.get(name, {})}
               for name, (src, replaces) in KERNELS.items()]
    # PATHLESS: no path of the port launches them any more (0 above).
    if any(not k["launches"] for k in kernels
           if k["name"] not in PATHLESS):
        raise AssertionError(f"a kernel was launched by no path: {kernels}")
    more = {k: v for k, v in results.items() if k not in KERNELS}
    print(json.dumps({**stats, "more_kernel_cases": more, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
