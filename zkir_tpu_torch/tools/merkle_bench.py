#!/usr/bin/env python3
"""K2's whole-tree kernel and proof-of-work search in several designs, on
one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 zkir_tpu_torch/tools/merkle_bench.py [T:LANE_NODES ...] \
        [--grind B ...]

Builds ``csrc/poseidon2.cu`` once per design, each into a library of its
own under ``zkir_tpu_torch/_build/merkle_bench/`` (all nvcc runs started
together; ``-Xptxas -v`` in a ``.log`` beside each): ``T`` threads a CTA
(``TREE_THREADS``; a unit of 2T leaves), levels of at most ``LANE_NODES``
nodes at 4 lanes a node (``TREE_LANE_NODES``; 0: a thread a node
everywhere), and ``B`` proof-of-work CTAs an SM
(``GRIND_BLOCKS_PER_SM``).
The designs are compile-time constants here only: the port builds one.

Prints one JSON line per design, after the card's name and power limit:
``p2_merkle_tree`` launched alone (CUDA events, the output allocated
outside the timed span) at 2^18, 2^17, 2^12 and 2^6 leaves, each tree
equal word for word to ``build_tree_plain`` on the card; whole trees of
one CTA whose levels all run one way (2 .. 2 LANE_NODES leaves, or 2 ..
2T with no 4-lane levels), whose time grows by one level's latency a
level; and ``p2_grind`` at 16 bits on eight seeded states: the nonces
equal to the port's, the whole call by the host clock, and the kernel
alone by ``torch.profiler`` where it records device time.  First the
port's own one-state ``p2_permute`` launch, alone: one permutation's
latency with a launch's.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

BUILD = ROOT / "zkir_tpu_torch" / "_build" / "merkle_bench"
DEFAULT_TREES = ("256:64", "256:16", "256:0", "128:32", "128:8", "64:16")
DEFAULT_GRIND = (1, 2, 3, 4)
SEED = 20261017


def build(designs):
    """One library per design ``(threads, lane_nodes, grind_blocks)``
    (grind_blocks 0: the source's own)."""
    from zkir_tpu_torch import _kernels

    text = (_kernels.CSRC / "poseidon2.cu").read_text()
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = []
    for threads, nodes, blocks in designs:
        cu = BUILD / f"tree_{threads}_{nodes}_grind_{blocks}.cu"
        cu.write_text(f"#define TREE_THREADS {threads}\n"
                      f"#define TREE_LANE_NODES {nodes}\n"
                      + (f"#define GRIND_BLOCKS_PER_SM {blocks}\n"
                         if blocks else "") + text)
        sources.append(cu)
    t0 = time.perf_counter()
    _kernels.build_generated(sources, ("-Xptxas", "-v"))
    print(f"built {len(sources)} designs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    libs = []
    for cu in sources:
        lib = ctypes.CDLL(str(cu.with_suffix(".so")))
        P, N, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for name, args in (("p2_set_constants", (P, P, P)),
                           ("p2_merkle_tree", (P, P, N, P)),
                           ("p2_grind", (P, I, N, N, P, P))):
            getattr(lib, name).argtypes = list(args)
            getattr(lib, name).restype = I
        libs.append((lib, cu.with_suffix(".log").read_text()))
    return libs


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def events_ms(fn, iters: int) -> float:
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


def kernel_ms(fn, iters: int, name: str):
    """Mean device milliseconds of kernel ``name`` over ``iters`` calls of
    ``fn``, from ``torch.profiler``; None if it records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for row in prof.key_averages():
        if name in row.key and row.count and row.device_time_total:
            return row.device_time_total / 1e3 / row.count
    return None


def main() -> int:
    import numpy as np
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.ops import merkle
    from zkir_tpu_torch.ops import poseidon2 as p2
    from zkir_tpu_torch.ops.poseidon2 import _params_np
    from zkir_tpu_torch.tools.interp_bench import card

    args = sys.argv[1:]
    grind_blocks = DEFAULT_GRIND
    if "--grind" in args:
        grind_blocks = tuple(int(b)
                             for b in args[args.index("--grind") + 1:])
        args = args[:args.index("--grind")]
    trees = [tuple(int(v) for v in a.split(":")) for a in
             (args or DEFAULT_TREES)]
    port = (256, 64)        # the port's design
    designs = list(dict.fromkeys([(*t, 0) for t in trees]
                                 + [(*port, b) for b in grind_blocks]))
    print(card(), flush=True)
    libs = build(designs)
    consts = [np.ascontiguousarray(a, dtype=np.uint32) for a in _params_np()]

    rng = np.random.default_rng(SEED)
    trees_in = {log_n: torch.from_numpy(rng.integers(
        0, p2.P, (1 << log_n, 8), dtype=np.int64)).cuda()
        for log_n in (18, 17, 12, 6, 1, 2, 3, 4, 5, 7, 8, 9)}
    want = {log_n: torch.cat(merkle.build_tree_plain(x)[1:])
            for log_n, x in trees_in.items()}
    states = [[int(w) for w in rng.integers(0, p2.P, 16)] for _ in range(8)]
    nonces = [p2.grind(s, 16, "cuda") for s in states]

    # One permutation with a launch: the port's one-state p2_permute.
    one = trees_in[1][:1].repeat(1, 2).contiguous()
    one_out = torch.empty_like(one)
    perm_ms = events_ms(lambda: _kernels.launch(
        "p2_permute", one.data_ptr(), one_out.data_ptr(), 1), 500)
    print(json.dumps({"one_state_p2_permute_ms": perm_ms}), flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    for (threads, lane_nodes, blocks), (lib, log) in zip(designs, libs):
        check(lib.p2_set_constants(*(a.ctypes.data for a in consts)),
              "p2_set_constants")
        row = {"threads": threads, "lane_nodes": lane_nodes,
               "grind_blocks_per_sm": blocks,
               "ptxas": [line.strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line]}
        if blocks:
            row.update(grind(lib, stream, states, nonces, blocks))
        else:
            out, launches = {}, {}
            for log_n, leaves in trees_in.items():
                n = 1 << log_n
                nodes = torch.empty((n - 1, 8), dtype=torch.int64,
                                    device="cuda")

                def launch(leaves=leaves, nodes=nodes, n=n):
                    check(lib.p2_merkle_tree(leaves.data_ptr(),
                                             nodes.data_ptr(), n, stream),
                          "p2_merkle_tree")

                launches[log_n] = launch
                launch()
                torch.cuda.synchronize()
                if not torch.equal(nodes, want[log_n]):
                    raise AssertionError(f"design {threads}:{lane_nodes} "
                                         f"differs from build_tree_plain "
                                         f"at 2^{log_n}")
                out[log_n] = events_ms(launch, 50 if log_n >= 17 else 200)
            row["tree_ms"] = {f"2^{k}": out[k] for k in (18, 17, 12, 6)}
            # One CTA whose levels all run one way: 4 lanes a node, or a
            # thread a node where the design has no 4-lane levels.
            cta = [k for k in sorted(out)
                   if (1 << k) <= 2 * (lane_nodes or threads)]
            row["one_cta_tree_ms"] = {f"2^{k}": out[k] for k in cta}
            row["ms_a_level"] = ((out[cta[-1]] - out[cta[0]])
                                 / (cta[-1] - cta[0]))
            row["tree_kernel_ms_2^18"] = kernel_ms(launches[18], 20,
                                                   "merkle_tree_kernel")
        print(json.dumps(row), flush=True)
    return 0


def grind(lib, stream, states, nonces, blocks) -> dict:
    """``lib``'s ``p2_grind`` at 16 bits on each state: the nonces (equal
    to the port's ``nonces``), the whole call by the host clock and the
    kernel alone by ``torch.profiler``."""
    from zkir_tpu_torch.ops.poseidon2 import GRIND_LIMIT

    got, call_ms, kernel = [], [], []
    for state in states:
        words = (ctypes.c_uint32 * 16)(*state)
        nonce = ctypes.c_longlong(-1)

        def call(words=words, nonce=nonce):
            check(lib.p2_grind(words, 16, 0, GRIND_LIMIT,
                               ctypes.byref(nonce), stream), "p2_grind")

        call()
        got.append(nonce.value)
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        call_ms.append((time.perf_counter() - t0) / 20 * 1e3)
        kernel.append(kernel_ms(call, 20, "grind_kernel"))
    if got != nonces:
        raise AssertionError(f"p2_grind with {blocks} CTAs an SM found "
                             f"{got}, the port {nonces}")
    return {"grind_kernel_ms": kernel, "grind_call_ms": call_ms,
            "grind_trials": [n + 1 for n in nonces]}


if __name__ == "__main__":
    sys.exit(main())
