#!/usr/bin/env python3
"""``zkir_tpu_torch.parallel`` on meshes of 1, 2, 4 ... GPUs.

Run from the repository root on a machine with several NVIDIA GPUs::

    python3 zkir_tpu_torch/tools/mesh_bench.py [--ranks 4] [--iters 5]
        [--out FILE]

It spawns ``--ranks`` processes (rank r drives ``cuda:r``) in one NCCL
world and makes meshes of its first 1, 2, 4 ... ranks (``make_mesh(n)``;
the other ranks wait).  On each mesh it runs the distributed entry
points at the shapes of ``chip_smoke.py``'s ``mesh`` phase: ``dist_ntt``
(each rank's rows of Z) and ``dist_ntt_natural`` (the natural order
gathered on every rank) of one CM31 column of 2^24, ``dist_lde`` of
[596, 2^16] -> 2^18, ``dist_merkle_root`` of [2^18, 1192] and
``prove_step_sharded`` on the loop program at 65,536 lanes, chunk 512,
log_n 24.  Each result is gathered and held word for word against the
single-device port on the first rank's card; each call is then timed by
CUDA events, ``--iters`` calls a rank back to back after a barrier
(``ms``: the slowest rank's mean) and ``--iters`` calls each after a
barrier (``ms_aligned``: the slowest rank's median).  Each rank's
launches of each entry point are recorded (counts set to 0 just before
the call, read just after), and the first rank's device time by kernel
for the two NTTs (``torch.profiler``).  The single-device composition is
timed on the first card beside the one-rank mesh.  One JSON line per mesh
size, after the card's name and power limit; ``--out`` appends the lines
to a file.

``--prove`` times the sharded prover instead, on the same meshes: the
2^16 main path (``exact_trace_program(16)``, interpreted on each rank's
card) proved one-shot with its program bound (``prove_trace(mesh=)``,
``FriConfig()``), and 2^20 rows by streaming (``prove_trace_streaming(
mesh=, col_block=64)``).  Each path is first proved on one card without a
mesh (the first rank alone), then on meshes of 1, 2, 4 ... ranks: a first
prove and warm ones (five at 2^16, three at 2^20), each started after a
barrier and ended by ``torch.cuda.synchronize()``; every rank's seconds,
launches and peak device memory, and whether its proof is the one card's,
word for word (the SHA-256 of the proof's JSON).  The parent builds the
quotient's parts of both paths before it starts the ranks.

``--device cpu --small`` runs the same on gloo ranks at small shapes
(``--prove``: 2^10 rows on both paths): a dry run of the tool without a
GPU.  ``chip_smoke.py``'s ``mesh`` phase drives the same entry points
through ``setup``, ``run_counted``, ``whole`` and ``as_tuple``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]
P = (1 << 31) - 1
SEED = 20261018
SHAPES = {
    # chip_smoke.py's mesh phase (a) and this tool: full width.
    "full": {"log_ntt": 24, "lde": (596, 16), "merkle": (1 << 18, 1192),
             "lanes": 65536, "log_step": 24},
    # chip_smoke.py's mesh phase (b): gloo ranks sharing one card.
    "gloo": {"log_ntt": 20, "lde": (64, 16), "merkle": (1 << 16, 64),
             "lanes": 8192, "log_step": 16},
    # This tool's dry run on gloo CPU ranks.
    "small": {"log_ntt": 12, "lde": (16, 8), "merkle": (256, 16),
              "lanes": 64, "log_step": 12},
}
# The kernels each entry point launches on a card; a tree of two leaves or
# more is one p2_merkle_tree launch (a rank's subtree, and the top tree on
# a mesh of more than one rank).
KERNELS = {
    "dist_ntt": {"cm31_ntt", "cm31_binary"},
    "dist_ntt_natural": {"cm31_ntt", "cm31_binary"},
    "dist_lde": {"cm31_ntt"},
    "dist_merkle_root": {"p2_sponge_rows", "p2_merkle_tree"},
    "prove_step_sharded": {"interp_run", "cm31_ntt", "cm31_binary",
                           "p2_sponge_rows", "p2_merkle_tree"},
}
ENTRY_POINTS = tuple(KERNELS)
# The entry points whose device time each kernel takes (the collectives'
# among them) is profiled on the first rank.
PROFILED = ("dist_ntt", "dist_ntt_natural")
# --prove: (path, log_rows, warm proves) at each size.
PROVES = {"full": (("one-shot", 16, 5), ("streaming", 20, 3)),
          "small": (("one-shot", 10, 1), ("streaming", 10, 1))}


def step_interp(lanes: int, device):
    """The reference benchmark's interpreter (``bench.py:76-85``): the loop
    program, chunks of 512 cycles, on ``device``."""
    from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter
    from zkir_tpu_torch.tools.interp_bench import loop_program

    return TpuInterpreter(loop_program(), InterpConfig(
        lanes=lanes, chunk=512, low_bytes=1 << 13, stack_bytes=1 << 12),
        device=device)


def single_step(interp, state, log_n: int):
    """``prove_step_sharded``'s composition on one device: the chunk, the
    column, ``cm31_ntt`` in natural order laid out as Z [n1, n2]
    (X[k1 + n1*k2] = Z[k1, k2]), its rows hashed into one tree."""
    import torch

    from zkir_tpu_torch.ops import merkle, ntt

    new, _ = interp.chunk_fn(state)
    col = new.regs.reshape(-1) & 0xFFFFF
    n = 1 << log_n
    col = col.repeat(n // col.numel() + 1)[:n] % P
    xr, xi = ntt.ntt(col, torch.zeros_like(col), log_n)
    n1 = 1 << (log_n // 2)
    rows = torch.stack([xr.view(-1, n1).T.reshape(-1),
                        xi.view(-1, n1).T.reshape(-1)], dim=1)
    return new, merkle.build_tree(merkle.hash_rows(rows))[-1][0]


def setup(mesh, shape: dict):
    """Seeded inputs at ``shape`` on the mesh's device (the same words in
    every process), the step's interpreter, state and this rank's shard:
    (this rank's call of each entry point, the single-device version of
    each), zero-argument calls by entry point."""
    import torch

    from zkir_tpu_torch import parallel as par
    from zkir_tpu_torch.ops import merkle, ntt
    from zkir_tpu_torch.prover.prover import _coset_shift

    device = mesh.device
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)

    def words(size):
        return torch.randint(0, P, size, generator=gen, device=device,
                             dtype=torch.int64)

    log_ntt, (c, log_lde) = shape["log_ntt"], shape["lde"]
    re, im = words((1 << log_ntt,)), words((1 << log_ntt,))
    cols, rows = words((c, 1 << log_lde)), words(shape["merkle"])
    interp = step_interp(shape["lanes"], device)
    state = interp.init_state([[1]] * shape["lanes"])
    shard = par.sharded_interpreter_state(state, mesh)
    k = rows.shape[0] // mesh.size()
    shift = _coset_shift()
    n1 = 1 << (log_ntt // 2)
    on_mesh = {
        "dist_ntt": lambda: par.dist_ntt(re, im, mesh, log_ntt),
        "dist_ntt_natural": lambda: par.dist_ntt_natural(re, im, mesh,
                                                         log_ntt),
        "dist_lde": lambda: par.dist_lde(cols, None, mesh, log_lde, 2,
                                         shift=shift),
        "dist_merkle_root": lambda: par.dist_merkle_root(
            rows[mesh.index * k:(mesh.index + 1) * k], mesh),
        "prove_step_sharded": lambda: par.prove_step_sharded(
            interp, shard, mesh, log_n=shape["log_step"]),
    }
    single = {
        "dist_ntt": lambda: tuple(x.view(-1, n1).T.contiguous()
                                  for x in ntt.ntt(re, im, log_ntt)),
        "dist_ntt_natural": lambda: ntt.ntt(re, im, log_ntt),
        "dist_lde": lambda: ntt.lde(cols, None, log_lde, 2, shift=shift),
        "dist_merkle_root": lambda: merkle.build_tree(
            merkle.hash_rows(rows))[-1][0],
        "prove_step_sharded": lambda: single_step(interp, state,
                                                  shape["log_step"]),
    }
    return on_mesh, single


def run_counted(calls: dict, cuda: bool):
    """Each call with every launch count set to 0 just before it and read
    just after: (results, launches), by entry point."""
    import torch

    from zkir_tpu_torch import _kernels

    out, launches = {}, {}
    for name, fn in calls.items():
        if cuda:
            torch.cuda.synchronize()
        _kernels.reset_launches()
        out[name] = fn()
        if cuda:
            torch.cuda.synchronize()
        launches[name] = {k: v for k, v in _kernels.launches.items() if v}
    return out, launches


def launch_problems(launches: dict, d: int) -> list:
    """The entry points that launched other kernels than ``KERNELS``
    says on a mesh of ``d`` ranks, with what they launched."""
    trees = 1 + (d > 1)
    return [(name, got) for name, got in launches.items()
            if set(got) != KERNELS[name]
            or got.get("p2_merkle_tree", trees) != trees]


def as_tuple(name: str, result) -> tuple:
    """A single-device result as the tensors to compare."""
    if name == "dist_merkle_root":
        return (result,)
    if name == "prove_step_sharded":
        return result[0].regs, result[0].cycles, result[1]
    return tuple(result)


def whole(name: str, got, mesh) -> tuple:
    """The whole result of one entry point from this rank's part, on
    every rank (collective), as the tensors to compare."""
    from zkir_tpu_torch.parallel.distributed import all_gather_rows

    if name in ("dist_ntt", "dist_lde"):
        return tuple(all_gather_rows(t, mesh) for t in got)
    if name == "prove_step_sharded":
        new_state, root = got
        return (all_gather_rows(new_state.regs, mesh),
                all_gather_rows(new_state.cycles, mesh), root)
    return as_tuple(name, got)


def same(got: tuple, want: tuple) -> bool:
    import torch

    return len(got) == len(want) and all(
        g.shape == w.shape and bool(torch.equal(g, w))
        for g, w in zip(got, want))


def _sync(mesh, cuda: bool) -> None:
    """Wait for this rank's card, then for every rank of the mesh."""
    import torch
    import torch.distributed as dist

    if cuda:
        torch.cuda.synchronize()
    dist.barrier(group=mesh.group)
    if cuda:
        torch.cuda.synchronize()


def _timed(fn, mesh, iters: int, cuda: bool):
    """Milliseconds of ``fn()`` on this rank: the mean of ``iters`` calls
    back to back after a barrier of the mesh, and the median of ``iters``
    calls each started after a barrier (the ranks start it together, so
    a collective waits less on a late rank); CUDA events, or the host
    clock on the CPU."""
    import statistics
    import time

    import torch

    def clock(n):
        if not cuda:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) / n * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    fn()
    _sync(mesh, cuda)
    back_to_back = clock(iters)
    aligned = []
    for _ in range(iters):
        _sync(mesh, cuda)
        aligned.append(clock(1))
    return back_to_back, statistics.median(aligned)


def _device_ms(fn, mesh) -> dict:
    """The first rank's mean device milliseconds a call spends in each
    kernel (``torch.profiler``; a collective's kernel includes its wait
    for the other ranks), three calls each started after a barrier; on
    the others the same calls unprofiled, and ``{}``."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    first = mesh.index == 0
    with (profile(activities=[ProfilerActivity.CUDA]) if first
          else contextlib.nullcontext()) as prof:
        for _ in range(3):
            _sync(mesh, True)
            fn()
        _sync(mesh, True)
    if not first:
        return {}
    return {row.key: row.device_time_total / 1e3 / 3
            for row in prof.key_averages() if row.device_time_total}


def _on_mesh(mesh, shape: dict, iters: int, cuda: bool) -> dict:
    """The entry points on ``mesh`` from this rank: exactness against one
    device (on the mesh's first rank), each rank's launches, the slowest
    rank's times; and the single-device times on a mesh of one rank."""
    import torch
    import torch.distributed as dist

    from zkir_tpu_torch.parallel.distributed import all_gather_rows

    calls, single = setup(mesh, shape)
    got, launches = run_counted(calls, cuda)
    out = {"ranks": mesh.size(), "entry_points": {}}
    for name in ENTRY_POINTS:
        parts = whole(name, got.pop(name), mesh)
        exact = (same(parts, as_tuple(name, single[name]()))
                 if mesh.index == 0 else None)
        del parts
        ms = torch.tensor([_timed(calls[name], mesh, iters, cuda)],
                          dtype=torch.float64, device=mesh.device)
        by_rank = all_gather_rows(ms, mesh).tolist()   # [[mean, median]]
        all_launches = [None] * mesh.size()
        dist.all_gather_object(all_launches, launches[name],
                               group=mesh.group)
        if cuda and mesh.index == 0:
            exact = exact and not any(
                launch_problems({name: c}, mesh.size()) for c in all_launches)
        entry = {"ms": max(r[0] for r in by_rank),
                 "ms_aligned": max(r[1] for r in by_rank),
                 "ms_by_rank": by_rank, "launches_by_rank": all_launches,
                 "exact": exact}
        if mesh.index == 0 and mesh.size() == 1:
            entry["single_ms"], entry["single_ms_aligned"] = _timed(
                single[name], mesh, iters, cuda)
        if cuda and name in PROFILED:
            entry["first_rank_device_ms"] = _device_ms(calls[name], mesh)
        out["entry_points"][name] = entry
    return out


def _prove_fn(path: str, log_rows: int, device: str):
    """The 2^log_rows main path's prove of ``path`` as a function of the
    mesh (``None``: one device)."""
    from zkir_tpu_torch.prover import FriConfig, prove_trace
    from zkir_tpu_torch.prover.benchtrace import (exact_trace_matrix,
                                                  exact_trace_program)
    from zkir_tpu_torch.prover.streaming import prove_trace_streaming

    program = exact_trace_program(log_rows)
    matrix = exact_trace_matrix(log_rows, device=device)

    def prove(mesh):
        if path == "streaming":
            return prove_trace_streaming(matrix, FriConfig(), program=program,
                                         col_block=64, mesh=mesh,
                                         device=device)
        return prove_trace(matrix, FriConfig(), range_lookup=True,
                           program=program, mesh=mesh, device=device)
    return prove


def _proves(rank: int, world: int, device: str, proves) -> list:
    """``--prove`` on this rank: each path on one device (the first rank),
    then on meshes of 1, 2, 4 ... ranks; the first rank's lines."""
    import hashlib
    import time

    import torch
    import torch.distributed as dist

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch import parallel as par
    from zkir_tpu_torch.convert import proof_to_json

    cuda = device == "cuda"
    lines = []
    for path, log_rows, iters in proves:
        prove = _prove_fn(path, log_rows, device)
        size = 0                # 0: one device, no mesh, the first rank
        while size <= world:
            mesh = par.make_mesh(size, device=device) if size else None
            rec = None
            if (mesh.index is not None) if size else rank == 0:
                runs = []
                for _ in range(1 + iters):
                    if mesh is not None:
                        _sync(mesh, cuda)
                    if cuda:
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                    _kernels.reset_launches()
                    t0 = time.perf_counter()
                    proof = prove(mesh)
                    if cuda:
                        torch.cuda.synchronize()
                    runs.append({
                        "s": time.perf_counter() - t0,
                        "launches": sum(_kernels.launches.values()),
                        "peak_bytes": (torch.cuda.max_memory_allocated()
                                       if cuda else None),
                        "sha256": hashlib.sha256(
                            proof_to_json(proof).encode()).hexdigest()})
                    del proof
                rec = {"first_s": runs[0]["s"],
                       "warm_s": [r["s"] for r in runs[1:]],
                       "launches": [r["launches"] for r in runs],
                       "peak_bytes": max(r["peak_bytes"] or 0 for r in runs),
                       "sha256": sorted({r["sha256"] for r in runs})}
            got = [None] * world
            dist.all_gather_object(got, rec)
            if rank == 0:
                lines.append({"path": path, "log_rows": log_rows,
                              "ranks": size or "one device",
                              "by_rank": [g for g in got if g is not None]})
            dist.barrier()
            size = size * 2 if size else 1
        del prove
        if cuda:
            torch.cuda.empty_cache()
    for line in lines:
        want = next(x for x in lines if x["path"] == line["path"]
                    and x["ranks"] == "one device")["by_rank"][0]["sha256"]
        line["exact"] = all(r["sha256"] == want for r in line["by_rank"])
        by_rank = line["by_rank"]
        line["first_s"] = max(r["first_s"] for r in by_rank)
        line["warm_s"] = [max(r["warm_s"][k] for r in by_rank)
                          for k in range(len(by_rank[0]["warm_s"]))]
    return lines


def _rank(rank: int, world: int, port: int, device: str, shape: dict,
          iters: int, out_dir: str, proves=None) -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from zkir_tpu_torch import parallel as par

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    par.join_local_group(port, rank, world, "nccl" if cuda else "gloo",
                         timeout=datetime.timedelta(seconds=300))
    lines = []
    try:
        if proves:
            lines = _proves(rank, world, device, proves)
        size = 1
        while size <= world and not proves:
            mesh = par.make_mesh(size, device=device)
            if mesh.index is not None:
                lines.append(_on_mesh(mesh, shape, iters, cuda))
            dist.barrier()
            size *= 2
    finally:
        dist.destroy_process_group()
    if rank == 0:
        pathlib.Path(out_dir, "lines.json").write_text(json.dumps(lines))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--prove", action="store_true",
                    help="time the sharded prover instead")
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    proves = PROVES["small" if args.small else "full"] if args.prove else None
    import torch
    import torch.multiprocessing as mp

    sys.path.insert(0, str(ROOT))
    from zkir_tpu_torch.parallel import rendezvous_store

    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"mesh_bench: {args.ranks} ranks need as many "
                             f"GPUs, {torch.cuda.device_count()} found")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(card, flush=True)
        from zkir_tpu_torch import _kernels
        from zkir_tpu_torch.prover import quotient_codegen

        _kernels.build()
        if proves:
            # Both paths' parts, built once here for every rank.
            quotient_codegen.prepare(quotient_codegen.plan_key(True, True, 2),
                                     quotient_codegen.plan_key(True, True, 0))
    store = rendezvous_store()   # held until the ranks have returned
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank, args=(args.ranks, store.port, args.device,
                         SHAPES["small" if args.small else "full"],
                         args.iters, tmp, proves),
            nprocs=args.ranks, start_method="spawn")
        lines = json.loads(pathlib.Path(tmp, "lines.json").read_text())
    for line in lines:
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    bad = [(line["ranks"], line["path"]) for line in lines
           if not line.get("exact", True)]
    bad += [(line["ranks"], name) for line in lines
            for name, e in line.get("entry_points", {}).items()
            if not e["exact"]]
    if bad:
        print(f"mesh_bench: results differ from one device's: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
