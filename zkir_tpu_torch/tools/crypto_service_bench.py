#!/usr/bin/env python3
"""Time the interpreter's crypto service rounds on the card, for this
checkout's package or another checkout's.

    python3 zkir_tpu_torch/tools/crypto_service_bench.py [--root DIR] \
        [--budget SECONDS] [--profile | --host-profile] LANES [LANES ...]
    python3 zkir_tpu_torch/tools/crypto_service_bench.py [--root DIR] --ops

Runs ``chip_smoke.py``'s ``crypto_lanes_program`` (this checkout's: 376
tape words into a buffer, then SHA-256, Keccak-256, BLAKE3 and Poseidon2
over tape-given lengths, each input starting with the previous digest)
through the ``TpuInterpreter`` of the package under ``DIR`` (default:
this checkout) on ``cuda``, at the reference benchmark's interpreter shape
(``low_bytes`` 2^13, ``stack_bytes`` 2^12, chunk 512), at each lane count in
turn.  Prints the card's name and power limit, then one JSON line a
count: the seconds of ``TpuInterpreter.run``, each service round's paused
lanes, seconds (the device synchronised before and after) and launches,
and a SHA-256 of all outputs (equal across packages for equal counts).
With ``--profile`` the run is traced by ``torch.profiler`` (its seconds
then carry the tracer's cost): the device milliseconds of the twelve
kernels that took most, and of all kernels but the interpreter's (the
service rounds' device work); with ``--host-profile`` by ``cProfile``: the
host functions under the service rounds that took most, by their own
time.  A
count is skipped, and says so, where the previous count's run scaled by
the ratio of lanes would pass ``--budget`` (default 60 s).

With ``--ops`` it times the service's two slowest hashes alone instead, as
that package computes them: ``poseidon2.sponge_hash_rows`` over 16,384
rows of the program's lengths and over 4,096 x 3,000 bytes, and
``blake3.blake3_rows`` over 16,384 rows of those lengths, 65,536 x 1,025 and
4,096 x 3,000 bytes, on bytes made from a seed (the same for every
package): one JSON line a case with the call's milliseconds (CUDA events
around 20 calls, the host's work included), the device milliseconds of
all its kernels and copies and of each by name (``torch.profiler``), its
launches by kernel, and a SHA-256 of its digests (equal across
packages).
"""

import argparse
import contextlib
import hashlib
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[2]


def ops(smoke, root) -> None:
    """``--ops``: see the module's docstring."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.ops import blake3, poseidon2

    gen = torch.Generator(device="cuda")
    gen.manual_seed(smoke.SEED)
    rng = np.random.default_rng(smoke.SEED)
    mix = rng.choice(smoke.CRYPTO_LENGTHS, 16384)
    cases = (("sponge_hash_rows", poseidon2.sponge_hash_rows, mix),
             ("sponge_hash_rows", poseidon2.sponge_hash_rows,
              np.full(4096, 3000)),
             ("blake3_rows", blake3.blake3_rows, mix),
             ("blake3_rows", blake3.blake3_rows, np.full(65536, 1025)),
             ("blake3_rows", blake3.blake3_rows, np.full(4096, 3000)))
    for name, fn, lengths in cases:
        offsets = np.cumsum(lengths) - lengths + np.arange(lengths.size) % 3
        data = torch.randint(0, 256, (int((offsets + lengths).max()),),
                             generator=gen, device="cuda", dtype=torch.uint8)

        def call():
            return fn(data, offsets, lengths)

        digests = call().cpu().numpy()
        before = dict(_kernels.launches)
        call()
        launches = {k: v - before.get(k, 0) for k, v in
                    _kernels.launches.items() if v != before.get(k, 0)}
        ms = smoke.cuda_ms(call, 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        by_name = {r.key.split("(")[0]: r.device_time_total / 1e3 / 20
                   for r in prof.key_averages() if r.device_time_total}
        print(json.dumps({
            "root": str(root), "op": name, "rows": int(lengths.size),
            "bytes": int(lengths.sum()), "ms": ms,
            "device_ms": sum(by_name.values()), "device_by_name": by_name,
            "launches": launches,
            "digests_sha256": hashlib.sha256(digests.tobytes()).hexdigest()}),
            flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=pathlib.Path, default=HERE)
    parser.add_argument("--budget", type=float, default=60.0)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--host-profile", action="store_true")
    parser.add_argument("--ops", action="store_true")
    parser.add_argument("lanes", type=int, nargs="*")
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter

    if not torch.cuda.is_available():
        raise SystemExit("crypto_service_bench: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.ops:
        ops(smoke, args.root)
        return
    program = smoke.crypto_lanes_program()
    last = None
    for lanes in args.lanes:
        if last and last[1] * lanes / last[0] > args.budget:
            print(json.dumps({"root": str(args.root), "lanes": lanes,
                              "skipped": f"{last[1]:.1f} s at {last[0]} "
                                         f"lanes"}), flush=True)
            continue
        tapes = smoke.crypto_tapes(lanes, smoke.SEED)
        interp = TpuInterpreter(program, InterpConfig(
            lanes=lanes, chunk=512, low_bytes=1 << 13, stack_bytes=1 << 12,
            max_inputs=tapes.shape[1]), device="cuda")
        lists = tapes.tolist()
        rounds = []
        torch.cuda.synchronize()
        trace = contextlib.nullcontext()
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            trace = profile(activities=[ProfilerActivity.CUDA])
        elif args.host_profile:
            import cProfile
            trace = cProfile.Profile()
        t0 = time.perf_counter()
        with trace as prof, smoke.service_rounds(rounds):
            result = interp.run(lists)
        run_s = time.perf_counter() - t0
        outputs = np.asarray(result["outputs"], dtype=np.uint64)
        last = (lanes, run_s)
        record = {
            "root": str(args.root), "lanes": lanes, "run_s": run_s,
            "service_s": sum(r["s"] for r in rounds), "rounds": rounds,
            "halted": sorted(set(result["halted"].tolist())),
            "outputs_sha256": hashlib.sha256(outputs.tobytes()).hexdigest()}
        if args.host_profile:
            import pstats
            stats = pstats.Stats(prof).stats
            record["host_s_top"] = sorted(
                ((f"{path.rsplit('/', 1)[-1]}:{line}:{fn}", tt, calls)
                 for (path, line, fn), (calls, _, tt, _, _) in stats.items()),
                key=lambda r: -r[1])[:25]
        elif prof is not None:
            rows = sorted(((r.key, r.device_time_total / 1e3, r.count)
                           for r in prof.key_averages()
                           if r.device_time_total), key=lambda r: -r[1])
            record["device_ms_top"] = rows[:12]
            record["device_ms_service"] = sum(
                ms for key, ms, _ in rows if "interp_kernel" not in key)
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
