#!/usr/bin/env python3
"""Time the interpreter's crypto service rounds on the card, for this
checkout's package or another checkout's.

    python3 zkir_tpu_torch/tools/crypto_service_bench.py [--root DIR] \
        [--budget SECONDS] [--profile | --host-profile] LANES [LANES ...]

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


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=pathlib.Path, default=HERE)
    parser.add_argument("--budget", type=float, default=60.0)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--host-profile", action="store_true")
    parser.add_argument("lanes", type=int, nargs="+")
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
