#!/usr/bin/env python3
"""The interpreter kernel K3 on the card: where a machine cycle spends its
clocks, and each layout's rate by the number of lanes.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 zkir_tpu_torch/tools/interp_bench.py [--source FILE] [--warp 0|1] [--sweep]

Clocks: builds ``FILE`` (default ``zkir_tpu_torch/csrc/interp.cu``; it
must have the kernel's ``INTERP_CLOCKS`` stamps) twice into libraries of
its own under ``zkir_tpu_torch/_build/bench/``: as it is, and with
``-DINTERP_CLOCKS``, which turns on ``clock64()`` stamps between the
phases of a cycle (fetch, decode and operand read; execute; memory; trace
row; commit and the loop's branch), summed per phase over the run.  Then
runs one lane of the main path's program (``exact_trace_program(16)``)
for 1,024 cycles with a trace through the C entry point ``interp_run`` of
each library, in the layout the wrapper picks for one lane (or ``--warp
0|1``), and prints the kernel's milliseconds by CUDA events (launches
alone: the state is reset and the trace allocated outside the timed
span), the SM clocks a machine cycle takes in the stamped build, and its
split by phase.  The stamps add a few instructions and order the phases,
so the stamped total is near, not equal to, the unstamped kernel's time
(both are printed).

``--sweep``: cycles per second of both layouts (a thread per lane, a warp
per lane) on the reference benchmark's loop program, 512-cycle chunks,
from 1 to 65,536 lanes without a trace and from 1 to 1,024 with one:
where ``columnar.WARP_LANES`` and ``WARP_LANES_TRACED`` should lie.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

PHASES = ("fetch, decode, operands", "execute", "memory", "trace row",
          "commit and loop")
BUILD = ROOT / "zkir_tpu_torch" / "_build" / "bench"


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def build(source: pathlib.Path, clocks: bool) -> ctypes.CDLL:
    """``source`` in a library of its own; nvcc's ``-Xptxas -v`` report
    beside it (``.log``)."""
    from zkir_tpu_torch import _kernels

    text = source.read_text()
    if "INTERP_CLOCKS" not in text:
        raise ValueError(f"{source} has no INTERP_CLOCKS stamps")
    flags = [*_kernels.NVCC_FLAGS, *(["-DINTERP_CLOCKS"] if clocks else [])]
    key = hashlib.sha256((text + " ".join(flags)).encode()).hexdigest()[:16]
    BUILD.mkdir(parents=True, exist_ok=True)
    cu = BUILD / f"interp_{key}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        cu.write_text(text)
        res = subprocess.run([_kernels._nvcc(), *flags, "-Xptxas", "-v",
                              "-I", str(source.parent), "-o", str(so),
                              str(cu)], capture_output=True, text=True)
        cu.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.interp_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.interp_run.restype = ctypes.c_int
    if clocks:
        lib.zk_clocks_take.argtypes = [ctypes.c_void_p]
        lib.zk_clocks_take.restype = ctypes.c_int
    return lib


def clocks(source: pathlib.Path, warp=None, stamps: bool = True,
           cycles: int = 1024, iters: int = 20) -> dict:
    """One lane of the main path's program, ``cycles`` cycles with a
    trace, through ``source``'s ``interp_run`` in one layout (default:
    the wrapper's): kernel ms (CUDA events, mean of ``iters`` launches),
    and with ``stamps`` the stamped build's ms and SM clocks per machine
    cycle, by phase."""
    import torch

    from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter
    from zkir_tpu_torch.interp import columnar
    from zkir_tpu_torch.prover.benchtrace import exact_trace_program

    interp = TpuInterpreter(exact_trace_program(16), InterpConfig(
        lanes=1, chunk=cycles, collect_trace=True), device="cuda")
    state0 = interp.init_state([[]])
    stream = torch.cuda.current_stream().cuda_stream
    if warp is None:
        warp = columnar.warp_layout(1, True)
    out = {"source": str(source.relative_to(ROOT)
                         if source.is_relative_to(ROOT) else source),
           "cycles": cycles, "layout": "warp" if warp else "thread"}
    for stamped_build in (False, True)[:1 + stamps]:
        lib = build(source, stamped_build)
        total = 0.0
        for it in range(iters + 1):
            state = state0._replace(**{
                k: getattr(state0, k).clone() for k in columnar._MUTABLE})
            trace = columnar._new_trace(cycles, 1, "cuda")
            desc = columnar._descriptor(interp.code, interp.n_words, state,
                                        interp.config, trace,
                                        decoded=interp.decoded, warp=warp)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = lib.interp_run(ctypes.addressof(desc), stream)
            end.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"interp_run failed: error {err}")
            if int(state.cycles[0]) != cycles:
                raise AssertionError(f"ran {int(state.cycles[0])} cycles")
            if it:              # the first launch loads the module
                total += start.elapsed_time(end)
        if stamped_build:
            buf = (ctypes.c_ulonglong * 8)()
            if lib.zk_clocks_take(ctypes.addressof(buf)):
                raise RuntimeError("zk_clocks_take failed")
            per = [buf[k] / (cycles * (iters + 1)) for k in range(5)]
            out["clocks_per_cycle"] = sum(per)
            out["phases"] = dict(zip(PHASES, per))
            out["ms_stamped"] = total / iters
        else:
            out["ms"] = total / iters
    return out


def loop_program():
    """The reference benchmark's interpreter loop: six instructions, no
    memory."""
    from zkir_tpu_torch.spec import Instruction as I, Op, Program

    return Program.from_instructions([
        I(Op.ADDI, rd=1, rs1=0, imm=7), I(Op.ADD, rd=2, rs1=2, rs2=1),
        I(Op.MUL, rd=3, rs1=2, rs2=1), I(Op.XOR, rd=4, rs1=3, rs2=2),
        I(Op.SLT, rd=5, rs1=4, rs2=2), I(Op.JAL, rd=0, imm=-20)])


def loop_rate(lanes: int, warp: bool, lib=None, chunks: int = 3,
              trace: bool = False) -> dict:
    """The loop program on ``lanes`` lanes in one layout, 512-cycle chunks
    of ``interp_run`` launched in place on one state, with ``trace`` into
    one buffer of a chunk's rows (the kernel alone; from ``lib``, a
    library of ``build``, or else the port's): ms a chunk and cycles per
    second, by CUDA events."""
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter
    from zkir_tpu_torch.interp import columnar

    interp = TpuInterpreter(loop_program(), InterpConfig(
        lanes=lanes, chunk=512, low_bytes=1 << 13, stack_bytes=1 << 12,
        collect_trace=trace), device="cuda")
    state = interp.init_state([[1]] * lanes)
    rows = columnar._new_trace(512, lanes, "cuda") if trace else None
    desc = columnar._descriptor(interp.code, interp.n_words, state,
                                interp.config, rows, decoded=interp.decoded,
                                warp=warp)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if lib is None:
            _kernels.launch("interp_run", desc)
        elif lib.interp_run(ctypes.addressof(desc), stream):
            raise RuntimeError("interp_run failed")

    launch()                                         # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(chunks):
        launch()
    end.record()
    torch.cuda.synchronize()
    done = 512 * (chunks + 1)
    if bool((state.cycles != done).any()):
        raise AssertionError(f"the loop program ran {state.cycles.tolist()}"
                             f" cycles, not {done} a lane")
    ms = start.elapsed_time(end) / chunks
    return {"lanes": lanes, "layout": "warp" if warp else "thread",
            "trace": trace, "ms": ms,
            "cycles_per_s": 512 * lanes / (ms / 1e3)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", type=pathlib.Path,
                    default=ROOT / "zkir_tpu_torch" / "csrc" / "interp.cu")
    ap.add_argument("--warp", type=int, choices=(0, 1))
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    print(card())
    warp = None if args.warp is None else bool(args.warp)
    print(json.dumps(clocks(args.source.resolve(), warp)))
    if args.sweep:
        lib = build(args.source.resolve(), False)
        for lanes in (1, 2, 8, 32, 128, 256, 512, 1024, 2048, 4096, 8192,
                      65536):
            for warp in (True, False):
                print(json.dumps(loop_rate(lanes, warp, lib)))
                if lanes <= 1024:
                    print(json.dumps(loop_rate(lanes, warp, lib,
                                               trace=True)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
