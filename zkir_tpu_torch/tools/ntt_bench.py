#!/usr/bin/env python3
"""Time variants of the CUDA NTT kernel side by side on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc::

    python3 zkir_tpu_torch/tools/ntt_bench.py "" NTT_THREADS=256 \
        NTT_TAU=3,NTT_THREADS=256 NTT_SKIP_STAGES

Each argument is one variant: a comma-separated list of ``-D`` macros for
``csrc/ntt.cu`` (the empty string is the kernel as committed).  Every
variant is built into its own library, all builds started together, and
timed with CUDA events, in two rounds over all variants, at the prover's
shapes: forward [493, 2^18], inverse [493, 2^16] from real input with the
1/n scale, and the LDE's forward transform (2^16 coefficients into 2^18
with the coset shift).  Each variant's forward result is compared with the
first variant's (``NTT_SKIP_STAGES`` must differ: it has no butterflies).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

P = (1 << 31) - 1


def main() -> int:
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.ops import ntt
    from zkir_tpu_torch.spec.field import m31_inv

    variants = [a.split(",") if a else [] for a in sys.argv[1:]] or [[]]
    flags = [f for f in _kernels.NVCC_FLAGS if f not in ("--threads", "0")]
    tmp = tempfile.mkdtemp(prefix="ntt_bench_")
    builds = []
    for i, macros in enumerate(variants):
        so = f"{tmp}/ntt_{i}.so"
        cmd = [_kernels._nvcc(), *flags, *(f"-D{m}" for m in macros),
               "-o", so, str(_kernels.CSRC / "ntt.cu")]
        builds.append((so, macros, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def words(shape):
        return torch.randint(0, P, shape, generator=gen, device="cuda",
                             dtype=torch.int64)

    def ms(fn, iters=5):
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

    libs = []
    for so, macros, proc in builds:
        out = proc.communicate()[0]
        if proc.returncode:
            print(macros, "build failed:", out[-3000:])
            return 1
        lib = ctypes.CDLL(so)
        lib.cm31_ntt.argtypes = [*_kernels._SIGNATURES["cm31_ntt"],
                                 ctypes.c_void_p]
        lib.cm31_ntt.restype = ctypes.c_int
        libs.append((macros, lib))

    def run(lib, re, im, log_n, inverse, pre=None, scale=1):
        n = 1 << log_n
        o_re = torch.empty(re.shape[0], n, dtype=torch.int64, device="cuda")
        o_im = torch.empty_like(o_re)
        tw = ntt._on_device(("twiddles_u32", (log_n, inverse)), re.device)
        table = None if pre is None else ntt._on_device(
            ("shift_u32", (tuple(pre), log_n)), re.device).data_ptr()
        err = lib.cm31_ntt(
            re.data_ptr(), None if im is None else im.data_ptr(),
            re.stride(0), re.shape[1], o_re.data_ptr(), o_im.data_ptr(),
            tw.data_ptr(), table, None, re.shape[0], log_n, scale,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cm31_ntt failed: error {err}")
        return o_re, o_im

    big = (words((493, 1 << 18)), words((493, 1 << 18)))
    cols = words((493, 1 << 16))
    shift = ntt._find_generator()
    n_inv = m31_inv(1 << 16)
    want = None
    for rnd in range(2):
        for macros, lib in libs:
            forward = ms(lambda: run(lib, big[0], big[1], 18, False))
            inverse = ms(lambda: run(lib, cols, None, 16, True, scale=n_inv))
            coef = run(lib, cols, None, 16, True, scale=n_inv)
            lde = ms(lambda: run(lib, coef[0], coef[1], 18, False, pre=shift))
            got = run(lib, big[0], big[1], 18, False)
            want = want or got
            same = torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            print(f"round {rnd} {macros or 'as committed'}: forward "
                  f"[493, 2^18] {forward:.3f} ms, inverse [493, 2^16] "
                  f"{inverse:.3f} ms, LDE forward 2^16 -> 2^18 {lde:.3f} ms, "
                  f"equal to the first variant: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
