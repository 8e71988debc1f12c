#!/usr/bin/env python3
"""Time builds of the CUDA NTT kernel side by side on one GPU.

Run from the repository root on a machine with an NVIDIA GPU and nvcc.
The run of this repository's records: the kernel this design replaced
(copied out of git first) against the committed one, the copies and
exchanges alone, 16-byte first-pass copies, 16-byte stores, both, no
ring, two blocks an SM, tiles of 2^13 points at 16 a thread, and the
plan of two passes of up to 9 stages with tiles narrowed below 264::

    git show 2781045:zkir_tpu_torch/csrc/ntt.cu > .chip_scratch/ntt_parent.cu
    python3 zkir_tpu_torch/tools/ntt_bench.py .chip_scratch/ntt_parent.cu \
        "" NTT_SKIP_STAGES NTT_WIDE_LOADS NTT_WIDE_STORES \
        NTT_WIDE_LOADS,NTT_WIDE_STORES NTT_STAGES=1 NTT_MIN_BLOCKS=2 \
        tile=13,NTT_POINTS_LOG=4 pass=9,min_tiles=264

Each argument is one variant: a path ending in ``.cu`` is a source file
built as it is (a source without ``NttPass`` is called through the
parent's interface: no plan, int64 coefficients between the LDE's two
launches); anything else is a comma-separated list of ``-D`` macros for
``csrc/ntt.cu`` and of plan sizes ``tile=``, ``pass=`` and ``min_tiles=``
(the arguments of ``ops/ntt.py`` ``ntt_plan``); the empty string is the
kernel as committed.  Every source is built into its own library, all
builds started together, and each timed in two rounds over all variants:
the device time of a call, the calls queued behind a sleep kernel so the
host's cost of a call is not in it (the plans are made once, as the
wrapper caches them).  The shapes are the prover's and the benchmark's:
forward [596, 2^18] and [493, 2^18]; inverse [596, 2^16] and [493, 2^16]
of real input with the 1/n scale; ``lde`` [596, 2^16], [493, 2^16] and
[238, 2^16] into 2^18 with the coset shift (two launches); the quotient's
one column, ``coset_intt`` [1, 2^18], and one chunk of it, ``coset_ntt``
of a 2^16 slice into 2^18; the streaming prover's block, ``intt`` then
``coset_ntt`` at [64, 2^16] and [64, 2^20]; one column of 2^24 forward;
and a forward [64, 2^16] of rows 2^17 words apart.  Each result is
compared word for word with the first variant's (``NTT_SKIP_STAGES`` must
differ: it has no butterflies).  The card's name and power limit come
first, then a yardstick: one contiguous copy (``Tensor.copy_``) of the
forward's input words into its output, the card's memory rate on these
bytes.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

P = (1 << 31) - 1
SLEEP_CYCLES = 40_000_000   # about 20 ms of the card's clock
# Plan sizes a variant may set: the arguments of ops/ntt.py ``ntt_plan``.
PLAN_SIZES = {"tile": "tile_log", "pass": "pass_log", "min_tiles": "min_tiles"}


def main() -> int:
    import torch

    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.ops import ntt
    from zkir_tpu_torch.prover.prover import _coset_shift
    from zkir_tpu_torch.spec.field import m31_inv

    flags = [f for f in _kernels.NVCC_FLAGS if f not in ("--threads", "0")]
    tmp = tempfile.mkdtemp(prefix="ntt_bench_")
    variants = []
    for i, arg in enumerate(sys.argv[1:] or [""]):
        if arg.endswith(".cu"):
            source, macros, plan = pathlib.Path(arg), [], {}
        else:
            parts = [a for a in arg.split(",") if a]
            source = _kernels.CSRC / "ntt.cu"
            plan = {PLAN_SIZES[a.split("=")[0]]: int(a.split("=")[1])
                    for a in parts if a.split("=")[0] in PLAN_SIZES}
            macros = [a for a in parts if a.split("=")[0] not in PLAN_SIZES]
        so = f"{tmp}/ntt_{i}.so"
        cmd = [_kernels._nvcc(), *flags, "-Xptxas", "-v", "-I",
               str(_kernels.CSRC),
               *(f"-D{m}" for m in macros), "-o", so, str(source)]
        variants.append({
            "name": arg or "as committed", "so": so, "plan": plan,
            "legacy": "NttPass" not in source.read_text(),
            "proc": subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    for v in variants:
        out = v["proc"].communicate()[0]
        if v["proc"].returncode:
            print(v["name"], "build failed:", out[-3000:])
            return 1
        kernels = re.findall(r"entry function '(\w+)'", out)
        used = re.findall(r"Used (\d+) registers", out)
        spills = re.findall(r"(\d+) bytes spill stores", out)
        print(v["name"], "registers:", ", ".join(
            f"{k[-30:]} {u} ({s} B spilled)"
            for k, u, s in zip(kernels, used, spills)))
        lib = ctypes.CDLL(v["so"])
        sig = list(_kernels._SIGNATURES["cm31_ntt"])
        if v["legacy"]:     # no output row stride, mid or plan; a table
            sig = sig[:6] + sig[7:8] + sig[8:13]
        lib.cm31_ntt.argtypes = [*sig, ctypes.c_void_p]
        lib.cm31_ntt.restype = ctypes.c_int
        v["lib"] = lib

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def words(shape):
        return torch.randint(0, P, shape, generator=gen, device="cuda",
                             dtype=torch.int64)

    def ms(fn, iters=5):
        """Device time a call: the calls run back to back behind a sleep
        kernel, so the host has queued them all before the first starts."""
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    stream = torch.cuda.current_stream().cuda_stream
    halves, plans = {}, {}

    def half_table(log_n, inverse):
        """The parent's twiddles: w^0 .. w^(n/2 - 1) as uint32 pairs."""
        if (log_n, inverse) not in halves:
            twr, twi = ntt._twiddle_table(log_n, inverse)
            half = (1 << log_n) // 2
            halves[log_n, inverse] = ntt._pairs_u32(twr[:half], twi[:half],
                                                    "cuda")
        return halves[log_n, inverse].data_ptr()

    def call(v, in_re, in_im, stride, in_len, out_re, out_im, out_stride,
             batch, log_n, inverse, pre=None, scale=1, flags=0, mid=None,
             post=None):
        table, post_table = (None if sh is None else ntt._on_device(
            ("shift_u32", (tuple(sh), log_n)), "cuda").data_ptr()
            for sh in (pre, post))
        if v["legacy"]:
            args = (in_re, in_im, stride, in_len, out_re, out_im,
                    half_table(log_n, inverse), table, post_table, batch,
                    log_n, scale)
        else:
            key = (v["name"], log_n, batch, in_len, flags, inverse)
            if key not in plans:
                plans[key] = ntt.plan_words(
                    ntt.ntt_plan(log_n, batch, in_len, **v["plan"]), flags,
                    log_n, inverse, torch.device("cuda"))
            plan = plans[key]
            args = (in_re, in_im, stride, in_len, out_re, out_im, out_stride,
                    mid or out_re, table, post_table, batch, log_n, scale,
                    plan.ctypes.data)
        err = v["lib"].cm31_ntt(*args, stream)
        if err:
            raise RuntimeError(f"{v['name']}: cm31_ntt failed: error {err}")

    def transform(v, re, im, log_n, inverse, pre=None, scale=1, out=None,
                  post=None):
        batch, n = re.shape[0], 1 << log_n
        o = out or (torch.empty((batch, n), dtype=torch.int64, device="cuda"),
                    torch.empty((batch, n), dtype=torch.int64, device="cuda"))
        call(v, re.data_ptr(), None if im is None else im.data_ptr(),
             re.stride(0), re.shape[1], o[0].data_ptr(), o[1].data_ptr(), n,
             batch, log_n, inverse, pre, scale, post=post)
        return o

    def lde(v, re, log_n, log_blowup, shift):
        batch, big = re.shape[0], log_n + log_blowup
        n_inv = m31_inv(1 << log_n)
        if v["legacy"]:
            c = transform(v, re, None, log_n, True, scale=n_inv)
            return transform(v, c[0], c[1], big, False, pre=shift)
        N = 1 << big
        o = (torch.empty((batch, N), dtype=torch.int64, device="cuda"),
             torch.empty((batch, N), dtype=torch.int64, device="cuda"))
        coef = o[1].data_ptr()
        call(v, re.data_ptr(), None, re.stride(0), 1 << log_n, coef, None, N,
             batch, log_n, True, scale=n_inv, flags=ntt.FLAG_OUT_PAIRS,
             mid=o[0].data_ptr(), post=shift)
        call(v, coef, None, N, 1 << log_n, o[0].data_ptr(), o[1].data_ptr(),
             N, batch, big, False, flags=ntt.FLAG_IN_PAIRS)
        return o

    def block(v, re, log_n, shift, out):
        c = transform(v, re, None, log_n, True, scale=m31_inv(1 << log_n))
        return transform(v, c[0], c[1], log_n, False, pre=shift, out=out)

    shift = _coset_shift()
    shapes = []
    big = (words((596, 1 << 18)), words((596, 1 << 18)))
    pair = torch.stack(big)
    copy = torch.empty_like(pair)
    t = ms(lambda: copy.copy_(pair))
    print(f"yardstick: copy of 2 x [596, 2^18] int64 words {t:.4f} ms, "
          f"{2 * pair.numel() * 8 / t / 1e9:.3f} TB/s (read + write)",
          flush=True)
    del pair, copy
    cols = words((596, 1 << 16))
    for c in (596, 493):
        shapes += [
            (f"forward [{c}, 2^18]",
             lambda v, c=c: transform(v, big[0][:c], big[1][:c], 18, False)),
            (f"inverse [{c}, 2^16], real",
             lambda v, c=c: transform(v, cols[:c], None, 16, True,
                                      scale=m31_inv(1 << 16))),
            (f"lde [{c}, 2^16] -> 2^18",
             lambda v, c=c: lde(v, cols[:c], 16, 2, shift))]
    shapes += [("lde [238, 2^16] -> 2^18",
                lambda v: lde(v, cols[:238], 16, 2, shift))]
    # The quotient's column and its chunks (prover.py: coset_intt of
    # [2^18], then coset_ntt of 2^16-word slices into 2^18).
    q = (big[0][0], big[1][0])
    shapes += [
        ("coset_intt [1, 2^18]",
         lambda v: transform(v, q[0][None], q[1][None], 18, True,
                             scale=m31_inv(1 << 18),
                             post=ntt.cm31_inv_scalar(shift))),
        ("coset_ntt [1, 2^16 slice] -> 2^18",
         lambda v: transform(v, q[0][None, 1 << 16:2 << 16],
                             q[1][None, 1 << 16:2 << 16], 18, False,
                             pre=shift))]
    out16 = (torch.empty((64, 1 << 16), dtype=torch.int64, device="cuda"),
             torch.empty((64, 1 << 16), dtype=torch.int64, device="cuda"))
    wide = words((64, 1 << 20))
    out20 = (torch.empty_like(wide), torch.empty_like(wide))
    col = (words((1, 1 << 24)), words((1, 1 << 24)))
    strided = words((64, 1 << 17))[:, :1 << 16]
    shapes += [
        ("block intt + coset_ntt [64, 2^16]",
         lambda v: block(v, cols[:64], 16, shift, out16)),
        ("block intt + coset_ntt [64, 2^20]",
         lambda v: block(v, wide, 20, shift, out20)),
        ("forward [1, 2^24]", lambda v: transform(v, col[0], col[1], 24,
                                                  False)),
        ("forward [64, 2^16], row stride 2^17",
         lambda v: transform(v, strided, strided, 16, False))]

    for rnd in range(2):
        for name, fn in shapes:
            want = None
            line = []
            for v in variants:
                t = ms(lambda: fn(v))
                got = fn(v)
                torch.cuda.synchronize()
                if want is None:
                    want, same = tuple(g.clone() for g in got), True
                else:
                    same = all(torch.equal(g, w) for g, w in zip(got, want))
                line.append(f"{v['name']} {t:.4f} ms"
                            f"{'' if same else ' (DIFFERS)'}")
                del got
            print(f"round {rnd} {name}: " + "; ".join(line), flush=True)
            del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
