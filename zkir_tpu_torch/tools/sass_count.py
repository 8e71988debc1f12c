#!/usr/bin/env python3
"""Count the instructions one thread executes in a kernel, from its SASS.

Usage (where the CUDA toolkit is installed):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -cubin \
        -o poseidon2.cubin zkir_tpu_torch/csrc/poseidon2.cu
    cuobjdump -sass poseidon2.cubin > poseidon2.sass
    python3 zkir_tpu_torch/tools/sass_count.py poseidon2.sass permute_kernel 4 14 4

The trailing numbers are the trip counts of the kernel's loops (backward
branches), in address order.  Prints the static instruction count, each
loop's body, and the dynamic count = straight-line code + body x trips,
split by opcode class.  Loops must not nest (the permutation's do not).

The quotient's operation count (``chip_smoke.py``'s bound for the
generated kernels) takes each helper of ``csrc/m31.cuh`` and
``csrc/quotient.cuh`` at its instructions in a probe built from those
headers (``helper_instructions``): the helper applied in a dependent chain
of 16 and of 8 calls, the difference over 8.  The NTT's
(``ntt_instructions``) takes ``csrc/ntt.cu``'s product and a butterfly's
sum and difference the same way.

For a kernel whose loop body branches on its data (the interpreter's
cycle loop, one path per opcode):

    python3 zkir_tpu_torch/tools/sass_count.py interp.sass interp_kernel --floor

prints the instructions that every trip of the kernel's loop over machine
cycles (the outermost loop, or the widest loop inside it where a loop over
chunks wraps it) executes whatever path it takes: those that no forward
branch inside the loop can jump over (a branch past the loop's end leaves
it and ends the count of trips) (an indirect branch counts as jumping to
the end of the convergence region around it).  That is a floor on the
instructions of one trip, so a time bound computed from it is a valid
lower bound.
"""

import collections
import pathlib
import re
import subprocess
import sys


def instructions(path, kernel):
    """[(address, opcode, text)] of the first function whose name holds
    ``kernel``."""
    out, inside = [], False
    pat = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
    for line in open(path):
        if "Function :" in line:
            if inside:
                break
            inside = kernel in line
            continue
        m = pat.search(line) if inside else None
        if m:
            text = m.group(2).strip()
            op = text.split()[1] if text.startswith("@") else text.split()[0]
            out.append((int(m.group(1), 16), op, text))
    return out


def loops(ins):
    """(start, end) of every loop (a backward branch), widest first."""
    back = [(int(m.group(1), 16), addr) for addr, _, text in ins
            for m in [re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)]
            if m and int(m.group(1), 16) < addr]
    return sorted(back, key=lambda se: se[0] - se[1])


def cycle_loop(ins):
    """The interpreter's loop over machine cycles: the outermost loop, or
    the widest loop inside it where that spans more than half of it (a
    loop over chunks around the loop over cycles)."""
    outer, *rest = loops(ins)
    inner = [(a, b) for a, b in rest if outer[0] <= a and b <= outer[1]]
    if inner and 2 * (inner[0][1] - inner[0][0]) > outer[1] - outer[0]:
        return inner[0]
    return outer


def cycle_loop_floor(ins):
    """(static instructions, floor) of ``cycle_loop``."""
    start, end, count = loop_floor(ins, cycle_loop(ins))
    return sum(1 for a, _, _ in ins if start <= a <= end), count


def loop_floor(ins, loop):
    """(start, end, count) of ``loop`` and of its instructions that no
    forward branch inside it can skip."""
    start, end = loop
    skipped = []        # [lo, hi): addresses some forward branch jumps over
    region_end = None
    for addr, op, text in ins:
        if not start <= addr <= end:
            continue
        m = re.search(r"\b(BRA|BSSY)\b.*?0x([0-9a-f]+)", text)
        if m and m.group(1) == "BSSY":
            region_end = int(m.group(2), 16)
        elif m and addr < int(m.group(2), 16) <= end:   # not a loop exit
            skipped.append((addr + 16, int(m.group(2), 16)))
        elif op.startswith("BRX"):
            skipped.append((addr + 16, region_end))
    always = [a for a, _, _ in ins if start <= a <= end
              and not any(lo <= a < hi for lo, hi in skipped)]
    return start, end, len(always)


# Each helper as one step of a chain the compiler can neither fold nor
# hoist: every call takes the previous call's result.
_HELPER_CHAINS = {
    "m31_add": "x = m31_add(x, b);",
    "m31_sub": "x = m31_sub(x, b);",
    "m31_mul": "x = m31_mul(x, b);",
    "m31_dot": "x = m31_dot(x, b, c, x);",
    "m31_dotn": "x = m31_dotn(x, b, c, x);",
    "qp_acc2": "qp_acc2(acc, acc.a, p, q);",
    "qp_acc4": "qp_acc4(acc, acc.a, acc.b, p, q);",
    "qp_divide": "qp_divide(acc, acc, dinv, n, (long long)x);",
    "qp_finish": "qp_finish(o, nullptr, 0, acc, n, (long long)x + r);",
}


def helper_source() -> str:
    """The probe: for each helper, kernels ``probe_<helper>_<R>`` that
    apply it R = 8 and R = 16 times in a chain."""
    lines = ["#define QP_TILE 128", "#define QP_SHIFT 4",
             '#include "quotient.cuh"', ""]
    for name, step in _HELPER_CHAINS.items():
        for reps in (8, 16):
            lines += [
                f'extern "C" __global__ void probe_{name}_{reps}(',
                "    const uint32_t* in, uint32_t* o, const int64_t* dinv,",
                "    int64_t* out, long long n) {",
                "    uint32_t x = in[threadIdx.x], b = in[threadIdx.x + 32],",
                "             c = in[threadIdx.x + 64];",
                "    const cm31 p = {in[96], in[97]}, q = {in[98], in[99]};",
                "    qacc acc = {{x, b}, {c, x ^ b}};",
                "#pragma unroll",
                f"    for (int r = 0; r < {reps}; ++r) {{ {step} }}",
                "    o[threadIdx.x] = x ^ acc.a.re ^ acc.a.im ^ acc.b.re "
                "^ acc.b.im;",
                "}", ""]
    return "\n".join(lines)


def chain_instructions(nvcc: str, csrc, workdir, stem: str, source: str,
                       names) -> dict:
    """Instructions of one call of each helper in ``names``: ``source``
    defines kernels ``probe_<name>_16`` and ``probe_<name>_8`` that apply
    it in chains of 16 and 8 calls; it is built by ``nvcc`` for sm_90a
    with ``csrc`` on the include path, and each count is the SASS of the
    16-call chain less the 8-call chain's (NOPs aside), over 8."""
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    cu, cubin = work / f"{stem}.cu", work / f"{stem}.cubin"
    cu.write_text(source)
    res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O3", "-cubin", "-I", str(csrc),
                          "-o", str(cubin), str(cu)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the {stem} probe:\n{res.stderr}")
    sass = work / f"{stem}.sass"
    sass.write_text(subprocess.run(
        [str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
        check=True, capture_output=True, text=True).stdout)

    def count(kernel):
        return sum(op != "NOP" for _, op, _ in instructions(sass, kernel))

    return {name: (count(f"probe_{name}_16") - count(f"probe_{name}_8")) / 8
            for name in names}


def helper_instructions(nvcc: str, csrc, workdir) -> dict:
    """Instructions of one call of each quotient helper in code built by
    ``nvcc`` for sm_90a from the headers in ``csrc``."""
    return chain_instructions(nvcc, csrc, workdir, "helpers",
                              helper_source(), _HELPER_CHAINS)


# The NTT's butterfly (csrc/ntt.cu): the product of the upper point by its
# twiddle, and the sum and difference of both coordinates.
_NTT_CHAINS = {
    "cmul": "y = lz_cmul(y, w);",
    "sum_difference": "{ const cm31 s = {lz_add(x.re, y.re), "
                      "lz_add(x.im, y.im)}; y = {lz_sub(x.re, y.re), "
                      "lz_sub(x.im, y.im)}; x = s; }",
}


def ntt_source() -> str:
    lines = ['#include "ntt.cu"', ""]
    for name, step in _NTT_CHAINS.items():
        for reps in (8, 16):
            lines += [
                f'extern "C" __global__ void probe_{name}_{reps}(',
                "    const uint32_t* in, uint32_t* o) {",
                "    cm31 x = {in[threadIdx.x], in[threadIdx.x + 32]};",
                "    cm31 y = {in[threadIdx.x + 64], in[threadIdx.x + 96]};",
                "    const cm31 w = {in[128], in[129]};",
                "#pragma unroll",
                f"    for (int r = 0; r < {reps}; ++r) {step}",
                "    o[threadIdx.x] = x.re ^ x.im ^ y.re ^ y.im;",
                "}", ""]
    return "\n".join(lines)


def ntt_instructions(nvcc: str, csrc, workdir) -> dict:
    """Instructions of the NTT's product (``cmul``) and of a butterfly's
    sum and difference (``sum_difference``) in ``csrc/ntt.cu`` as built
    for sm_90a."""
    return chain_instructions(nvcc, csrc, workdir, "ntt_probe", ntt_source(),
                              _NTT_CHAINS)


def main():
    if sys.argv[-1] == "--floor":
        ins = instructions(sys.argv[1], sys.argv[2])
        start, end, count = loop_floor(ins, cycle_loop(ins))
        body = sum(1 for a, _, _ in ins if start <= a <= end)
        print(f"{sys.argv[2]}: {len(ins)} static instructions; cycle "
              f"loop {start:#x}..{end:#x} of {body}; every trip executes "
              f"at least {count}")
        return
    path, kernel, *trips = sys.argv[1:]
    trips = [int(t) for t in trips]
    ins = instructions(path, kernel)
    loops = []
    for addr, op, text in ins:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        # (the self-branch after EXIT is padding, not a loop)
        if m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    print(f"{kernel}: {len(ins)} static instructions, loops {loops}")
    if len(trips) != len(loops):
        sys.exit(f"give one trip count per loop ({len(loops)})")
    total = collections.Counter()
    for addr, op, _ in ins:
        weight = 1
        for (start, end), trip in zip(loops, trips):
            if start <= addr <= end:
                weight = trip
        total[op.split(".")[0]] += weight
    print("dynamic instructions per thread:", sum(total.values()))
    for op, n in total.most_common():
        print(f"  {op:10s} {n}")


if __name__ == "__main__":
    main()
