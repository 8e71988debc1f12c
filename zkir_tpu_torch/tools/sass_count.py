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

A Poseidon2 permutation's instructions in this build
(``p2_instructions``): a probe of ``csrc/poseidon2.cu``'s ``permute`` (one
thread a state) and ``permute4`` (four lanes a state) called once and
twice, each loop at its trip count (4, 14, 4 a call), the difference.

The hash kernels' operation counts (``crypto_instructions``) take one
compression of each as the SASS of a chain of two calls less that of one.
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


def backward_branches(ins):
    """(start, end) of every loop (a backward branch), in address order."""
    out = []
    for addr, _, text in ins:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        # (the self-branch after EXIT is padding, not a loop)
        if m and int(m.group(1), 16) < addr:
            out.append((int(m.group(1), 16), addr))
    return out


def loops(ins):
    """(start, end) of every loop (a backward branch), widest first."""
    return sorted(backward_branches(ins), key=lambda se: se[0] - se[1])


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
                       names, reps=(8, 16)) -> dict:
    """Instructions of one call of each helper in ``names``: ``source``
    defines kernels ``probe_<name>_<R>`` for both R in ``reps`` that apply
    it in chains of R calls; it is built by ``nvcc`` for sm_90a with
    ``csrc`` on the include path, and each count is the SASS of the longer
    chain less the shorter one's (NOPs aside), over the difference in
    calls."""
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

    lo, hi = reps
    return {name: (count(f"probe_{name}_{hi}") - count(f"probe_{name}_{lo}"))
            / (hi - lo) for name in names}


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


# csrc/crypto.cu's compression functions, each on a state in registers
# that the previous call left (SHA-256's schedule overwrites its block, so
# no call repeats another's work).
_CRYPTO_CHAINS = {
    "sha256_block": ("uint32_t h[8], w[16];",
                     "for (int k = 0; k < 8; ++k) h[k] = in[k * 32 + t];"
                     " for (int k = 0; k < 16; ++k) w[k] = in[256 + k * 32 + t];",
                     "sha256_compress(h, w, nullptr);",
                     "h[0] ^ h[3] ^ h[7] ^ w[5]"),
    "keccak_f": ("uint64_t s[25];",
                 "for (int k = 0; k < 25; ++k) s[k] = in[k * 32 + t]"
                 " | ((uint64_t)in[800 + k * 32 + t] << 32);",
                 "keccak_f(s);",
                 "(uint32_t)(s[0] ^ s[7] ^ s[24] ^ (s[13] >> 32))"),
    "b3_compress": ("uint32_t cv[8], m[16];",
                    "for (int k = 0; k < 8; ++k) cv[k] = in[k * 32 + t];"
                    " for (int k = 0; k < 16; ++k) m[k] = in[256 + k * 32 + t];",
                    "b3_compress_words(cv, m, ((uint64_t)m[3] << 32) | m[2],"
                    " 64u, 1u);",
                    "cv[0] ^ cv[5] ^ m[9]"),
}


def crypto_source() -> str:
    lines = ['#include "crypto.cu"', ""]
    for name, (decl, load, step, result) in _CRYPTO_CHAINS.items():
        for reps in (1, 2):
            lines += [
                f'extern "C" __global__ void probe_{name}_{reps}(',
                "    const uint32_t* in, uint32_t* o) {",
                "    const int t = threadIdx.x;",
                f"    {decl}", f"    {load}",
                "#pragma unroll",
                f"    for (int r = 0; r < {reps}; ++r) {{ {step} }}",
                f"    o[t] = {result};", "}", ""]
    return "\n".join(lines)


def crypto_instructions(nvcc: str, csrc, workdir) -> dict:
    """Instructions one thread executes for one SHA-256 block compression
    (``sha256_block``), one keccak-f[1600] (``keccak_f``) and one BLAKE3
    compression (``b3_compress``) in ``csrc/crypto.cu`` as built for
    sm_90a: the SASS of a chain of two calls less that of one (each is
    straight-line code)."""
    return chain_instructions(nvcc, csrc, workdir, "crypto_probe",
                              crypto_source(), _CRYPTO_CHAINS, reps=(1, 2))


def dynamic_instructions(ins, trips) -> collections.Counter:
    """Instructions one thread executes in ``ins`` by opcode class: each
    loop's body (``backward_branches``, not nested) ``trips`` times, the
    rest once; NOPs aside."""
    loops = backward_branches(ins)
    if len(trips) != len(loops):
        raise ValueError(f"give one trip count per loop ({len(loops)})")
    total = collections.Counter()
    for addr, op, _ in ins:
        weight = 1
        for (start, end), trip in zip(loops, trips):
            if start <= addr <= end:
                weight = trip
        if op != "NOP":
            total[op.split(".")[0]] += weight
    return total


def p2_source() -> str:
    lines = ['#include "poseidon2.cu"', ""]
    for name, width, call in (
            ("one", 16, "permute(x);"),
            ("four", 4, "permute4(x, threadIdx.x & 3, cst);")):
        for reps in (1, 2):
            lines += [
                f'extern "C" __global__ void probe_p2_{name}_x{reps}(',
                "    const uint32_t* in, uint32_t* o, const P2Constants* cst) {",
                f"    uint32_t x[{width}];",
                "#pragma unroll",
                f"    for (int k = 0; k < {width}; ++k) "
                "x[k] = in[k * 32 + threadIdx.x];",
                *[f"    {call}"] * reps,
                "    o[threadIdx.x] = x[0] ^ x[3];", "}", ""]
    return "\n".join(lines)


def p2_instructions(nvcc: str, csrc, workdir) -> dict:
    """Instructions of one Poseidon2 permutation in ``csrc/poseidon2.cu``
    as built for sm_90a: ``one``, one thread's (``permute``); ``four``,
    its four lanes' together (``permute4``)."""
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    cu, cubin = work / "p2_probe.cu", work / "p2_probe.cubin"
    cu.write_text(p2_source())
    res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O3", "-cubin", "-I", str(csrc),
                          "-o", str(cubin), str(cu)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the p2 probe:\n{res.stderr}")
    sass = work / "p2_probe.sass"
    sass.write_text(subprocess.run(
        [str(pathlib.Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
        check=True, capture_output=True, text=True).stdout)

    def count(name, reps):
        return sum(dynamic_instructions(
            instructions(sass, f"probe_p2_{name}_x{reps}"),
            [4, 14, 4] * reps).values())

    return {"one": count("one", 2) - count("one", 1),
            "four": 4 * (count("four", 2) - count("four", 1))}


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
    ins = instructions(path, kernel)
    print(f"{kernel}: {len(ins)} static instructions, loops "
          f"{backward_branches(ins)}")
    try:
        total = dynamic_instructions(ins, [int(t) for t in trips])
    except ValueError as e:
        sys.exit(str(e))
    print("dynamic instructions per thread:", sum(total.values()))
    for op, n in total.most_common():
        print(f"  {op:10s} {n}")


if __name__ == "__main__":
    main()
