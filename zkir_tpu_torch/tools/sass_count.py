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
"""

import collections
import re
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


def main():
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
