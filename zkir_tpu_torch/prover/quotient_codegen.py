"""The quotient evaluation as generated CUDA kernels.

Counterpart of the reference's jitted quotient, ``_quotient_kernel`` and
``_quotient_parts_eval`` (``zkir_tpu/prover/constraints.py``): every
constraint term C_j, its alpha power and its divisor, evaluated at every
point of the coset LDE domain as

    Q = sum_tag 1/Z_tag * sum_{j in tag} alpha^j C_j

in a few launches instead of one ``cm31_binary`` launch per CM31
operation (the torch ``VecAlg`` path, which stays as the plain version
that CPU tensors take).

1. ``quotient_terms`` runs once per process and feature set on ``RecAlg``,
   an algebra with ``VecAlg``'s interface that records a graph of M31
   operations instead of computing: column reads (the point, or the next
   trace row's point) are leaves, equal operations are one node, and
   products and sums with 0 or 1 fold away.
2. The challenges are data, not source: the constraint code's host
   arithmetic on them (eta^2, the delta and gamma powers) runs on ``Sym``
   values and is recorded as a ``ScalarProgram``.  Each proof evaluates
   that program into a table of words, so the generated text is the same
   for every challenge set; the alpha powers are a table too.
3. The terms are cut into parts of about ``PART_BUDGET`` operations.
   Each part is one ``__global__`` in its own generated ``.cu``
   (``csrc/quotient.cuh`` holds its helpers): one thread per point, the
   part's terms in order, alpha^j C_j summed per divisor tag in registers,
   each tag's sum times that tag's 1/Z(x), the result added into the
   [4, N] output.  Parts run in order on the current stream; field
   addition is exact, so the words equal the plain version's.
4. Each part's shared library is named by a hash of its text, the headers
   and the flags, and built under ``zkir_tpu_torch/_build/quotient/`` at
   first use (all missing parts at once, one ``nvcc`` each); a part's
   text is a function of its terms alone, so feature sets whose terms
   begin alike share their first parts.  A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import _kernels
from ..spec.field import M31_PRIME

P = M31_PRIME
BUILD = _kernels.BUILD / "quotient"
NVCC_EXTRA = ("-Xptxas", "-v")
# Operations (M31 nodes, plus ACC_COST a term) in one part, and
# __launch_bounds__'s blocks per SM (4 caps a thread at 128 registers):
# the fastest of the sizes tools/quotient_bench.py times on an H100.
# Larger parts reach 255 registers and spill; smaller ones re-read more
# columns.
PART_BUDGET = 900
ACC_COST = 12
THREADS = 128
MIN_BLOCKS = 4
FEATURES = ("lookup", "aux", "memory", "io", "crypto", "program")
TAG_ROW = {"H": 0, "T": 2, "F": 4, "L": 6}   # rows of the [8, N] 1/Z table
# M31 nodes: ("imm", v), ("par", sym), ("leaf", leaf, shifted),
# ("add" | "sub" | "mul", x, y), ("dot" | "dotn", a, b, c, d) for
# a b + c d and a b - c d.
_C_OPS = {"add": "m31_add", "sub": "m31_sub", "mul": "m31_mul",
          "dot": "m31_dot", "dotn": "m31_dotn"}

compiles = 0   # part sources compiled by this process
_kernels.launches.setdefault("quotient_part", 0)   # one count a launch


# ============================================================================
# Host scalars derived from the challenges.
# ============================================================================


class Sym:
    """An M31 word that the constraint code computes on the host from the
    challenges (``+ - *`` and ``% P``).  Arithmetic records into its
    ``ScalarProgram``; deciding anything on its value is refused, because
    the recorded graph would then depend on one challenge set."""

    __slots__ = ("prog", "id")

    def __init__(self, prog, ident):
        self.prog, self.id = prog, ident

    def __add__(self, o):
        return self.prog.op("add", self, o)

    def __radd__(self, o):
        return self.prog.op("add", o, self)

    def __sub__(self, o):
        return self.prog.op("sub", self, o)

    def __rsub__(self, o):
        return self.prog.op("sub", o, self)

    def __mul__(self, o):
        return self.prog.op("mul", self, o)

    def __rmul__(self, o):
        return self.prog.op("mul", o, self)

    def __mod__(self, m):
        if m != P:
            raise TypeError(f"a challenge word is reduced mod p, not {m}")
        return self

    def _refuse(self, *_):
        raise TypeError("the value of a challenge word is data of the "
                        "kernel, not of its source")

    __bool__ = __int__ = __index__ = _refuse


class ScalarProgram:
    """Straight-line M31 arithmetic over input words: ``defs[k]`` is
    ``("in", position)`` or ``(op, x, y)`` with operands ``("s", k)`` or
    ``("i", int)``."""

    def __init__(self):
        self.defs: List[tuple] = []
        self.n_inputs = 0
        self._memo: Dict[tuple, int] = {}

    def input(self) -> Sym:
        self.defs.append(("in", self.n_inputs))
        self.n_inputs += 1
        return Sym(self, len(self.defs) - 1)

    @staticmethod
    def _operand(x):
        return ("s", x.id) if isinstance(x, Sym) else ("i", int(x) % P)

    def op(self, kind, x, y):
        x, y = self._operand(x), self._operand(y)
        if x[0] == y[0] == "i":
            return _fold(kind, x[1], y[1])
        zero, one = ("i", 0), ("i", 1)
        if kind == "add" and zero in (x, y):
            return self._value(y if x == zero else x)
        if kind == "sub" and y == zero:
            return self._value(x)
        if kind == "mul":
            if zero in (x, y):
                return 0
            if one in (x, y):
                return self._value(y if x == one else x)
        if kind != "sub" and x > y:
            x, y = y, x
        key = (kind, x, y)
        if key not in self._memo:
            self.defs.append(key)
            self._memo[key] = len(self.defs) - 1
        return Sym(self, self._memo[key])

    def _value(self, operand):
        return Sym(self, operand[1]) if operand[0] == "s" else operand[1]

    def evaluate(self, inputs) -> List[int]:
        """The value of every definition for these input words."""
        if len(inputs) != self.n_inputs:
            raise ValueError(f"{len(inputs)} input words for a program of "
                             f"{self.n_inputs}")
        vals: List[int] = []
        push = vals.append
        for d in self.defs:
            kind = d[0]
            if kind == "in":
                push(int(inputs[d[1]]) % P)
                continue
            (xk, x), (yk, y) = d[1], d[2]
            a = vals[x] if xk == "s" else x
            b = vals[y] if yk == "s" else y
            if kind == "mul":
                push(a * b % P)
            elif kind == "add":
                push((a + b) % P)
            else:
                push((a - b) % P)
        return vals


def _fold(kind, a, b):
    if kind == "add":
        return (a + b) % P
    if kind == "sub":
        return (a - b) % P
    return a * b % P


# ============================================================================
# The recording algebra.
# ============================================================================


class RecAlg:
    """``VecAlg``'s interface (``constraints.py``), recording a graph of
    M31 operations: CM31 values are pairs and QM31 values 4-tuples of node
    ids, as ``VecAlg``'s are of tensors.  ``nodes[k]`` is node k (see
    ``_C_OPS``); ``leaves[k]`` is ``(accessor, arguments, component)``, the
    column that ``VecAlg``'s accessor of that name returns (the next-row
    accessors read their base accessor's column shifted by one trace
    row)."""

    def __init__(self):
        self.nodes: List[tuple] = []
        self.leaves: List[tuple] = []
        self._memo: Dict[tuple, int] = {}
        self._leaf_ids: Dict[tuple, int] = {}
        self.zero = self._node("imm", 0)
        self.one = self._node("imm", 1)

    # --- M31 nodes ---

    def _node(self, *key):
        if key not in self._memo:
            self.nodes.append(key)
            self._memo[key] = len(self.nodes) - 1
        return self._memo[key]

    def _imm(self, v):
        return self._node("imm", int(v) % P)

    def _val(self, x):
        node = self.nodes[x]
        return node[1] if node[0] == "imm" else None

    def _add(self, x, y):
        if x == self.zero:
            return y
        if y == self.zero:
            return x
        vx, vy = self._val(x), self._val(y)
        if vx is not None and vy is not None:
            return self._imm(vx + vy)
        return self._node("add", *sorted((x, y)))

    def _sub(self, x, y):
        if y == self.zero:
            return x
        if x == y:
            return self.zero
        vx, vy = self._val(x), self._val(y)
        if vx is not None and vy is not None:
            return self._imm(vx - vy)
        return self._node("sub", x, y)

    def _mul(self, x, y):
        if self.zero in (x, y):
            return self.zero
        if x == self.one:
            return y
        if y == self.one:
            return x
        vx, vy = self._val(x), self._val(y)
        if vx is not None and vy is not None:
            return self._imm(vx * vy)
        return self._node("mul", *sorted((x, y)))

    def _dot(self, a, b, c, d, negate=False):
        """a b + c d, or a b - c d with ``negate``."""
        if self.zero in (c, d):
            return self._mul(a, b)
        if self.zero in (a, b):
            cd = self._mul(c, d)
            return self._sub(self.zero, cd) if negate else cd
        vals = [self._val(x) for x in (a, b, c, d)]
        if None not in vals:
            return self._imm(vals[0] * vals[1]
                             + (P - vals[2] if negate else vals[2]) * vals[3])
        p1, p2 = tuple(sorted((a, b))), tuple(sorted((c, d)))
        if not negate and p1 > p2:
            p1, p2 = p2, p1
        return self._node("dotn" if negate else "dot", *p1, *p2)

    def _scalar(self, x):
        if isinstance(x, Sym):
            return self._node("par", x.id)
        return self._imm(x)

    # --- CM31 on pairs of nodes ---

    def _cmul(self, a, b):
        return (self._dot(a[0], b[0], a[1], b[1], negate=True),
                self._dot(a[0], b[1], a[1], b[0]))

    def _times_r(self, c):
        """R c for R = u^2 = 2 + i."""
        return (self._sub(self._add(c[0], c[0]), c[1]),
                self._add(c[0], self._add(c[1], c[1])))

    # --- leaves ---

    def _leaf(self, accessor, args, width, shifted=False):
        out = []
        for comp in range(width):
            key = (accessor, args, comp)
            if key not in self._leaf_ids:
                self.leaves.append(key)
                self._leaf_ids[key] = len(self.leaves) - 1
            out.append(self._node("leaf", self._leaf_ids[key], shifted))
        return tuple(out)

    def col(self, c):
        return self._leaf("col", (c,), 2)

    def nxt(self, c):
        return self._leaf("col", (c,), 2, True)

    def scol(self, k):
        return self._leaf("scol", (k,), 4)

    def snxt(self, k):
        return self._leaf("scol", (k,), 4, True)

    def mcol(self):
        return self._leaf("mcol", (), 4)

    def mnxt(self):
        return self._leaf("mcol", (), 4, True)

    def mfcol(self):
        return self._leaf("mfcol", (), 4)

    def iocol(self):
        return self._leaf("iocol", (), 4)

    def ionxt(self):
        return self._leaf("iocol", (), 4, True)

    def iofcol(self):
        return self._leaf("iofcol", (), 4)

    def crinv(self, s):
        return self._leaf("crinv", (s,), 4)

    def crcol(self):
        return self._leaf("crcol", (), 4)

    def crnxt(self):
        return self._leaf("crcol", (), 4, True)

    def crfcol(self):
        return self._leaf("crfcol", (), 4)

    def pscol(self):
        return self._leaf("pscol", (), 4)

    def psnxt(self):
        return self._leaf("pscol", (), 4, True)

    def pcol(self, c):
        return self._leaf("pcol", (c,), 2)

    def acol(self, c):
        return self._leaf("acol", (c,), 2)

    def ascol(self, k):
        return self._leaf("ascol", (k,), 4)

    def asnxt(self, k):
        return self._leaf("ascol", (k,), 4, True)

    # --- the arithmetic of VecAlg ---

    def const(self, v):
        if not isinstance(v, tuple):
            v = (v, 0)
        return (self._scalar(v[0]), self._scalar(v[1]))

    def add(self, a, b):
        return (self._add(a[0], b[0]), self._add(a[1], b[1]))

    def sub(self, a, b):
        return (self._sub(a[0], b[0]), self._sub(a[1], b[1]))

    def mul(self, a, b):
        return self._cmul(a, b)

    def mulc(self, a, v):
        return self._cmul(a, self.const(v))

    def qlift(self, c):
        return (c[0], c[1], self.zero, self.zero)

    def qconst(self, v4):
        return tuple(self._scalar(x) for x in v4)

    def qadd(self, x, y):
        return (*self.add(x[:2], y[:2]), *self.add(x[2:], y[2:]))

    def qsub(self, x, y):
        return (*self.sub(x[:2], y[:2]), *self.sub(x[2:], y[2:]))

    def qmul(self, x, y):
        a1, b1, a2, b2 = x[:2], x[2:], y[:2], y[2:]
        a = self.add(self._cmul(a1, a2), self._times_r(self._cmul(b1, b2)))
        b = self.add(self._cmul(a1, b2), self._cmul(b1, a2))
        return (*a, *b)

    def qscale(self, c, v4):
        return (*self._cmul(c, self.const(tuple(v4[:2]))),
                *self._cmul(c, self.const(tuple(v4[2:]))))

    def qmul_c(self, x, c):
        return (*self._cmul(x[:2], c), *self._cmul(x[2:], c))


# ============================================================================
# Recording a feature set.
# ============================================================================


def features_of(keys) -> Tuple[bool, ...]:
    """The feature set of ``quotient_terms`` keyword arguments."""
    return tuple(keys[name] is not None for name in FEATURES)


def _symbolic_keys(prog: ScalarProgram, features):
    """``quotient_terms``'s challenge arguments for a feature set, made of
    the program's input words in ``challenge_words``'s order."""
    lk, ak, mk, ik, ck, pk = features

    def q():
        return tuple(prog.input() for _ in range(4))

    beta = q() if lk else None
    keys = dict(lookup=beta, aux=None, memory=None, io=None, crypto=None,
                program=None)
    if ak:
        keys["aux"] = (beta, q())
    if mk:
        keys["memory"] = (beta, q(), q())
    if ik:
        keys["io"] = (beta, q(), q())
    if ck:
        keys["crypto"] = (beta, q(), q())
    if pk:
        keys["program"] = (beta, q(), (prog.input(), prog.input()))
    return keys


def challenge_words(keys) -> List[int]:
    """The input words of the recorded scalar program, from concrete
    ``quotient_terms`` arguments: beta, eta, (delta, d_init),
    (delta, d_io), (delta, d_crypto), gamma, and the entry point split
    into 20-bit limbs, as ``program_boundary`` splits it."""
    out: List[int] = []
    if keys["lookup"] is not None:
        out += keys["lookup"]
    if keys["aux"] is not None:
        out += keys["aux"][1]
    for name in ("memory", "io", "crypto"):
        if keys[name] is not None:
            out += [*keys[name][1], *keys[name][2]]
    if keys["program"] is not None:
        _, gamma, entry = keys["program"]
        limb = (1 << 20) - 1
        out += [*gamma, entry & limb, (entry >> 20) & limb]
    return [int(x) % P for x in out]


class Recording(NamedTuple):
    alg: RecAlg
    scalars: ScalarProgram
    terms: List[Tuple[str, tuple]]      # (divisor tag, node ids)


@functools.lru_cache(maxsize=None)
def record(features: Tuple[bool, ...]) -> Recording:
    """``quotient_terms`` on the recording algebra, once per feature set."""
    from .constraints import quotient_terms

    alg, prog = RecAlg(), ScalarProgram()
    terms = quotient_terms(alg, **_symbolic_keys(prog, features))
    return Recording(alg, prog, terms)


# ============================================================================
# Parts and their source.
# ============================================================================


class Part(NamedTuple):
    lo: int                 # terms [lo, hi) of the recording
    hi: int
    text: str               # the generated .cu
    leaves: List[int]       # table slot -> leaf id of the recording
    params: List[int]       # table slot -> scalar-program definition
    n_ops: int              # M31 operations in the part
    key: str                # the hash that names its build


def _needed(alg: RecAlg, roots, seen) -> List[int]:
    """Nodes (no immediates) that ``roots`` depend on and ``seen`` lacks,
    in an order where every node follows its operands; adds them to
    ``seen``."""
    order = []
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        x, expanded = stack.pop()
        if x in seen and not expanded:
            continue
        node = alg.nodes[x]
        if node[0] == "imm":
            continue
        if expanded:
            order.append(x)
            continue
        seen.add(x)
        stack.append((x, True))
        if node[0] not in ("par", "leaf"):
            stack.extend((a, False) for a in reversed(node[1:]))
    return order


def split(rec: Recording) -> List[Tuple[int, int]]:
    """Cut the terms, in order, into ranges of about ``PART_BUDGET``
    operations: a part's own nodes plus ``ACC_COST`` a term."""
    bounds, seen, cost = [0], set(), 0
    for j, (_, comps) in enumerate(rec.terms):
        probe = set(seen)
        add = len(_needed(rec.alg, comps, probe)) + ACC_COST
        if cost and cost + add > PART_BUDGET:
            bounds.append(j)
            seen, cost = set(), 0
            add = len(_needed(rec.alg, comps, seen)) + ACC_COST
        else:
            seen = probe
        cost += add
    bounds.append(len(rec.terms))
    return list(zip(bounds[:-1], bounds[1:]))


def _describe(leaf) -> str:
    accessor, args, comp = leaf
    return f"{accessor}({', '.join(map(str, args))})[{comp}]"


def part_source(rec: Recording, lo: int, hi: int) -> Part:
    """The CUDA source of terms [lo, hi): its text names only what the
    part reads and computes, so equal terms give equal text."""
    alg = rec.alg
    order = _needed(alg, [x for _, c in rec.terms[lo:hi] for x in c], set())
    leaves: Dict[int, int] = {}
    params: Dict[int, int] = {}
    for x in order:
        node = alg.nodes[x]
        if node[0] == "leaf":
            leaves.setdefault(node[1], len(leaves))
        elif node[0] == "par":
            params.setdefault(node[1], len(params))
    n_leaves = len(leaves)
    pw_base = n_leaves + len(params)
    n_words = pw_base + 4 * (hi - lo)
    name = {x: f"v{k}" for k, x in enumerate(order)}

    def ref(x):
        v = alg._val(x)
        return f"{v}u" if v is not None else name[x]

    body = []
    uses_next = False
    for x in order:
        node = alg.nodes[x]
        if node[0] == "leaf":
            uses_next |= node[2]
            at = "j" if node[2] else "i"
            expr = f"qp_leaf(tab, {leaves[node[1]]}, {at})"
        elif node[0] == "par":
            expr = f"(uint32_t)tab.w[{n_leaves + params[node[1]]}]"
        else:
            expr = f"{_C_OPS[node[0]]}({', '.join(map(ref, node[1:]))})"
        body.append(f"    const uint32_t {name[x]} = {expr};")
        if node[0] == "leaf":
            body[-1] += f"  // {_describe(alg.leaves[node[1]])}"
    tags = []
    for j in range(lo, hi):
        tag, comps = rec.terms[j]
        if tag not in tags:
            tags.append(tag)
        if all(alg._val(x) == 0 for x in comps):
            continue
        if len(comps) == 4 and alg._val(comps[2]) == alg._val(comps[3]) == 0:
            comps = comps[:2]
        vals = [ref(x) for x in comps]
        pairs = [f"cm31{{{a}, {b}}}" for a, b in zip(vals[::2], vals[1::2])]
        at = pw_base + 4 * (j - lo)
        body.append(f"    qp_acc{len(comps)}(acc_{tag}, {', '.join(pairs)}, "
                    f"qp_pair(tab, {at}), qp_pair(tab, {at + 2}));"
                    f"  // term {j}")
    tags.sort(key="HTFL".index)
    lines = [
        "// Generated by zkir_tpu_torch/prover/quotient_codegen.py from the",
        "// constraint system: one part of the quotient.  Do not edit.",
        f"// Terms [{lo}, {hi}), {len(order)} M31 operations; table: "
        f"{n_leaves} column pointers, {len(params)} challenge words, "
        f"{4 * (hi - lo)} alpha-power words.",
        '#include "quotient.cuh"',
        "",
        f"typedef qp_table<{n_words}> table_t;",
        "",
        f"extern \"C\" __global__ void __launch_bounds__({THREADS}, "
        f"{MIN_BLOCKS})",
        "quotient_part_kernel(const __grid_constant__ table_t tab,",
        "                     const int64_t* __restrict__ dinv,",
        "                     int64_t* __restrict__ out, long long n,",
        "                     long long shift, int accumulate) {",
        "    const long long i = (long long)blockIdx.x * blockDim.x "
        "+ threadIdx.x;",
        "    if (i >= n) return;",
    ]
    if uses_next:
        lines.append("    const long long j = (i + shift) & (n - 1);")
    else:
        lines.append("    (void)shift;")
    lines += [f"    qacc acc_{t} = {{}};" for t in tags]
    lines += body
    lines.append("    qacc r = {};")
    lines += [f"    qp_divide(r, acc_{t}, dinv + {TAG_ROW[t]} * n, n, i);"
              for t in tags]
    lines += [
        "    qp_store(out, r, n, i, accumulate);",
        "}",
        "",
        "extern \"C\" int quotient_part(const int64_t* table, "
        "const int64_t* dinv, int64_t* out,",
        "                              long long n, long long shift, "
        "int accumulate,",
        "                              cudaStream_t stream) {",
        "    table_t tab;",
        "    memcpy(tab.w, table, sizeof tab.w);",
        f"    quotient_part_kernel<<<(unsigned)((n + {THREADS - 1}) / "
        f"{THREADS}), {THREADS}, 0, stream>>>(",
        "        tab, dinv, out, n, shift, accumulate);",
        "    return (int)cudaGetLastError();",
        "}",
        "",
    ]
    text = "\n".join(lines)
    return Part(lo, hi, text, sorted(leaves, key=leaves.get),
                sorted(params, key=params.get), len(order), part_key(text))


def part_key(text: str) -> str:
    """The build's name: a hash of the generated text, the headers it
    includes and the compiler flags."""
    h = hashlib.sha256(text.encode())
    for f in ("m31.cuh", "quotient.cuh"):
        h.update((_kernels.CSRC / f).read_bytes())
    h.update(" ".join((*_kernels.NVCC_FLAGS, *NVCC_EXTRA)).encode())
    return h.hexdigest()[:16]


# ============================================================================
# Build, load, launch.
# ============================================================================


class Kernel:
    """A feature set's recording, parts and loaded libraries."""

    def __init__(self, features, rec: Recording, parts: List[Part]):
        self.features, self.rec, self.parts = features, rec, parts
        self.groups = _leaf_groups(rec.alg.leaves)
        self.fns = []

    def load(self):
        for part in self.parts:
            lib = ctypes.CDLL(str(BUILD / f"part_{part.key}.so"))
            fn = lib.quotient_part
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 \
                + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.fns.append((lib, fn))

    def table(self, A, keys, alpha):
        """Every part's table, one after the other, and where each
        begins: the addresses of its columns in ``A``, its challenge
        words for these challenges, its terms' alpha powers."""
        from .constraints import _alpha_powers_np

        words = self.rec.scalars.evaluate(challenge_words(keys))
        pw = _alpha_powers_np(alpha, len(self.rec.terms)).astype(np.int64)
        ptrs = _leaf_pointers(A, self.groups, len(self.rec.alg.leaves),
                              A.big)
        pieces, offsets = [], []
        at = 0
        for part in self.parts:
            offsets.append(at)
            piece = np.concatenate([
                ptrs[part.leaves], np.asarray([words[k] for k in part.params],
                                              dtype=np.int64),
                pw[part.lo:part.hi].ravel()])
            pieces.append(piece)
            at += piece.size
        return np.concatenate(pieces), offsets

    def __call__(self, A, keys, alpha, log_n, log_blowup, shift):
        tab, offsets = self.table(A, keys, alpha)
        return self.launch(tab, offsets, _dinv_rows(
            log_n, log_blowup, tuple(shift), A.ext_r.device), A.big,
            log_blowup)

    def launch(self, tab, offsets, dinv, n, log_blowup):
        """One launch per part on the current stream: the QM31 4-tuple of
        [n] rows.  The tables stay on the host: each launch copies its
        part's into the kernel's parameters."""
        out = torch.empty((4, n), dtype=torch.int64, device=dinv.device)
        lib = _kernels._lib or _kernels._load()
        stream = _kernels._current_stream()
        for k, ((_, fn), off) in enumerate(zip(self.fns, offsets)):
            err = fn(tab.ctypes.data + 8 * off, dinv.data_ptr(),
                     out.data_ptr(), n, 1 << log_blowup, int(k > 0), stream)
            _kernels._check(lib, err, "quotient_part")
            _kernels.launches["quotient_part"] += 1
        return tuple(out)


def _leaf_groups(leaves):
    """The leaves by (accessor, component): their indices, and the row
    each reads where the accessor takes one (else None)."""
    groups: Dict[tuple, Tuple[list, list]] = {}
    for k, (accessor, args, comp) in enumerate(leaves):
        idx, rows = groups.setdefault((accessor, comp), ([], []))
        idx.append(k)
        rows.extend(args)
    return {key: (np.asarray(i), np.asarray(r, dtype=np.int64) if r else None)
            for key, (i, r) in groups.items()}


def _leaf_pointers(A, groups, n_leaves, n) -> np.ndarray:
    """The device address of every leaf's column in ``A``
    (``VecAlg.column_bases``): each base an int64 tensor on the device
    whose rows (or itself) have n words of unit stride."""
    bases = A.column_bases()
    ptrs = np.empty(n_leaves, dtype=np.int64)
    for (accessor, comp), (idx, rows) in groups.items():
        t = bases[accessor][comp]
        with_rows = rows is not None
        if t.dtype != torch.int64 or t.device != A.ext_r.device \
                or t.dim() != 1 + with_rows or t.shape[-1] != n \
                or t.stride(-1) != 1 or (with_rows and rows.max()
                                         >= t.shape[0]):
            raise ValueError(
                f"the quotient's {accessor} columns [{comp}] must be int64 "
                f"{'rows' if with_rows else 'a row'} of {n} words of unit "
                f"stride on {A.ext_r.device}; got {t.dtype} "
                f"{tuple(t.shape)} stride {t.stride()} on {t.device}")
        ptrs[idx] = t.data_ptr() + (8 * t.stride(0) * rows if with_rows
                                    else 0)
    return ptrs


@functools.lru_cache(maxsize=4)
def _dinv_rows(log_n, log_blowup, shift, device):
    """1/Z_H, 1/Z_trans, 1/Z_first, 1/Z_last as an [8, N] int64 table on
    ``device`` (real and imaginary rows per tag, ``TAG_ROW``)."""
    from .constraints import _vanishing_tables

    rows = np.stack(_vanishing_tables(log_n, log_blowup, shift))
    return torch.from_numpy(rows.astype(np.int64)).to(device)


def plan(features) -> Kernel:
    """A feature set's recording and generated parts, not yet built."""
    rec = record(features)
    return Kernel(features, rec, [part_source(rec, lo, hi)
                                  for lo, hi in split(rec)])


_PREPARED: Dict[Tuple[bool, ...], Kernel] = {}


def prepare(*feature_sets) -> List[Kernel]:
    """Record, generate, build and load the kernels of these feature sets
    (at most once per process each); every part not yet built is compiled
    at once, one ``nvcc`` per source."""
    global compiles
    feature_sets = [tuple(bool(x) for x in f) for f in feature_sets]
    todo = [plan(f) for f in dict.fromkeys(feature_sets)
            if f not in _PREPARED]
    missing = {}
    for kernel in todo:
        for part in kernel.parts:
            if not (BUILD / f"part_{part.key}.so").exists():
                missing[part.key] = part
    if missing:
        BUILD.mkdir(parents=True, exist_ok=True)
        sources = []
        for key, part in sorted(missing.items()):
            cu = BUILD / f"part_{key}.cu"
            cu.write_text(part.text)
            sources.append(cu)
        _kernels.build_generated(sources, NVCC_EXTRA)
        compiles += len(sources)
    for kernel in todo:
        kernel.load()
        _PREPARED[kernel.features] = kernel
    return [_PREPARED[f] for f in feature_sets]


def quotient_evals_cuda(ext_r, ext_i, log_n: int, log_blowup: int, shift,
                        alpha, **args):
    """``constraints.quotient_evals`` on CUDA tensors: the generated
    kernels, one launch per part.  Returns the QM31 4-tuple of [N]
    rows."""
    from .constraints import _vec_alg

    if ext_r.shape[1] & (ext_r.shape[1] - 1):
        raise ValueError(f"the LDE domain has {ext_r.shape[1]} points, not "
                         "a power of two")
    A, keys = _vec_alg(ext_r, ext_i, log_blowup, **args)
    kernel, = prepare(features_of(keys))
    return kernel(A, keys, alpha, log_n, log_blowup, shift)
