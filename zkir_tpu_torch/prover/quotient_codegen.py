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
3. The terms are cut in order into parts of about ``PART_BUDGET``
   operations (``cut_parts``): straight-line code must stay in an SM's
   instruction cache, and one kernel of all terms (some 200,000
   instructions a point) ran at a third of the speed of small parts on
   the H100 (``PERF.md``).  A CTA owns ``TILE`` consecutive points, one a
   thread; it computes its part's nodes once each, in order, and sums
   alpha^j C_j per divisor tag in registers; then each tag's sum times
   that tag's 1/Z(x) goes to the part's own rows of partial sums, or, in
   the last part, is added to the earlier parts' sums into the result.
4. A part's columns are staged in shared memory as 32-bit words, by
   ``cp.async`` copies: ``cut_stages`` cuts its nodes into stages that
   each bring ``STAGE_COLUMNS`` new columns, and ``staging_plan`` gives
   each column a slot from its first stage to its last, issuing the
   copies for a stage while the stage before computes; a slot is given
   to a new column only after the stage that last reads the old one has
   passed its barrier.  Every read of a column is a shared-memory load.
5. Each part is one kernel and one launch.  Its shared library is named
   by a hash of its text, the headers and the flags, and built under
   ``build_dir()`` at first use (``$ZKIR_CACHE_DIR/quotient``, else
   ``zkir_tpu_torch/_build/quotient/``; all missing parts at once, one
   ``nvcc`` each; processes that build the same part at once each write
   its files under a name of their own and rename them); a part's text is
   a function of its terms and of the trace's blowup alone, so feature
   sets whose terms begin alike share their first parts.  A failed build
   or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import heapq
import os
import pathlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import _kernels
from ..spec.field import M31_PRIME

P = M31_PRIME
BUILD = _kernels.BUILD / "quotient"
NVCC_EXTRA = ("-Xptxas", "-v")
# Points a CTA owns, one a thread.  A CTA's shared-memory slots are the
# SM's shared memory over MIN_BLOCKS CTAs and the 4-byte words of a slot
# (219 for a blowup of 4; the widest term reads 208 columns); a part's
# __launch_bounds__ is the CTAs an SM can hold for its slots, from
# MIN_BLOCKS to MAX_BLOCKS, which caps the registers so that they fit.
TILE = 128
MIN_BLOCKS = 2
MAX_BLOCKS = 4
SMEM_PER_SM = 233_472          # H100: 228 KB for the CTAs of an SM
SMEM_PER_BLOCK = 232_448       # at most 227 KB for one CTA
SMEM_RESERVED = 1_024          # what the system keeps of each CTA's share
# M31 operations (nodes, plus ACC_COST a term) in one part; new columns a
# stage brings.  The fastest of the values tools/quotient_bench.py times
# on an H100.
PART_BUDGET = 1_000
STAGE_COLUMNS = 8
ACC_COST = 12
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

    def compile(self, wanted: List[int]):
        """A function of the input words that returns the values of the
        definitions ``wanted`` (``evaluate``'s): straight-line Python over
        the definitions they depend on, so a proof's table costs no
        interpretation."""
        need, stack = set(), list(wanted)
        while stack:
            k = stack.pop()
            if k not in need:
                need.add(k)
                stack += [o[1] for o in self.defs[k][1:]
                          if isinstance(o, tuple) and o[0] == "s"]
        lines = ["def program(x):"]
        for k in sorted(need):
            d = self.defs[k]
            if d[0] == "in":
                lines.append(f"    v{k} = x[{d[1]}] % {P}")
                continue
            a, b = (f"v{o[1]}" if o[0] == "s" else str(o[1]) for o in d[1:])
            # Python's integers do not wrap: only products are reduced,
            # sums and differences once at the end.
            if d[0] == "mul":
                lines.append(f"    v{k} = {a} * {b} % {P}")
            else:
                lines.append(f"    v{k} = {a} {'+' if d[0] == 'add' else '-'} {b}")
        lines.append(f"    return [{', '.join(f'v{k} % {P}' for k in wanted)}]")
        env: Dict[str, object] = {}
        exec("\n".join(lines), env)
        return env["program"]

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


def plan_key(range_lookup: bool, program: bool, log_blowup: int):
    """The (feature set, log_blowup) of the parts that a prove with these
    options evaluates (``prepare``'s argument): with ``range_lookup`` every
    lookup feature, the program's with a bound program."""
    return (range_lookup,) * 5 + (program,), log_blowup


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
# Stages, parts and the staging plan.
# ============================================================================


def n_slots(shift: int) -> int:
    """The shared-memory slots of one CTA: its share of the SM's shared
    memory at ``MIN_BLOCKS`` CTAs, over the 4-byte words of a slot
    (``TILE + shift``)."""
    share = min(SMEM_PER_BLOCK, SMEM_PER_SM // MIN_BLOCKS - SMEM_RESERVED)
    return share // (4 * (TILE + shift))


class Stage(NamedTuple):
    lo: int                 # terms [lo, hi) of the recording, summed here
    hi: int
    order: List[int]        # the nodes it computes, each after its operands
    leaves: frozenset       # the leaf ids (columns) it reads


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


def _leaves_of(alg: RecAlg, order) -> set:
    return {alg.nodes[x][1] for x in order if alg.nodes[x][0] == "leaf"}


def cut_parts(rec: Recording, slots: int) -> List[Tuple[int, int]]:
    """Cut the terms, in order, into ranges of about ``PART_BUDGET``
    operations (a part's own nodes plus ``ACC_COST`` a term) and at most
    ``slots`` columns: a part's code must stay in an SM's instruction
    cache, and its columns in a CTA's shared memory."""
    alg = rec.alg
    bounds, seen, cost, cols = [0], set(), 0, set()
    for j, (_, comps) in enumerate(rec.terms):
        probe = set(seen)
        new = _needed(alg, comps, probe)
        wide = cols | _leaves_of(alg, new)
        if cost and (cost + len(new) + ACC_COST > PART_BUDGET
                     or len(wide) > slots):
            bounds.append(j)
            probe = set()
            new = _needed(alg, comps, probe)
            cost, wide = 0, _leaves_of(alg, new)
        if len(wide) > slots:
            raise ValueError(f"term {j} reads {len(wide)} columns; a CTA "
                             f"has {slots} slots")
        seen, cols = probe, wide
        cost += len(new) + ACC_COST
    bounds.append(len(rec.terms))
    return list(zip(bounds[:-1], bounds[1:]))


def cut_stages(rec: Recording, lo: int, hi: int) -> List[Stage]:
    """Cut the nodes of terms [lo, hi), each computed once in order, into
    stages that each bring ``STAGE_COLUMNS`` columns the part has not read
    before: the copies for a stage are in flight while the stage before
    computes.  A stage's ``order`` is the nodes it computes (values that a
    later stage uses stay in registers), its ``leaves`` the columns it
    reads (from shared memory, at each stage that reads them), and terms
    [lo, hi) of it are accumulated once their roots are computed."""
    alg = rec.alg
    order = [x for x in _needed(alg, [x for _, c in rec.terms[lo:hi]
                                      for x in c], set())
             if alg.nodes[x][0] != "leaf"]
    stages: List[Stage] = []
    chunk_of: Dict[int, int] = {}
    refs: List[set] = [set()]
    nodes: List[List[int]] = [[]]
    known: set = set()
    fresh = 0
    for x in order:
        node = alg.nodes[x]
        chunk_of[x] = len(nodes) - 1
        nodes[-1].append(x)
        if node[0] == "par":
            continue
        for a in node[1:]:
            if alg.nodes[a][0] == "leaf":
                refs[-1].add(alg.nodes[a][1])
                fresh += alg.nodes[a][1] not in known
                known.add(alg.nodes[a][1])
        if fresh >= STAGE_COLUMNS:
            refs.append(set())
            nodes.append([])
            fresh = 0
    last, ends = 0, []
    for j in range(lo, hi):
        comps = _term_values(alg, rec.terms[j][1]) or ()
        at = max([last] + [chunk_of[x] for x in comps if x in chunk_of])
        for x in comps:
            if alg.nodes[x][0] == "leaf":
                refs[at].add(alg.nodes[x][1])
        ends.append(at)
        last = at
    first = lo
    for k in range(len(nodes)):
        top = lo + sum(e <= k for e in ends)
        if nodes[k] or top > first:
            stages.append(Stage(first, top, nodes[k], frozenset(refs[k])))
            first = top
    assert first == hi
    return stages


class Staging(NamedTuple):
    """Where a part's columns live in shared memory.  Stage s computes at
    time 2 s + 1, after its barrier; its copies are issued at 2 s - 1,
    while stage s - 1 computes (stage 0's before it)."""
    copies: List[List[Tuple[int, int]]]   # stage -> [(slot, leaf)]
    slot_of: List[Dict[int, int]]         # stage -> {leaf it reads: slot}
    slots: int                            # slots used


def staging_plan(leaf_sets: List[frozenset], slots: int) -> Staging:
    """Assign the columns each stage reads to slots.  A column is copied
    once, for its first stage, and stays in its slot until its last: a
    part's columns all fit the slots (``cut_parts``).  A slot holds one
    column at a time: it is given to another only from the issue time
    after the barrier that ends the old column's last stage."""
    assert len(frozenset().union(*leaf_sets)) <= slots
    span: Dict[int, List[int]] = {}
    for s, leaves in enumerate(leaf_sets):
        for leaf in leaves:
            span.setdefault(leaf, [s, s])[1] = s
    free: List[int] = []
    busy: List[Tuple[int, int]] = []       # (last time read, slot)
    used = 0
    copies: List[List[Tuple[int, int]]] = [[] for _ in leaf_sets]
    slot_of: List[Dict[int, int]] = [{} for _ in leaf_sets]
    for leaf, (first, last) in sorted(span.items(),
                                      key=lambda kv: (kv[1][0], kv[0])):
        start = 2 * first - 1
        while busy and busy[0][0] < start:
            heapq.heappush(free, heapq.heappop(busy)[1])
        if free:
            slot = heapq.heappop(free)
        else:
            slot, used = used, used + 1
        heapq.heappush(busy, (2 * last + 1, slot))
        copies[first].append((slot, leaf))
        for s in range(first, last + 1):
            if leaf in leaf_sets[s]:
                slot_of[s][leaf] = slot
    for c in copies:
        c.sort()
    return Staging(copies, slot_of, used)


class Part(NamedTuple):
    """One kernel and one launch: terms [lo, hi) over every tile."""
    lo: int                 # terms [lo, hi) of the recording
    hi: int
    stages: List[Stage]
    staging: Staging
    leaves: List[int]       # its column pointers -> leaf ids
    params: List[int]       # its challenge words -> scalar-program defs
    n_ops: int              # M31 operations in the part
    tags: List[str]         # divisor tags of its terms, in "HTFL" order
    text: str = ""          # the generated .cu
    key: str = ""           # the hash that names its build

    @property
    def reads(self) -> int:
        """Global column reads a point: the columns copied into shared
        memory and the real and imaginary 1/Z rows of each tag."""
        return sum(map(len, self.staging.copies)) + 2 * len(self.tags)


def _describe(leaf) -> str:
    accessor, args, comp = leaf
    return f"{accessor}({', '.join(map(str, args))})[{comp}]"


def _term_values(alg: RecAlg, comps):
    """A term's nodes as the kernel accumulates them: None for a term that
    is 0, its CM31 pair where its u-part is 0, else all four."""
    if all(alg._val(x) == 0 for x in comps):
        return None
    if len(comps) == 4 and alg._val(comps[2]) == alg._val(comps[3]) == 0:
        return comps[:2]
    return comps


def make_part(rec: Recording, stages: List[Stage], slots: int,
              log_blowup: int) -> Part:
    """A part's staging plan, its table's layout and its source."""
    alg = rec.alg
    staging = staging_plan([s.leaves for s in stages], slots)
    leaves: Dict[int, int] = {}
    for c in staging.copies:
        for _, leaf in c:
            leaves.setdefault(leaf, len(leaves))
    params: Dict[int, int] = {}
    for stage in stages:
        for x in stage.order:
            if alg.nodes[x][0] == "par":
                params.setdefault(alg.nodes[x][1], len(params))
    lo, hi = stages[0].lo, stages[-1].hi
    tags = sorted({rec.terms[j][0] for j in range(lo, hi)}, key="HTFL".index)
    part = Part(lo, hi, stages, staging, sorted(leaves, key=leaves.get),
                sorted(params, key=params.get),
                sum(len(s.order) for s in stages), tags)
    text = part_source(rec, part, log_blowup)
    return part._replace(text=text, key=part_key(text))


def _part_lines(rec: Recording, part: Part) -> List[str]:
    """The statements of one part over one tile: its stages in order, then
    each tag's sum times 1/Z into the part's rows of partial sums (or the
    result)."""
    alg, staging = rec.alg, part.staging
    col = {leaf: k for k, leaf in enumerate(part.leaves)}
    word = {d: k for k, d in enumerate(part.params)}
    pw_base = len(part.params)

    def copy_lines(s):
        def calls(fn, ind):
            return [f"{ind}{fn}(sm + {slot} * QP_SPAN, tab.c[{col[leaf]}], "
                    f"base, n, t);  // {_describe(alg.leaves[leaf])}"
                    for slot, leaf in staging.copies[s]]

        if not staging.copies[s]:
            return ["    qp_commit();"]
        return [*calls("qp_copy", " " * 4), "    if (t < QP_SHIFT) {",
                *calls("qp_halo", " " * 8), "    }", "    qp_commit();"]

    body = [f"    qacc acc_{tag} = {{}};" for tag in part.tags]
    body += copy_lines(0)
    name = {x: f"v{k}" for k, x in enumerate(
        x for stage in part.stages for x in stage.order)}
    n_stages = len(part.stages)
    for s, stage in enumerate(part.stages):
        ahead = s + 1 < n_stages
        if ahead:
            body += copy_lines(s + 1)
        body += [f"    qp_wait<{int(ahead)}>();", "    __syncthreads();",
                 f"    // stage {s}: terms [{stage.lo}, {stage.hi})"]
        reads: Dict[int, str] = {}

        def ref(x):
            node = alg.nodes[x]
            if node[0] == "imm":
                return f"{node[1]}u"
            if node[0] != "leaf":
                return name[x]
            if x not in reads:
                reads[x] = f"s{s}_{len(reads)}"
                at = " + QP_SHIFT" if node[2] else ""
                body.append(f"    const uint32_t {reads[x]} = "
                            f"sm[{staging.slot_of[s][node[1]]} * QP_SPAN{at} "
                            f"+ t];  // {_describe(alg.leaves[node[1]])}")
            return reads[x]

        for x in stage.order:
            node = alg.nodes[x]
            if node[0] == "par":
                expr = f"tab.w[{word[node[1]]}]"
            else:
                expr = f"{_C_OPS[node[0]]}({', '.join(map(ref, node[1:]))})"
            body.append(f"    const uint32_t {name[x]} = {expr};")
        for j in range(stage.lo, stage.hi):
            comps = _term_values(alg, rec.terms[j][1])
            if comps is None:
                continue
            vals = [ref(x) for x in comps]
            pairs = [f"cm31{{{a}, {b}}}" for a, b in zip(vals[::2], vals[1::2])]
            at = pw_base + 4 * (j - part.lo)
            body.append(f"    qp_acc{len(comps)}(acc_{rec.terms[j][0]}, "
                        f"{', '.join(pairs)}, qp_pair(tab, {at}), "
                        f"qp_pair(tab, {at + 2}));  // term {j}")
        if ahead:
            body.append("    __syncthreads();")
    return body + [
        "    if (i >= n) return;",
        "    qacc r = {};",
        *[f"    qp_divide(r, acc_{tag}, dinv + {TAG_ROW[tag]} * n, n, i);"
          for tag in part.tags],
        "    qp_finish(partial, out, part, r, n, i);"]


def part_source(rec: Recording, part: Part, log_blowup: int) -> str:
    """The CUDA source of one part: CTA b runs the part on tile b.  Its
    text names only what the part reads and computes, so equal parts give
    equal text; which part of the launches it is, and whether it is the
    last, are arguments."""
    n_words = len(part.params) + 4 * (part.hi - part.lo)
    lines = [
        "// Generated by zkir_tpu_torch/prover/quotient_codegen.py from the",
        "// constraint system: one part of the quotient.  Do not edit.",
        f"// Terms [{part.lo}, {part.hi}) in {len(part.stages)} stages, "
        f"{part.n_ops} M31 operations, "
        f"{sum(map(len, part.staging.copies))} column copies into "
        f"{part.staging.slots} slots.",
        f"#define QP_TILE {TILE}",
        f"#define QP_SHIFT {1 << log_blowup}",
        f"#define QP_SLOTS {part.staging.slots}",
        '#include "quotient.cuh"',
        "",
        f"typedef qp_table<{len(part.leaves)}, {n_words}> table_t;",
        "",
        f"extern \"C\" __global__ void __launch_bounds__(QP_TILE, "
        f"{ctas_per_sm(part, 1 << log_blowup)})",
        "quotient_part_kernel(const __grid_constant__ table_t tab,",
        "                     const int64_t* __restrict__ dinv,",
        "                     uint32_t* __restrict__ partial,",
        "                     int64_t* __restrict__ out, int part, long long n) {",
        "    extern __shared__ uint32_t sm[];",
        "    const int t = threadIdx.x;",
        "    const long long base = (long long)blockIdx.x * QP_TILE;",
        "    const long long i = base + t;",
        *_part_lines(rec, part),
        "}",
        "",
        "extern \"C\" int quotient_part(const int64_t* cols, "
        "const uint32_t* words,",
        "                              const int64_t* dinv, uint32_t* partial,",
        "                              int64_t* out, int part, long long n,",
        "                              cudaStream_t stream) {",
        "    table_t tab;",
        "    memcpy(tab.c, cols, sizeof tab.c);",
        "    memcpy(tab.w, words, sizeof tab.w);",
        "    const int smem = QP_SLOTS * QP_SPAN * 4;",
        "    const cudaError_t err = cudaFuncSetAttribute(",
        "        quotient_part_kernel, "
        "cudaFuncAttributeMaxDynamicSharedMemorySize, smem);",
        "    if (err != cudaSuccess) return (int)err;",
        "    quotient_part_kernel<<<(unsigned)((n + QP_TILE - 1) / QP_TILE), "
        "QP_TILE, smem,",
        "                           stream>>>(tab, dinv, partial, out, part, n);",
        "    return (int)cudaGetLastError();",
        "}",
        "",
    ]
    return "\n".join(lines)


def ctas_per_sm(part: Part, shift: int) -> int:
    """The CTAs an SM can hold for this part by its shared memory, from
    ``MIN_BLOCKS`` to ``MAX_BLOCKS``: its kernel's ``__launch_bounds__``,
    which caps the registers so that as many fit."""
    smem = 4 * (TILE + shift) * part.staging.slots + SMEM_RESERVED
    return max(MIN_BLOCKS, min(MAX_BLOCKS, SMEM_PER_SM // smem))


def part_key(text: str) -> str:
    """The build's name: a hash of the generated text, the headers it
    includes and the compiler flags."""
    h = hashlib.sha256(text.encode())
    for f in ("m31.cuh", "quotient.cuh"):
        h.update((_kernels.CSRC / f).read_bytes())
    h.update(" ".join((*_kernels.NVCC_FLAGS, *NVCC_EXTRA)).encode())
    return h.hexdigest()[:16]


def operation_counts(rec: Recording) -> Dict[str, int]:
    """The helper calls one point needs whatever the kernel's design:
    every M31 node of the recording once (no node computed twice, no
    column read counted), one ``qp_acc2`` or ``qp_acc4`` a term, one
    ``qp_divide`` a divisor tag and one store of the four words
    (``qp_finish``)."""
    alg = rec.alg
    counts: Dict[str, int] = {name: 0 for name in _C_OPS.values()}
    for x in _needed(alg, [x for _, c in rec.terms for x in c], set()):
        if alg.nodes[x][0] in _C_OPS:
            counts[_C_OPS[alg.nodes[x][0]]] += 1
    counts.update(qp_acc2=0, qp_acc4=0, qp_finish=1,
                  qp_divide=len({tag for tag, _ in rec.terms}))
    for _, comps in rec.terms:
        comps = _term_values(alg, comps)
        if comps is not None:
            counts[f"qp_acc{len(comps)}"] += 1
    return counts


# ============================================================================
# The host's table: alpha powers, challenge words, column addresses.
# ============================================================================


def _times_matrix(c) -> np.ndarray:
    """The 4 x 4 matrix (uint64, entries mod p) of x -> x c on QM31 words
    (a.re, a.im, b.re, b.im): (A + B u)(a + b u) = (A a + R B b) + (A b +
    B a) u, R = u^2 = 2 + i."""
    a0, a1, b0, b1 = (int(v) % P for v in c)
    rb0, rb1 = 2 * b0 - b1, b0 + 2 * b1          # R b
    m = [[a0, -a1, rb0, -rb1], [a1, a0, rb1, rb0],
         [b0, -b1, a0, -a1], [b1, b0, a1, a0]]
    return np.asarray([[v % P for v in row] for row in m], dtype=np.uint64)


def alpha_powers(alpha, n_terms: int) -> np.ndarray:
    """alpha^0 .. alpha^(n_terms - 1) as [n_terms, 4] uint32 QM31 words,
    the words of ``constraints._alpha_powers_np``, by doubling: powers
    [k, 2k) are powers [0, k) times alpha^k, one product by a 4 x 4
    matrix a round (four products of words < 2^31 sum below 2^64)."""
    pw = np.zeros((n_terms, 4), dtype=np.uint64)
    pw[0, 0] = 1
    step = np.asarray([int(a) % P for a in alpha], dtype=np.uint64)
    k = 1
    while k < n_terms:
        m = min(k, n_terms - k)
        times = _times_matrix(step)
        pw[k:k + m] = (pw[:m] @ times.T) % P
        step = (times @ step) % P
        k *= 2
    return pw.astype(np.uint32)


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


@functools.lru_cache(maxsize=8)
def _dinv_rows(log_n, log_blowup, shift, device):
    """1/Z_H, 1/Z_trans, 1/Z_first, 1/Z_last as an [8, N] int64 table on
    ``device`` (real and imaginary rows per tag, ``TAG_ROW``).  A
    streaming prove asks for four, one per coset of the LDE domain (its
    own shift each, at log_blowup 0)."""
    from .constraints import _vanishing_tables

    rows = np.stack(_vanishing_tables(log_n, log_blowup, shift))
    return torch.from_numpy(rows.astype(np.int64)).to(device)


# ============================================================================
# Build, load, launch.
# ============================================================================


class Kernel:
    """A feature set's recording and parts at one blowup, and the loaded
    libraries."""

    def __init__(self, features, log_blowup, rec: Recording,
                 parts: List[Part]):
        self.features, self.log_blowup = features, log_blowup
        self.rec, self.parts = rec, parts
        self.leaf_groups = _leaf_groups(rec.alg.leaves)
        wanted = sorted(set().union(*(p.params for p in parts)))
        self._words = rec.scalars.compile(wanted)
        # A part's words, as indices into the challenge words followed by
        # the flat alpha powers.
        at = {k: n for n, k in enumerate(wanted)}
        self._gather = [
            (np.asarray(p.leaves, dtype=np.int64),
             np.asarray([at[k] for k in p.params] + list(
                 range(len(wanted) + 4 * p.lo, len(wanted) + 4 * p.hi)),
                 dtype=np.int64)) for p in parts]
        self.fns = []

    def load(self):
        for part in self.parts:
            lib = ctypes.CDLL(str(build_dir() / f"part_{part.key}.so"))
            fn = lib.quotient_part
            fn.argtypes = [ctypes.c_void_p] * 5 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self.fns.append((lib, fn))

    def table(self, A, keys, alpha):
        """Every part's table, built once for a proof: the addresses of its
        columns in ``A`` (int64), then its challenge words for these
        challenges and its terms' alpha powers (uint32)."""
        words = np.concatenate([
            np.asarray(self._words(challenge_words(keys)), dtype=np.uint32),
            alpha_powers(alpha, len(self.rec.terms)).ravel()])
        ptrs = _leaf_pointers(A, self.leaf_groups, len(self.rec.alg.leaves),
                              A.big)
        return [(ptrs[leaves], words[at]) for leaves, at in self._gather]

    def __call__(self, A, keys, alpha, log_n, shift):
        return self.launch(self.table(A, keys, alpha), _dinv_rows(
            log_n, self.log_blowup, tuple(shift), A.ext_r.device), A.big)

    def launch(self, tables, dinv, n):
        """One launch per part on the current stream: the QM31 4-tuple of
        [n] rows.  Every part but the last writes its rows of partial
        sums; the last adds them to its own into the result.  The tables
        stay on the host: each launch copies its part's into the kernel's
        parameters."""
        last = len(self.parts) - 1
        partial = torch.empty((last, 4, n), dtype=torch.int32,
                              device=dinv.device)
        out = torch.empty((4, n), dtype=torch.int64, device=dinv.device)
        lib = _kernels._lib or _kernels._load()
        stream = _kernels._current_stream()
        for k, ((_, fn), (cols, words)) in enumerate(zip(self.fns, tables)):
            err = fn(cols.ctypes.data, words.ctypes.data, dinv.data_ptr(),
                     partial.data_ptr(), out.data_ptr() if k == last else None,
                     k, n, stream)
            _kernels._check(lib, err, "quotient_part")
            _kernels.launches["quotient_part"] += 1
        return tuple(out)


def plan(features, log_blowup: int) -> Kernel:
    """A feature set's recording and generated parts at this blowup, not
    yet built."""
    rec = record(features)
    slots = n_slots(1 << log_blowup)
    return Kernel(features, log_blowup, rec, [
        make_part(rec, cut_stages(rec, lo, hi), slots, log_blowup)
        for lo, hi in cut_parts(rec, slots)])


_PREPARED: Dict[tuple, Kernel] = {}


def build_dir() -> pathlib.Path:
    """Where the parts are built and loaded from: ``quotient`` under
    ``ZKIR_CACHE_DIR`` (the reference's cache root, which its prove
    reads) when it is set, else ``BUILD``."""
    root = os.environ.get("ZKIR_CACHE_DIR")
    return pathlib.Path(root) / "quotient" if root else BUILD


def prepare(*keys) -> List[Kernel]:
    """Record, generate, build and load the kernels of these (feature
    set, log_blowup) pairs (at most once per process each); every part
    not yet built is compiled at once, one ``nvcc`` per source."""
    global compiles
    keys = [(tuple(bool(x) for x in f), int(b)) for f, b in keys]
    todo = [plan(*k) for k in dict.fromkeys(keys) if k not in _PREPARED]
    build = build_dir()
    missing = {}
    for kernel in todo:
        for part in kernel.parts:
            if not (build / f"part_{part.key}.so").exists():
                missing[part.key] = part
    if missing:
        build.mkdir(parents=True, exist_ok=True)
        sources = []
        for key, part in sorted(missing.items()):
            # Written under this process's name, then renamed: nvcc never
            # reads a file another process is writing.
            cu = build / f"part_{key}.cu"
            tmp = cu.with_suffix(f".tmp{os.getpid()}")
            tmp.write_text(part.text)
            os.replace(tmp, cu)
            sources.append(cu)
        _kernels.build_generated(sources, NVCC_EXTRA)
        compiles += len(sources)
    for kernel in todo:
        kernel.load()
        _PREPARED[kernel.features, kernel.log_blowup] = kernel
    return [_PREPARED[k] for k in keys]


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
    kernel, = prepare((features_of(keys), log_blowup))
    return kernel(A, keys, alpha, log_n, shift)
