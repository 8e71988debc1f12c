"""The generated quotient kernels' source against the JAX package,
tolerance 0.

The CUDA kernels build only on a machine with a GPU (``chip_smoke.py``
holds them against the plain version there).  Here the generated text and
the device helpers it calls (``csrc/m31.cuh``, ``csrc/quotient.cuh``) are
translated statement by statement into Python and run, a CTA at a time,
over the same tables of column addresses, challenge words and alpha
powers that a launch reads, with the asynchronous copies into shared
memory modelled; a statement the translation does not know fails.  The
result must equal the port's ``VecAlg`` quotient and the reference's
``quotient_evals`` (eager on the CPU, as the reference's tests run it)
word for word, and broken copies of the text, a helper or the staging
plan must not.  Inputs are random words from a numpy seed on a 32-point
domain (log_n = 3, log_blowup = 2), in tiles of 16 points.
"""

import functools
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkir_tpu.prover import constraints as ref_cs
from zkir_tpu_torch import _kernels
from zkir_tpu_torch.ops.qm31 import qm31_mul_scalar
from zkir_tpu_torch.prover import constraints as cs
from zkir_tpu_torch.prover import quotient_codegen as qc
from zkir_tpu_torch.prover.aux_table import N_AUX_COLS
from zkir_tpu_torch.prover.prover import _coset_shift
from zkir_tpu_torch.prover.trace import N_COLUMNS

P = (1 << 31) - 1
SEED = 20261016
LOG_N, LOG_BLOWUP = 3, 2
N = 1 << (LOG_N + LOG_BLOWUP)
OFF = (False,) * 6
ON = (True,) * 5 + (False,)
BOUND = (True,) * 6
FEATURE_SETS = {"off": OFF, "on": ON, "program": BOUND}


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """The suite runs several pytest workers on one machine; a torch
    intra-op thread per core in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(features, seed):
    """``quotient_evals``'s arguments for a feature set: (ext_r, ext_i,
    keyword arguments, alpha), numpy ``int64`` throughout.  The three
    feature sets of one seed share their words: without ``range_lookup``
    the trace columns alone, without a program the same minus its
    arguments."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.integers(0, P, shape, dtype=np.int64)

    def q(k=None):
        return tuple(w(N) if k is None else w(k, N) for _ in range(4))

    def ch():
        return tuple(int(x) for x in rng.integers(1, P, 4))

    ext_r, ext_i = w(cs.COL_PROG_M + 1, N), w(cs.COL_PROG_M + 1, N)
    beta, delta = ch(), ch()
    args = dict(
        lookup=(q(cs.NUM_LOOKUP), beta),
        aux=((w(N_AUX_COLS, N), w(N_AUX_COLS, N)), q(cs.NUM_AUX), ch()),
        memory=((q(), q()), delta, ch()), io=((q(), q()), delta, ch()),
        crypto=((q(cs.N_SLOTS), q(), q()), delta, ch()),
        program=((w(4, N), w(4, N)), q(), ch(),
                 int(rng.integers(0, 1 << 40))))
    alpha = ch()
    if not features[5]:
        args["program"] = None
    if not features[0]:
        args = dict.fromkeys(args)
        ext_r, ext_i = ext_r[:N_COLUMNS], ext_i[:N_COLUMNS]
    return ext_r, ext_i, args, alpha


def _convert(x, fn):
    if isinstance(x, np.ndarray):
        return fn(x)
    if isinstance(x, tuple):
        return tuple(_convert(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _convert(v, fn) for k, v in x.items()}
    return x


def _port(inputs):
    return _convert(inputs, torch.from_numpy)


# ----------------------------------------------------------------------------
# The device code as Python: the generated text and the helpers it calls
# (csrc/m31.cuh, csrc/quotient.cuh) translated statement by statement and
# run on numpy int64 words, a CTA at a time with its threads as one vector.
# The staging primitives (cp.async, its groups and waits) are modelled: a
# copy poisons its destination when it is issued and lands when a wait
# covers its group, so a slot read before its copy landed, or overwritten
# while a stage still reads it, gives wrong words.  A statement the
# translation does not know fails the test.
# ----------------------------------------------------------------------------

POISON = 0x5A5A5A5A
TEST_TILE = 16          # two CTAs over the 32-point domain: the last wraps
_LIVE = [None]          # the threads not yet returned, or None: all


class Ptr:
    """A device pointer: a flat int64 array and an offset in words (one
    per thread, or one for all).  Once threads have returned, reads give
    them 0 and writes skip them."""

    def __init__(self, a, at=0):
        self.a, self.at = a.reshape(-1), at

    def __add__(self, k):
        return Ptr(self.a, self.at + k)

    def _masked(self, idx):
        live = _LIVE[0]
        if live is None or np.ndim(idx) == 0:
            return None
        return live

    def __getitem__(self, idx):
        live = self._masked(idx)
        if live is None:
            return self.a[self.at + idx]
        out = np.zeros(len(live), dtype=self.a.dtype)
        out[live] = self.a[(self.at + idx)[live]]
        return out

    def __setitem__(self, idx, v):
        live = self._masked(idx)
        if live is None:
            self.a[self.at + idx] = v
        else:
            self.a[(self.at + idx)[live]] = np.broadcast_to(v, live.shape)[live]


class Qacc:
    def __init__(self):
        self.a = self.b = (0, 0)


class Copies:
    """cp.async as the kernel's threads see it: ``cp4`` poisons the
    destination at once and queues the word; ``commit`` closes a group;
    ``wait(n)`` lands every group but the ``n`` most recent."""

    def __init__(self):
        self.groups, self.open = [], []

    def cp4(self, dst, src, pred):
        pred = np.broadcast_to(pred, np.shape(dst.at))
        if _LIVE[0] is not None:
            pred = pred & _LIVE[0]
        to = dst.at[pred]
        words = src.a[src.at[pred]] & 0xFFFFFFFF
        dst.a[to] = POISON
        self.open.append((dst.a, to, words))

    def commit(self):
        self.groups.append(self.open)
        self.open = []

    def wait(self, n):
        while len(self.groups) > n:
            for a, to, words in self.groups.pop(0):
                a[to] = words


def _u32(x):
    return x & 0xFFFFFFFF


def _exit_where(cond):
    """``if (cond) return;``: those threads run no further statement."""
    _LIVE[0] = ~cond if _LIVE[0] is None else _LIVE[0] & ~cond


_MASKS = []


def _mask_push(cond):
    """``if (cond) {``: the block's statements run on those threads."""
    _MASKS.append(_LIVE[0])
    _LIVE[0] = cond if _LIVE[0] is None else _LIVE[0] & cond


def _mask_pop():
    _LIVE[0] = _MASKS.pop()


def _sel(c, x, y):
    return np.where(c, x, y) if isinstance(c, np.ndarray) else (x if c else y)


_CAST = re.compile(r"\((uint32_t|uint64_t|long long|int)\)")
_DECL = re.compile(r"(?:const )?(uint32_t|uint64_t|long long|int|cm31|qacc) "
                   r"(\w+)(\[\d+\])? = (.*);")
# The staging primitives, modelled by ``Copies``: the only helpers with
# inline assembly.
_MODELLED = {"qp_cp4", "qp_commit", "qp_wait"}


def _operand_end(e, k):
    """Where the C operand that begins at e[k] ends: a name or a
    parenthesised group, with its calls, subscripts and members."""
    def close(k):
        depth = 0
        for m in range(k, len(e)):
            depth += (e[m] in "([") - (e[m] in ")]")
            if depth == 0:
                return m + 1

    k = close(k) if e[k] == "(" else k + re.match(r"\w+", e[k:]).end()
    while k < len(e) and e[k] in "([.":
        k = close(k) if e[k] != "." else k + re.match(r"\.\w+", e[k:]).end()
    return k


def _ternary(e):
    depth, q, c = 0, None, None
    for k, ch in enumerate(e):
        depth += (ch in "([") - (ch in ")]")
        if depth == 0 and ch == "?" and q is None:
            q = k
        elif depth == 0 and ch == ":" and q is not None and c is None:
            c = k
    if q is None:
        return e
    return f"_sel({e[:q]}, {e[q + 1:c]}, {_ternary(e[c + 1:])})"


def _expr(e):
    """A C expression of the device code as Python."""
    e = re.sub(r"reinterpret_cast<[^>]*>", "", e)
    e = re.sub(r"\b(0x[0-9a-fA-F]+|\d+)u\b", r"\1", e)
    e = re.sub(r"\btrue\b", "True", e)
    while m := _CAST.search(e):
        end = _operand_end(e, m.end())
        wrap = "_u32" if m[1] == "uint32_t" else ""
        e = f"{e[:m.start()]}{wrap}({e[m.end():end]}){e[end:]}"
    e = e.replace("cm31{", "(").replace("{", "(").replace("}", ")")
    e = e.replace(" / ", " // ")
    return _ternary(e.replace(".re", "[0]").replace(".im", "[1]"))


def _split_statements(body):
    """C statements, one a line, whitespace folded, comments dropped."""
    out, buf = [], []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        buf.append(line)
        if line.endswith((";", "{", "}")) or line.startswith("#"):
            out.append(" ".join(" ".join(buf).split()))
            buf = []
    assert not buf, f"unterminated statement: {buf}"
    return out


def _statements(body, returns):
    """Python lines (indented for a function body) for the C body's
    statements; a value of type uint32_t is truncated to 32 bits where it
    is declared, assigned or returned, as C does."""
    out, blocks, types = [], [], {}

    def typed(t, e):
        return f"_u32({e})" if t == "uint32_t" else e

    for st in _split_statements(body):
        ind = "    " * (1 + blocks.count("for"))
        if re.fullmatch(r"#pragma unroll( \d+)?|\(void\)\w+;", st):
            continue
        if st == "{":
            blocks.append("scope")
        elif st == "}":
            if blocks.pop() == "mask":
                out.append(f"{ind}_mask_pop()")
        elif m := re.fullmatch(r"for \(int (\w+) = (\d+); \1 < (\w+); "
                               r"\+\+\1\) \{", st):
            out.append(f"{ind}for {m[1]} in range({m[2]}, {m[3]}):")
            blocks.append("for")
        elif m := re.fullmatch(r"if \((\w+) == nullptr\) \{", st):
            out.append(f"{ind}if {m[1]} is None:")
            blocks.append("for")
        elif m := re.fullmatch(r"if \((t < \w+)\) \{", st):
            out.append(f"{ind}_mask_push({_expr(m[1])})")
            blocks.append("mask")
        elif st == "extern __shared__ uint32_t sm[];":
            out.append(f"{ind}sm = _shared()")
        elif m := re.fullmatch(r"qp_wait<(\d+)>\(\);", st):
            out.append(f"{ind}qp_wait({m[1]})")
        elif m := re.fullmatch(r"if \((.*)\) return;", st):
            out.append(f"{ind}_exit_where({_expr(m[1])})")
        elif st == "return;":
            out.append(f"{ind}return")
        elif m := re.fullmatch(r"return (.*);", st):
            out.append(f"{ind}return {typed(returns, _expr(m[1]))}")
        elif m := _DECL.fullmatch(st):
            types[m[2]] = None if m[3] else m[1]
            rhs = "Qacc()" if (m[1], m[4]) == ("qacc", "{}") else _expr(m[4])
            out.append(f"{ind}{m[2]} = {typed(types[m[2]], rhs)}")
        elif m := re.fullmatch(r"([\w.]+(?:\[[^\]]*\])?) = (.*);", st):
            out.append(f"{ind}{_expr(m[1])} = "
                       f"{typed(types.get(m[1]), _expr(m[2]))}")
        elif re.fullmatch(r"\w+\(.*\);", st):
            out.append(ind + _expr(st[:-1]))
        else:
            raise AssertionError(f"untranslated statement: {st!r}")
    assert not blocks, "unbalanced braces"
    return out


def _header_texts():
    return tuple((_kernels.CSRC / f).read_text()
                 for f in ("m31.cuh", "quotient.cuh"))


def _defines(text):
    return re.findall(r"^#define (\w+) (.+)$", text, re.M)


@functools.lru_cache(maxsize=None)
def _helpers(headers):
    """Every ``__device__`` function of the headers' texts, translated
    into one environment; the staging primitives are ``Copies``'s.  The
    ``#define``s are bound per launch (``_define``)."""
    env = {"_u32": _u32, "_sel": _sel, "Qacc": Qacc, "np": np,
           "_exit_where": _exit_where, "_mask_push": _mask_push,
           "_mask_pop": _mask_pop}
    for text in headers:
        found = list(re.finditer(
            r"^(?:template <[^>]*>\n)?__device__ __forceinline__ (\w+) "
            r"(\w+)\(([^)]*)\) \{\n(.*?)^\}$", text, re.M | re.S))
        assert len(found) == text.count("__device__")
        for m in found:
            returns, name, params, body = m.groups()
            assert (name in _MODELLED) == ("asm" in body), name
            if name in _MODELLED:
                continue
            args = [re.findall(r"\w+", p)[-1]
                    for p in re.sub(r"<[^>]*>", "", params).split(",")]
            exec("\n".join([f"def {name}({', '.join(args)}):",
                            *_statements(body, returns)]), env)
    return env


def _define(env, headers, defines):
    """A launch's ``#define``s, then the headers' (which use them)."""
    for name, value in defines:
        env[name] = eval(_expr(value), env)
    for text in headers:
        for name, value in _defines(text):
            env[name] = eval(_expr(value), env)


_PART = re.compile(
    r"(?:// [^\n]*\n)+((?:#define \w+ \d+\n)+)#include \"quotient\.cuh\"\n\n"
    r"typedef qp_table<(\d+), (\d+)> table_t;\n\n"
    r"extern \"C\" __global__ void __launch_bounds__\(QP_TILE, \d+\)\n"
    r"quotient_part_kernel\(const __grid_constant__ table_t tab,\n"
    r" +const int64_t\* __restrict__ dinv,\n"
    r" +uint32_t\* __restrict__ partial,\n"
    r" +int64_t\* __restrict__ out, int part, long long n\) \{\n"
    r"(.*?)\n\}\n\n"
    r"extern \"C\" int quotient_part\(const int64_t\* cols, "
    r"const uint32_t\* words,\n"
    r" +const int64_t\* dinv, uint32_t\* partial,\n"
    r" +int64_t\* out, int part, long long n,\n"
    r" +cudaStream_t stream\) \{\n"
    r"    table_t tab;\n"
    r"    memcpy\(tab\.c, cols, sizeof tab\.c\);\n"
    r"    memcpy\(tab\.w, words, sizeof tab\.w\);\n"
    r"    const int smem = QP_SLOTS \* QP_SPAN \* 4;\n"
    r"    const cudaError_t err = cudaFuncSetAttribute\(\n"
    r"        quotient_part_kernel, "
    r"cudaFuncAttributeMaxDynamicSharedMemorySize, smem\);\n"
    r"    if \(err != cudaSuccess\) return \(int\)err;\n"
    r"    quotient_part_kernel<<<\(unsigned\)\(\(n \+ QP_TILE - 1\) / "
    r"QP_TILE\), QP_TILE, smem,\n"
    r" +stream>>>\(tab, dinv, partial, out, part, n\);\n"
    r"    return \(int\)cudaGetLastError\(\);\n\}\n", re.S)


@functools.lru_cache(maxsize=None)
def _part_fn(text, headers):
    """A part's table size (column pointers, words) and its kernel as a
    Python function of (tab, dinv, partial, out, part, n) over one CTA's
    threads, in the environment of its helpers."""
    m = _PART.fullmatch(text)
    assert m, "not the layout of a quotient part"
    env = _helpers(headers)
    exec("\n".join(["def kernel(tab, dinv, partial, out, part, n):",
                    *_statements(m[4], "void")]), env)
    kernel = env["kernel"]
    _define(env, headers, _defines(m[1]))
    return int(m[2]), int(m[3]), kernel, tuple(_defines(m[1]))


def _run(kernel, grid, threads, args):
    """A launch: every CTA of the grid in turn, its threads as one
    vector."""
    env = kernel.__globals__
    for block in range(grid):
        env.update(blockIdx=types.SimpleNamespace(x=block),
                   threadIdx=types.SimpleNamespace(x=np.arange(threads)))
        _LIVE[0] = None
        try:
            kernel(*args)
        finally:
            _LIVE[0] = None


def _launch(text, headers, tab, dinv, partial, out, part, n):
    """A part's launch: a CTA a tile, each with fresh (poisoned) shared
    memory, one slot more than it asks for so that a read past its slots
    gives poison, not an index error."""
    _, _, kernel, defines = _part_fn(text, headers)
    env = kernel.__globals__
    _define(env, headers, defines)
    tile, span, slots = env["QP_TILE"], env["QP_SPAN"], env["QP_SLOTS"]

    def shared():
        copies = Copies()
        env.update(qp_cp4=copies.cp4, qp_commit=copies.commit,
                   qp_wait=copies.wait)
        return Ptr(np.full((slots + 1) * span, POISON, dtype=np.int64))

    env.update(_shared=shared, __syncthreads=lambda: None)
    _run(kernel, (n + tile - 1) // tile, tile,
         (tab, dinv, partial, out, part, n))


@functools.lru_cache(maxsize=None)
def _plan(features):
    return qc.plan(features, LOG_BLOWUP)


def _small_tile(text, tile=TEST_TILE):
    """A part's text with a tile of ``tile`` points: the same stages,
    plan and table, over fewer threads."""
    line = f"#define QP_TILE {qc.TILE}\n"
    assert text.count(line) == 1
    return text.replace(line, f"#define QP_TILE {tile}\n")


def _generated(features, inputs, edit=lambda text: text,
               headers=None, kernel=None, tile=TEST_TILE):
    """The quotient by the generated parts' text, as their launches
    compute it: the tables a launch reads, each part run in order over
    every CTA, into partial sums and an output that start as garbage
    (``torch.empty``).
    ``edit`` changes each part's text and ``headers`` the headers' before
    they are run; the parts run with a tile of ``tile`` points."""
    ext_r, ext_i, args, alpha = _port(inputs)
    kernel = kernel or _plan(features)
    A, keys = cs._vec_alg(ext_r, ext_i, LOG_BLOWUP, **args)
    tables = kernel.table(A, keys, alpha)
    column = {}
    for accessor, arg, comp in kernel.rec.alg.leaves:
        t = getattr(A, accessor)(*arg)[comp]
        column[t.data_ptr()] = t.numpy()
    dinv = qc._dinv_rows(LOG_N, LOG_BLOWUP, _coset_shift(),
                         torch.device("cpu")).numpy()
    last = len(kernel.parts) - 1
    partial = np.full((last, 4, N), 12345, dtype=np.int64)
    out = np.full((4, N), 12345, dtype=np.int64)
    headers = headers or _header_texts()
    for k, (part, (cols, words)) in enumerate(zip(kernel.parts, tables)):
        text = _small_tile(edit(part.text), tile)
        n_cols, n_words, _, _ = _part_fn(text, headers)
        assert (len(cols), len(words)) == (n_cols, n_words)
        tab = types.SimpleNamespace(c=[Ptr(column[int(x)]) for x in cols],
                                    w=[int(x) for x in words])
        _launch(text, headers, tab, Ptr(dinv), Ptr(partial),
                Ptr(out) if k == last else None, k, N)
    return tuple(torch.from_numpy(out))


def _plain(inputs):
    ext_r, ext_i, args, alpha = _port(inputs)
    return cs.quotient_evals(ext_r, ext_i, LOG_N, LOG_BLOWUP, _coset_shift(),
                             alpha, **args)


@pytest.fixture(scope="module")
def reference_terms():
    """The reference's ``VecAlg`` and terms for every argument and the
    program bound, on the CPU (eager, as its tests run it).  Without the
    program the terms are the first 884, without ``range_lookup`` the
    first 721 (``quotient_terms`` appends each argument's terms), so one
    evaluation serves all three feature sets."""
    ext_r, ext_i, args, _ = _convert(
        _inputs(BOUND, SEED), lambda a: jnp.asarray(a.astype(np.uint32)))
    lk, aux, memory = args["lookup"], args["aux"], args["memory"]
    io, crypto, program = args["io"], args["crypto"], args["program"]
    beta = lk[1]
    A = ref_cs.VecAlg(ext_r, ext_i, LOG_BLOWUP, chan_sums=lk[0],
                      mem_sum=memory[0], prog_sum=program[1],
                      prog_ext=program[0], aux_ext=aux[0], aux_sums=aux[1],
                      io_sum=io[0], cr_sums=crypto[0])
    terms = ref_cs.quotient_terms(
        A, lookup=beta, aux=(beta, aux[2]), memory=(beta, *memory[1:]),
        io=(beta, *io[1:]), crypto=(beta, *crypto[1:]),
        program=(beta, *program[2:]))
    return A, terms


def _reference(reference_terms, features):
    """The reference's quotient, ``_accumulate_quotient`` over the terms
    of ``features`` (what its ``quotient_evals`` returns)."""
    A, terms = reference_terms
    n_terms = {OFF: 721, ON: 884, BOUND: 887}[features]
    alpha = _inputs(features, SEED)[3]
    t = ref_cs._vanishing_tables(LOG_N, LOG_BLOWUP, _coset_shift())
    dinv = {tag: (jnp.asarray(t[2 * k]), jnp.asarray(t[2 * k + 1]))
            for k, tag in enumerate("HTFL")}
    got = ref_cs._accumulate_quotient(
        A, terms[:n_terms], ref_cs._alpha_powers_np(alpha, n_terms), dinv)
    return tuple(torch.from_numpy(np.asarray(c).astype(np.int64)) for c in got)


def _equal(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
def test_generated_source_equals_both_quotients(reference_terms, name):
    """The generated parts, the port's ``VecAlg`` path (the plain version
    CPU tensors take) and the reference: the same words at every point,
    without ``range_lookup``, with it, and with a program bound."""
    inputs = _inputs(FEATURE_SETS[name], SEED)
    got = _generated(FEATURE_SETS[name], inputs)
    _equal(got, _plain(inputs))
    _equal(got, _reference(reference_terms, FEATURE_SETS[name]))


def test_a_tile_wider_than_the_domain():
    """The production tile (128 points) over the 32-point domain: one CTA
    whose copies wrap three times and whose threads past the domain store
    nothing."""
    inputs = _inputs(OFF, SEED)
    _equal(_generated(OFF, inputs, tile=qc.TILE), _plain(inputs))


def _slot_freed_a_stage_early(monkeypatch):
    """A broken copy of ``staging_plan``: a slot goes to a new column one
    stage before the stage that last reads the old one has passed."""
    import inspect

    src = inspect.getsource(qc.staging_plan)
    assert src.count("busy[0][0] < start") == 1
    env = dict(vars(qc))
    exec(src.replace("busy[0][0] < start", "busy[0][0] < start + 2"), env)
    monkeypatch.setattr(qc, "staging_plan", env["staging_plan"])


_BROKEN = {
    # (edit of each part's text, (header, old, new) or None, plan edit)
    "next row moved": (lambda t: t.replace("+ QP_SHIFT + t]",
                                           "+ QP_SHIFT + 1 + t]"), None, None),
    "dotn adds": (None, ("quotient.cuh", "(uint64_t)(M31_P - c) * d",
                         "(uint64_t)c * d"), None),
    "first part left out": (None, ("quotient.cuh", "int p = 0; p < part",
                                   "int p = 1; p < part"), None),
    "halo one point short": (None, ("quotient.cuh",
                                    "#define QP_SPAN (QP_TILE + QP_SHIFT)",
                                    "#define QP_SPAN (QP_TILE + QP_SHIFT - 1)"),
                             None),
    "slot freed a stage early": (None, None, _slot_freed_a_stage_early),
}


@pytest.mark.parametrize("broken", sorted(_BROKEN))
def test_the_translation_runs_the_code_as_written(broken, monkeypatch):
    """The CPU check sees what the device code says: a broken copy of a
    part's text, of a header helper or of the staging plan gives other
    words than the plain version's."""
    edit, header, plan_edit = _BROKEN[broken]
    headers = _header_texts()
    if header:
        k = ("m31.cuh", "quotient.cuh").index(header[0])
        assert headers[k].count(header[1]) == 1
        headers = (*headers[:k], headers[k].replace(*header[1:]),
                   *headers[k + 1:])
    kernel = None
    if plan_edit:
        plan_edit(monkeypatch)
        kernel = qc.plan(OFF, LOG_BLOWUP)
        assert any(_plan_faults(p) for p in kernel.parts)
    inputs = _inputs(OFF, SEED)
    got = _generated(OFF, inputs, edit or (lambda t: t), headers, kernel)
    want = _plain(inputs)
    assert any(not torch.equal(g, w) for g, w in zip(got, want))


def test_the_translation_refuses_an_unknown_statement():
    with pytest.raises(AssertionError, match="untranslated statement"):
        _generated(OFF, _inputs(OFF, SEED),
                   lambda t: t.replace("qp_commit();", 'asm volatile("");', 1))


def _plan_faults(part):
    """The staging plan's faults, found by replaying it in time order: a
    copy lands in its slot at its issue time (2 s - 1, while stage s - 1
    computes); stage s reads at 2 s + 1.  A
    stage must find each column it reads in the slot the plan names, put
    there before it by a copy that nothing overwrote since."""
    staging = part.staging
    writes = sorted((2 * s - 1, slot, leaf)
                    for s, copies in enumerate(staging.copies)
                    for slot, leaf in copies)
    faults, held, k = [], {}, 0
    for s, stage in enumerate(part.stages):
        while k < len(writes) and writes[k][0] <= 2 * s + 1:
            held[writes[k][1]] = writes[k][2]
            k += 1
        if set(staging.slot_of[s]) != stage.leaves:
            faults.append((s, "columns"))
        for leaf, slot in staging.slot_of[s].items():
            if held.get(slot) != leaf:
                faults.append((s, leaf, slot))
    if staging.slots > qc.n_slots(1 << LOG_BLOWUP):
        faults.append(("slots", staging.slots))
    return faults


@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
def test_the_staging_plan_holds_every_read(name):
    """Every column a stage reads is in its slot before the stage, no slot
    is overwritten while a later stage still reads it, the plan fits the
    CTA's slots, and the global column reads a point (the copies and the
    1/Z rows) are fewer than the 4,504 of one launch per part with every
    part reading its columns itself (37 parts on the main path)."""
    kernel = _plan(FEATURE_SETS[name])
    for part in kernel.parts:
        assert _plan_faults(part) == []
        assert [s.lo for s in part.stages[1:]] == [s.hi for s in
                                                   part.stages[:-1]]
    assert sum(p.reads for p in kernel.parts) <= 4504
    assert len(kernel.parts) < 37


def test_the_halo_covers_the_next_row_reads():
    """A slot holds the tile's points and the next trace row's: word k of
    the copy for the tile at ``base`` is point (base + k) mod n, for every
    k a thread reads (t and t + QP_SHIFT), the last tile wrapping to point
    0; the header's ``qp_copy`` and ``qp_halo`` run through the copy
    model."""
    text = _small_tile(_plan(OFF).parts[0].text)
    _, _, kernel, defines = _part_fn(text, _header_texts())
    env = kernel.__globals__
    _define(env, _header_texts(), defines)
    tile, shift, span = env["QP_TILE"], env["QP_SHIFT"], env["QP_SPAN"]
    column = np.arange(N, dtype=np.int64) * 7 + 3
    for base in range(0, N, tile):
        copies = Copies()
        env["qp_cp4"], env["qp_commit"] = copies.cp4, copies.commit
        slot = Ptr(np.full(span + 1, POISON, dtype=np.int64))
        env["qp_copy"](slot, Ptr(column), base, N, np.arange(tile))
        env["qp_halo"](slot, Ptr(column), base, N, np.arange(tile))
        copies.commit()
        copies.wait(0)
        reads = np.concatenate([np.arange(tile), np.arange(tile) + shift])
        assert np.array_equal(slot.a[reads], column[(base + reads) % N])


def test_alpha_powers_are_the_plain_loops():
    """The wrapper's alpha powers (by doubling, vectorised) are
    ``_alpha_powers_np``'s words, word for word."""
    rng = np.random.default_rng(SEED)
    for n_terms in (1, 2, 3, 5, 721, 887):
        alpha = tuple(int(x) for x in rng.integers(0, P, 4))
        assert np.array_equal(qc.alpha_powers(alpha, n_terms),
                              cs._alpha_powers_np(alpha, n_terms))


@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
def test_recorded_terms_are_quotient_terms(name):
    """The recording holds ``quotient_terms``'s terms on ``VecAlg``: the
    same count (721 without ``range_lookup``, 887 with every argument and
    the program), the same divisor tags and widths, in order; the stages
    and parts cover them in order."""
    ext_r, ext_i, args, _ = _port(_inputs(FEATURE_SETS[name], SEED))
    _, terms = cs._vec_terms(ext_r, ext_i, LOG_BLOWUP, **args)
    rec = qc.record(FEATURE_SETS[name])
    assert [(t, len(c)) for t, c in rec.terms] == \
        [(t, len(c)) for t, c in terms]
    assert len(terms) == {"off": 721, "on": 884, "program": 887}[name]
    parts = [(p.lo, p.hi) for p in _plan(FEATURE_SETS[name]).parts]
    assert parts[0][0] == 0 and parts[-1][1] == len(terms)
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
    counts = qc.operation_counts(rec)
    nodes = [n for n in rec.alg.nodes if n[0] in qc._C_OPS]
    assert sum(counts[f] for f in qc._C_OPS.values()) == len(nodes)
    assert counts["qp_acc2"] + counts["qp_acc4"] <= len(terms)


def test_source_does_not_depend_on_the_challenges():
    """One text serves every proof: recording again gives the same text,
    and two challenge sets give two tables and two quotients, each equal
    to the plain version's."""
    kernel = _plan(BOUND)
    again = qc.record.__wrapped__(BOUND)
    slots = qc.n_slots(1 << LOG_BLOWUP)
    assert [qc.make_part(again, qc.cut_stages(again, lo, hi), slots,
                         LOG_BLOWUP).text
            for lo, hi in qc.cut_parts(again, slots)] == \
        [p.text for p in kernel.parts]
    tables = []
    for seed in (SEED, SEED + 1):
        inputs = _inputs(BOUND, seed)
        _equal(_generated(BOUND, inputs, kernel=kernel), _plain(inputs))
        ext_r, ext_i, args, alpha = _port(inputs)
        A, keys = cs._vec_alg(ext_r, ext_i, LOG_BLOWUP, **args)
        words = qc.record(BOUND).scalars.evaluate(qc.challenge_words(keys))
        tables.append(words)
    assert tables[0] != tables[1]


def test_scalar_program_computes_the_host_arithmetic():
    """The words the program gives are those the constraint code computes
    from concrete challenges: eta^2 and delta^5 as ``qm31_mul_scalar``
    makes them, and the entry point's 20-bit limbs; its compiled form
    gives ``evaluate``'s words."""
    rng = np.random.default_rng(SEED)
    eta, delta = (tuple(int(x) for x in rng.integers(0, P, 4))
                  for _ in range(2))
    prog = qc.ScalarProgram()
    s_eta, s_delta = ([prog.input() for _ in range(4)] for _ in range(2))
    e2 = qm31_mul_scalar(s_eta, s_eta)
    d5 = s_delta
    want5 = delta
    for _ in range(4):
        d5, want5 = qm31_mul_scalar(d5, s_delta), qm31_mul_scalar(want5, delta)
    vals = prog.evaluate([*eta, *delta])
    assert [vals[x.id] if isinstance(x, qc.Sym) else x for x in e2] == \
        list(qm31_mul_scalar(eta, eta))
    assert [vals[x.id] if isinstance(x, qc.Sym) else x for x in d5] == \
        list(want5)
    wanted = [x.id for x in (*e2, *d5) if isinstance(x, qc.Sym)]
    assert prog.compile(wanted)([*eta, *delta]) == [vals[k] for k in wanted]
    with pytest.raises(TypeError):
        bool(s_eta[0])
    keys = dict(lookup=None, aux=None, memory=None, io=None, crypto=None,
                program=((0,) * 4, (1, 2, 3, 4), (5 << 20) | 7))
    keys["lookup"] = (9, 9, 9, 9)
    assert qc.challenge_words(keys) == [9, 9, 9, 9, 1, 2, 3, 4, 7, 5]


def test_cache_key_follows_the_text():
    """A part's build is named by its text (with the headers and flags):
    another text, another name; equal stages, equal text and name, so the
    feature sets share the parts their terms begin with."""
    parts = {name: _plan(f).parts for name, f in FEATURE_SETS.items()}
    text = parts["program"][-1].text
    assert qc.part_key(text) == parts["program"][-1].key
    this_row = text.replace("+ QP_SHIFT + t]", "+ t]", 1)   # one read moved
    assert this_row != text
    assert qc.part_key(this_row) != qc.part_key(text)
    keys = {name: [p.key for p in ps] for name, ps in parts.items()}
    # Only a feature set's last parts differ.
    assert keys["off"][:-2] == keys["on"][:len(keys["off"]) - 2]
    assert keys["on"][:-1] == keys["program"][:-1]
    assert len({k for ks in keys.values() for k in ks}) <= \
        len(keys["program"]) + 3


@pytest.mark.parametrize("failure", ["nvcc missing", "nvcc fails"])
def test_a_failed_build_raises(monkeypatch, tmp_path, failure):
    """No fallback: without a working nvcc the kernels' build raises, and
    nothing is loaded."""
    def missing():
        raise RuntimeError("nvcc not found (test)")

    monkeypatch.setattr(qc, "BUILD", tmp_path)
    monkeypatch.setattr(qc, "_PREPARED", {})
    monkeypatch.setattr(_kernels, "_nvcc", missing if failure == "nvcc missing"
                        else lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc"):
        qc.prepare((OFF, LOG_BLOWUP))
    assert qc._PREPARED == {}
    assert not list(tmp_path.glob("*.so"))
