"""The generated quotient kernels' source against the JAX package,
tolerance 0.

The CUDA kernels build only on a machine with a GPU (``chip_smoke.py``
holds them against the plain version there).  Here the generated text and
the device helpers it calls (``csrc/m31.cuh``, ``csrc/quotient.cuh``) are
translated statement by statement into Python and run over the same table
of column addresses, challenge words and alpha powers that a launch
reads; a statement the translation does not know fails.  The result must
equal the port's ``VecAlg`` quotient and the reference's
``quotient_evals`` (eager on the CPU, as the reference's tests run it)
word for word, and broken copies of the text or a helper must not.
Inputs are random words from a numpy seed on a 32-point domain (log_n =
3, log_blowup = 2).
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
# run on numpy int64 words, every point at once.  A statement the
# translation does not know fails the test.
# ----------------------------------------------------------------------------


class Ptr:
    """A device pointer: a flat int64 array and an offset in words."""

    def __init__(self, a, at=0):
        self.a, self.at = a.reshape(-1), at

    def __add__(self, k):
        return Ptr(self.a, self.at + k)

    def __getitem__(self, idx):
        return self.a[self.at + idx]

    def __setitem__(self, idx, v):
        self.a[self.at + idx] = v


class Qacc:
    def __init__(self):
        self.a = self.b = (0, 0)


def _u32(x):
    return x & 0xFFFFFFFF


def _sel(c, x, y):
    return np.where(c, x, y) if isinstance(c, np.ndarray) else (x if c else y)


_CAST = re.compile(r"\((uint32_t|uint64_t)\)")
_DECL = re.compile(r"(?:const )?(uint32_t|uint64_t|long long|cm31|qacc) "
                   r"(\w+)(\[\d+\])? = (.*);")


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
    while m := _CAST.search(e):
        end = _operand_end(e, m.end())
        wrap = "_u32" if m[1] == "uint32_t" else ""
        e = f"{e[:m.start()]}{wrap}({e[m.end():end]}){e[end:]}"
    e = e.replace("cm31{", "(").replace("{", "(").replace("}", ")")
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
    out, depth, types = [], 1, {}

    def typed(t, e):
        return f"_u32({e})" if t == "uint32_t" else e

    for st in _split_statements(body):
        ind = "    " * depth
        if st == "#pragma unroll" or re.fullmatch(r"\(void\)\w+;", st):
            continue
        if st == "}":
            depth -= 1
        elif m := re.fullmatch(r"for \(int (\w+) = (\d+); \1 < (\d+); "
                               r"\+\+\1\) \{", st):
            out.append(f"{ind}for {m[1]} in range({m[2]}, {m[3]}):")
            depth += 1
        elif m := re.fullmatch(r"return (.*);", st):
            out.append(f"{ind}return {typed(returns, _expr(m[1]))}")
        elif m := _DECL.fullmatch(st):
            types[m[2]] = None if m[3] else m[1]
            rhs = "Qacc()" if (m[1], m[4]) == ("qacc", "{}") else _expr(m[4])
            out.append(f"{ind}{m[2]} = {typed(types[m[2]], rhs)}")
        elif m := re.fullmatch(r"([\w.\[\]]+) = (.*);", st):
            out.append(f"{ind}{_expr(m[1])} = "
                       f"{typed(types.get(m[1]), _expr(m[2]))}")
        elif re.fullmatch(r"\w+\(.*\);", st):
            out.append(ind + _expr(st[:-1]))
        else:
            raise AssertionError(f"untranslated statement: {st!r}")
    return out


def _header_texts():
    return tuple((_kernels.CSRC / f).read_text()
                 for f in ("m31.cuh", "quotient.cuh"))


@functools.lru_cache(maxsize=None)
def _helpers(headers):
    """Every ``__device__`` function and ``#define`` of the headers'
    texts, translated."""
    env = {"_u32": _u32, "_sel": _sel, "Qacc": Qacc, "np": np}
    for text in headers:
        for m in re.finditer(r"^#define (\w+) (\S+)$", text, re.M):
            env[m[1]] = eval(_expr(m[2]))
        found = list(re.finditer(
            r"^(?:template <int NW>\n)?__device__ __forceinline__ (\w+) "
            r"(\w+)\(([^)]*)\) \{\n(.*?)^\}$", text, re.M | re.S))
        assert len(found) == text.count("__device__")
        for m in found:
            returns, name, params, body = m.groups()
            args = [re.findall(r"\w+", p)[-1] for p in params.split(",")]
            exec("\n".join([f"def {name}({', '.join(args)}):",
                            *_statements(body, returns)]), env)
    return env


_PART = re.compile(
    r"(?:// .*\n)+#include \"quotient\.cuh\"\n\n"
    r"typedef qp_table<(\d+)> table_t;\n\n"
    r"extern \"C\" __global__ void __launch_bounds__\((\d+), \d+\)\n"
    r"quotient_part_kernel\(const __grid_constant__ table_t tab,\n"
    r" +const int64_t\* __restrict__ dinv,\n"
    r" +int64_t\* __restrict__ out, long long n,\n"
    r" +long long shift, int accumulate\) \{\n"
    r"    const long long i = \(long long\)blockIdx\.x \* blockDim\.x "
    r"\+ threadIdx\.x;\n"
    r"    if \(i >= n\) return;\n"
    r"(.*?)\n\}\n\n"
    r"extern \"C\" int quotient_part\(const int64_t\* table, "
    r"const int64_t\* dinv, int64_t\* out,\n"
    r" +long long n, long long shift, int accumulate,\n"
    r" +cudaStream_t stream\) \{\n"
    r"    table_t tab;\n"
    r"    memcpy\(tab\.w, table, sizeof tab\.w\);\n"
    r"    quotient_part_kernel<<<\(unsigned\)\(\(n \+ (\d+)\) / (\d+)\), "
    r"(\d+), 0, stream>>>\(\n"
    r"        tab, dinv, out, n, shift, accumulate\);\n"
    r"    return \(int\)cudaGetLastError\(\);\n\}\n", re.S)


@functools.lru_cache(maxsize=None)
def _part_fn(text, headers):
    """A part's kernel as a Python function of (tab, dinv, out, n, shift,
    accumulate) over every point, and its table's size in words."""
    m = _PART.fullmatch(text)
    assert m, "not the layout of a quotient part"
    words, threads = int(m[1]), int(m[2])
    assert int(m[4]) + 1 == int(m[5]) == int(m[6]) == threads
    env = dict(_helpers(headers))
    exec("\n".join(["def kernel(tab, dinv, out, n, shift, accumulate):",
                    "    i = np.arange(n)",
                    *_statements(m[3], "void")]), env)
    return words, env["kernel"]


def _generated(features, inputs, edit=lambda text: text,
               headers=None):
    """The quotient by the generated parts' text, as a launch computes it:
    the table a launch reads, each part run in order into an output that
    starts as garbage (``torch.empty``).  ``edit`` changes each part's
    text and ``headers`` the headers' before they are run."""
    ext_r, ext_i, args, alpha = _port(inputs)
    kernel = qc.plan(features)
    A, keys = cs._vec_alg(ext_r, ext_i, LOG_BLOWUP, **args)
    tab, offsets = kernel.table(A, keys, alpha)
    column = {}
    for accessor, arg, comp in kernel.rec.alg.leaves:
        t = getattr(A, accessor)(*arg)[comp]
        column[t.data_ptr()] = t.numpy()
    dinv = qc._dinv_rows(LOG_N, LOG_BLOWUP, _coset_shift(),
                         torch.device("cpu")).numpy()
    out = np.full((4, N), 12345, dtype=np.int64)
    ends = [*offsets[1:], len(tab)]
    for k, (part, off) in enumerate(zip(kernel.parts, offsets)):
        words, fn = _part_fn(edit(part.text), headers or _header_texts())
        assert off + words == ends[k]
        w = [Ptr(column[int(x)]) if int(x) in column else int(x)
             for x in tab[off:off + words]]
        fn(types.SimpleNamespace(w=w), Ptr(dinv), Ptr(out), N,
           1 << LOG_BLOWUP, int(k > 0))
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


_BROKEN = {
    # (edit of each part's text, (header, old, new) or None)
    "next row moved": (lambda t: t.replace("(i + shift) & (n - 1)",
                                           "(i + shift + 1) & (n - 1)"), None),
    "dotn adds": (None, ("quotient.cuh", "(uint64_t)(M31_P - c) * d",
                         "(uint64_t)c * d")),
    "first part adds": (None, ("quotient.cuh", "accumulate ? m31_add(",
                               "1 ? m31_add(")),
}


@pytest.mark.parametrize("broken", sorted(_BROKEN))
def test_the_translation_runs_the_code_as_written(broken):
    """The CPU check sees what the device code says: a broken copy of a
    part's text or of a header helper gives other words than the plain
    version's."""
    edit, header = _BROKEN[broken]
    headers = _header_texts()
    if header:
        k = ("m31.cuh", "quotient.cuh").index(header[0])
        assert headers[k].count(header[1]) == 1
        headers = (*headers[:k], headers[k].replace(*header[1:]),
                   *headers[k + 1:])
    inputs = _inputs(OFF, SEED)
    got = _generated(OFF, inputs, edit or (lambda t: t), headers)
    want = _plain(inputs)
    assert any(not torch.equal(g, w) for g, w in zip(got, want))


def test_the_translation_refuses_an_unknown_statement():
    with pytest.raises(AssertionError, match="untranslated statement"):
        _generated(OFF, _inputs(OFF, SEED),
                   lambda t: t.replace("(void)shift;", 'asm volatile("");'))


@pytest.mark.parametrize("name", sorted(FEATURE_SETS))
def test_recorded_terms_are_quotient_terms(name):
    """The recording holds ``quotient_terms``'s terms on ``VecAlg``: the
    same count (721 without ``range_lookup``, 887 with every argument and
    the program), the same divisor tags and widths, in order."""
    ext_r, ext_i, args, _ = _port(_inputs(FEATURE_SETS[name], SEED))
    _, terms = cs._vec_terms(ext_r, ext_i, LOG_BLOWUP, **args)
    rec = qc.record(FEATURE_SETS[name])
    assert [(t, len(c)) for t, c in rec.terms] == \
        [(t, len(c)) for t, c in terms]
    assert len(terms) == {"off": 721, "on": 884, "program": 887}[name]
    parts = qc.split(rec)
    assert parts[0][0] == 0 and parts[-1][1] == len(terms)
    assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))


def test_source_does_not_depend_on_the_challenges():
    """One text serves every proof: recording again gives the same text,
    and two challenge sets give two tables and two quotients, each equal
    to the plain version's."""
    texts = [p.text for p in qc.plan(BOUND).parts]
    again = qc.record.__wrapped__(BOUND)
    assert [qc.part_source(again, lo, hi).text
            for lo, hi in qc.split(again)] == texts
    tables = []
    for seed in (SEED, SEED + 1):
        inputs = _inputs(BOUND, seed)
        _equal(_generated(BOUND, inputs), _plain(inputs))
        ext_r, ext_i, args, alpha = _port(inputs)
        A, keys = cs._vec_alg(ext_r, ext_i, LOG_BLOWUP, **args)
        words = qc.record(BOUND).scalars.evaluate(qc.challenge_words(keys))
        tables.append(words)
    assert tables[0] != tables[1]


def test_scalar_program_computes_the_host_arithmetic():
    """The words the program gives are those the constraint code computes
    from concrete challenges: eta^2 and delta^5 as ``qm31_mul_scalar``
    makes them, and the entry point's 20-bit limbs."""
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
    with pytest.raises(TypeError):
        bool(s_eta[0])
    keys = dict(lookup=None, aux=None, memory=None, io=None, crypto=None,
                program=((0,) * 4, (1, 2, 3, 4), (5 << 20) | 7))
    keys["lookup"] = (9, 9, 9, 9)
    assert qc.challenge_words(keys) == [9, 9, 9, 9, 1, 2, 3, 4, 7, 5]


def test_cache_key_follows_the_text():
    """A part's build is named by its text (with the headers and flags):
    another text, another name; equal terms, equal text and name, so the
    feature sets share the parts their terms begin with."""
    parts = {name: qc.plan(f).parts for name, f in FEATURE_SETS.items()}
    text = parts["program"][0].text
    assert qc.part_key(text) == parts["program"][0].key
    next_row = text.replace(", i);", ", j);", 1)      # one read moved
    assert next_row != text
    assert qc.part_key(next_row) != qc.part_key(text)
    keys = {name: [p.key for p in ps] for name, ps in parts.items()}
    assert keys["off"][:-1] == keys["on"][:len(keys["off"]) - 1]
    assert keys["on"][:-1] == keys["program"][:-1]
    assert len({k for ks in keys.values() for k in ks}) == \
        len(keys["program"]) + 2


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
        qc.prepare(OFF)
    assert qc._PREPARED == {}
    assert not list(tmp_path.glob("*.so"))
