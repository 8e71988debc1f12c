"""What the port's kernel wrappers tell their kernels, checked on the CPU.

The CUDA kernels run only on a GPU, but everything around them is Python
that runs anywhere: the broadcast-collapsed (shape, strides, immediates)
descriptor of K1's two entry points, and the edges that ``cm31_ntt`` fuses
(short input, absent ``im``, pre/post tables, scale), whose plain version
must equal the composition of pad and CM31 products the public functions
used to spell out.  Everything is exact: the values are field words.
"""

import numpy as np
import pytest
import torch

from zkir_tpu_torch.ops import field_ops as f
from zkir_tpu_torch.ops import ntt

P = (1 << 31) - 1
SHIFT = ntt._find_generator()


def words(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, P, shape, dtype=np.int64))


def _base():
    return words(1, (6, 8, 10))


# name -> operands (tensors or Python ints); the broadcast result is what
# the kernel must see through (pointer, strides).
LAYOUTS = {
    "equal contiguous": lambda b: (b, b + 1),
    "row vector, stride 0 outside": lambda b: (b, b[0, 0]),
    "column, stride 0 inside": lambda b: (b[0], b[0, :, :1]),
    "powers column [C,1] x [C,N]": lambda b: (b[0, :, :1], b[0]),
    "transposed view": lambda b: (b[0, :, :8].T, b[1, :, :8]),
    "strided slice": lambda b: (b[:, :, ::2], b[:, :, 1::2]),
    "odd storage offset": lambda b: (b[0, 0, 1:], b[0, 1, 1:]),
    "immediate second": lambda b: (b, 12345),
    "immediate first": lambda b: (P + 7, b[:, ::2]),
    "scalar tensor": lambda b: (b, b[1, 2, 3]),
    "middle axis broadcast": lambda b: (b, b[:, :1, :]),
    "rank 4 after collapsing": lambda b: (
        words(2, (4, 6, 8, 10))[:, :5, ::2, ::2], b[0, :4, :5]),
    "four operands": lambda b: (b[0], b[1], b[0, :, :1], 3),
}


@pytest.mark.parametrize("name", LAYOUTS)
def test_descriptor_addresses_the_broadcast_operands(name):
    """Gathering each operand through its (pointer, strides) over the
    collapsed shape gives ``torch.broadcast_tensors`` of the operands."""
    operands = LAYOUTS[name](_base())
    shape, strides, imms, vec, out_shape = f.binary_descriptor(operands)
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    assert tuple(out_shape) == tuple(
        torch.broadcast_shapes(*(x.shape for x in tensors)))
    assert len(shape) == f.MAX_RANK and int(np.prod(shape)) == \
        int(np.prod(out_shape))
    for x, st, imm in zip(operands, strides, imms):
        if not isinstance(x, torch.Tensor):
            assert imm == x % P and tuple(st) == (0, 0, 0, 0)
            continue
        assert imm == 0
        want = x.expand(out_shape).reshape(-1)
        # A pure-Python walk of the kernel's index arithmetic over the
        # tensor's storage, from the tensor's own offset.
        flat = torch.as_strided(x, (x.untyped_storage().nbytes() // 8
                                    - x.storage_offset(),), (1,))
        got = [int(flat[i0 * st[0] + i1 * st[1] + i2 * st[2] + i3 * st[3]])
               for i0 in range(shape[0]) for i1 in range(shape[1])
               for i2 in range(shape[2]) for i3 in range(shape[3])]
        assert got == want.tolist()
        if vec == 2 and st[3] != 0:    # what a 16-byte load needs
            assert st[3] == 1 and x.data_ptr() % 16 == 0
            assert all(s % 2 == 0 for s in st[:3])
    flat_layout = shape[:3] == (1, 1, 1)
    assert vec in (1, 2) and (vec == 1 or flat_layout or shape[3] % 2 == 0)


def test_descriptor_vector_width():
    a = words(3, (4096,))
    assert f.binary_descriptor((a, a))[3] == 2
    assert f.binary_descriptor((a[:-1], a[:-1]))[3] == 2   # odd, rank 1
    assert f.binary_descriptor((a[1:], a[:-1]))[3] == 1    # 8-byte offset
    assert f.binary_descriptor((a[::2], a[::2]))[3] == 1   # inner stride 2
    m = a.reshape(64, 64)
    assert f.binary_descriptor((m, m[:, :1]))[3] == 2      # stride 0 inside
    assert f.binary_descriptor((m[:, :63], m[:, :63]))[3] == 1


def test_descriptor_refuses_rank_5_and_mixed_operands():
    t5 = words(4, (4, 4, 4, 4, 4))[::2, ::2, ::2, ::2, ::2]
    with pytest.raises(ValueError, match="rank 5"):
        f.binary_descriptor((t5, t5.transpose(0, 1)))
    with pytest.raises(TypeError):
        f.binary_descriptor((1, 2))
    with pytest.raises(TypeError):
        f.binary_descriptor((t5, t5.to(torch.int32)))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_cm31_binary_with_constant_pairs(op):
    """On the CPU ``cm31_binary`` is the plain composition, also with a
    constant pair on either side (what the GPU takes as immediates)."""
    a = (words(5, (7, 33)), words(6, (7, 33)))
    c = (P - 1, 12345)
    full = tuple(torch.full_like(a[0], v) for v in c)
    plain = {"add": f.cm31_add_plain, "sub": f.cm31_sub_plain,
             "mul": f.cm31_mul_plain}[op]
    for got, want in ((f.cm31_binary(a, c, op), plain(a, full)),
                      (f.cm31_binary(c, a, op), plain(full, a))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    s = ntt.cm31_scale(a, 77)
    assert torch.equal(s[0], f.mul_plain(a[0], 77))
    assert torch.equal(s[1], f.mul_plain(a[1], 77))


def _composition(re, im, log_n, inverse, pre, post, scale):
    """The edges spelled out: zero ``im``, shift powers, pad, transform,
    shift powers, scale - each its own pass over the array."""
    n = 1 << log_n
    if im is None:
        im = torch.zeros_like(re)
    pad = (0, n - re.shape[-1])
    re = torch.nn.functional.pad(re, pad)
    im = torch.nn.functional.pad(im, pad)
    if pre is not None:
        re, im = f.cm31_mul_plain(
            (re, im), ntt._on_device(("shift", (pre, log_n)), re.device))
    re, im = ntt._ntt_core(re, im, log_n, inverse)
    if post is not None:
        re, im = f.cm31_mul_plain(
            (re, im), ntt._on_device(("shift", (post, log_n)), re.device))
    return f.mul_plain(re, scale), f.mul_plain(im, scale)


@pytest.mark.parametrize("log_n", [3, 6])
@pytest.mark.parametrize("edges", [
    dict(), dict(short=True), dict(real=True), dict(pre=SHIFT),
    dict(post=ntt.cm31_inv_scalar(SHIFT), scale=5, inverse=True),
    dict(short=True, real=True, pre=SHIFT, scale=3),
], ids=["none", "short", "real", "pre", "post+scale", "short real pre"])
def test_ntt_plain_edges_equal_the_composition(log_n, edges):
    n = 1 << log_n
    in_len = n // 4 if edges.get("short") else n
    re = words(10 + log_n, (3, in_len))
    im = None if edges.get("real") else words(20 + log_n, (3, in_len))
    args = (log_n, edges.get("inverse", False), edges.get("pre"),
            edges.get("post"), edges.get("scale", 1))
    got = ntt.cm31_ntt(re, im, *args)
    want = _composition(re, im, *args)
    assert got[0].shape == (3, n)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_public_transforms_accept_real_and_short_input():
    re = words(30, (2, 16))
    zeros = torch.zeros_like(re)
    for g, w in zip(ntt.lde(re, None, 4, 2, shift=SHIFT),
                    ntt.lde(re, zeros, 4, 2, shift=SHIFT)):
        assert torch.equal(g, w)
    padded = torch.nn.functional.pad(re, (0, 48))
    for g, w in zip(ntt.coset_ntt(re, re, 6, shift=SHIFT),
                    ntt.coset_ntt(padded, padded, 6, shift=SHIFT)):
        assert torch.equal(g, w)


def test_ntt_rows_layout_is_checked_not_copied():
    x = words(31, (5, 32))
    assert ntt._rows(x, "re") == 32
    assert ntt._rows(x[:, :8], "re") == 32          # a slice of each row
    assert ntt._rows(x[2, 8:24], "re") == 16        # a 1-D slice
    assert ntt._rows(x.reshape(5, 2, 16), "re") == 16
    with pytest.raises(ValueError, match="unit stride"):
        ntt._rows(x.T, "re")
    with pytest.raises(ValueError, match="unit stride"):
        ntt._rows(x[:, ::2], "re")


# ============================================================================
# K3's descriptor and state checks; the C entry points behind the wrappers
# ============================================================================


def _interp():
    from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter
    from zkir_tpu_torch.spec import Instruction, Op, Program

    program = Program.from_instructions([
        Instruction(Op.LW, rd=1, rs1=0, imm=0x1000), Instruction(Op.EBREAK)])
    return TpuInterpreter(program, InterpConfig(
        lanes=3, chunk=8, low_bytes=1 << 13, stack_bytes=1 << 12,
        collect_trace=True), device="cpu")


def _enum_slots():
    """The slot names of ``csrc/interp.cu``'s descriptor enum, in order."""
    import re

    from zkir_tpu_torch import _kernels

    src = (_kernels.CSRC / "interp.cu").read_text()
    body = re.search(r"enum \{(.*?)\};", src, re.S).group(1)
    return [name.strip() for name in body.split(",") if name.strip()]


def test_interp_descriptor_fills_the_kernels_slots():
    from zkir_tpu_torch.interp import columnar as C

    interp = _interp()
    state = interp.init_state([[1], [2, 3], []])
    slots = _enum_slots()
    assert slots[-1] == "D_COUNT"
    trace = {name: torch.zeros((8, 3, *tail), dtype=dt)
             for name, (dt, tail) in C._TRACE_COLUMNS.items()}
    desc = list(C._descriptor(interp.code, interp.n_words, state,
                              interp.config, trace))
    assert len(desc) == len(slots) - 1
    at = dict(zip(slots, desc))
    assert at["D_CODE"] == interp.code.data_ptr()
    assert (at["D_N_WORDS"], at["D_LANES"], at["D_CHUNK"]) == (2, 3, 8)
    assert at["D_REGS"] == state.regs.data_ptr()
    assert at["D_MEM"] == state.mem.data_ptr()
    assert at["D_MEM_STRIDE"] == (1 << 13) + (1 << 12)
    assert (at["D_LOW_BYTES"], at["D_STACK_BYTES"]) == (1 << 13, 1 << 12)
    assert (at["D_HAS_MEM"], at["D_COLLECT"]) == (1, 1)
    assert (at["D_MAX_INPUTS"], at["D_MAX_OUTPUTS"]) == (64, 64)
    assert at["D_OUT_POS"] == state.out_pos.data_ptr()
    # The trace slots follow the order of the column table, T_<NAME>, the
    # deferred model's column last.
    assert [s for s in slots if s.startswith("T_")] == [
        f"T_{name.upper()}" for name in C.trace_columns(deferred=True)]
    assert at["T_RC_VALUE"] == trace["rc_value"].data_ptr()
    without = list(C._descriptor(interp.code, interp.n_words, state,
                                 interp.config, None))
    assert len(without) == len(desc)
    assert without[slots.index("D_COLLECT"):slots.index("T_RC_VALUE") + 1] \
        == [0] * (1 + len(C._TRACE_COLUMNS))
    # One chunk of every lane from chunk 0, a warp per lane for 3 lanes.
    assert (at["D_DECODED"], at["D_LANE_CHUNK"]) == (0, 0)
    assert (at["D_SEG_LO"], at["D_SEG_HI"], at["D_WARP"]) == (0, 1, 1)
    lane_chunk = torch.zeros(3, dtype=torch.int32)
    run = dict(zip(slots, C._descriptor(
        interp.code, interp.n_words, state, interp.config, trace,
        decoded=interp.decoded, lane_chunk=lane_chunk, seg=(4, 12),
        warp=False)))
    assert run["D_DECODED"] == interp.decoded.data_ptr()
    assert run["D_LANE_CHUNK"] == lane_chunk.data_ptr()
    assert (run["D_SEG_LO"], run["D_SEG_HI"], run["D_WARP"]) == (4, 12, 0)


def test_interp_state_is_checked_not_converted():
    from zkir_tpu_torch.interp import columnar as C

    interp = _interp()
    state = interp.init_state([[1], [2, 3], []])
    C._check_state(interp.code, state, interp.config)
    with pytest.raises(TypeError, match="state.regs must be torch.int64"):
        C._check_state(interp.code, state._replace(
            regs=state.regs.to(torch.int32)), interp.config)
    with pytest.raises(ValueError, match="state.mem must be"):
        C._check_state(interp.code, state._replace(
            mem=state.mem[:, :-1]), interp.config)
    with pytest.raises(ValueError, match="not contiguous"):
        C._check_state(interp.code, state._replace(
            regs=torch.zeros((16, 3), dtype=torch.int64).T), interp.config)
    with pytest.raises(ValueError, match="code must be"):
        C._check_state(interp.code.to(torch.int64), state, interp.config)
    with pytest.raises(ValueError, match="outside the code buffer"):
        C.interp_chunk(interp.code, 3, state, interp.config)


def test_every_entry_point_has_its_c_function():
    import re

    from zkir_tpu_torch import _kernels
    # Adds one count more, for the generated quotient kernels.
    from zkir_tpu_torch.prover import quotient_codegen  # noqa: F401

    src = "".join(f.read_text() for f in sorted(_kernels.CSRC.glob("*.cu")))
    defined = set(re.findall(r'extern "C" int (\w+)\(', src))
    assert set(_kernels._SIGNATURES) <= defined
    assert set(_kernels.launches) == {*_kernels._SIGNATURES, "quotient_part"}
    assert len(_kernels._SIGNATURES) == 17


def _crypto_calls():
    """Each hash kernel's wrapper on CPU tensors, and its plain version
    on the same inputs."""
    from zkir_tpu_torch.ops import blake3, keccak, sha256
    from zkir_tpu_torch.ops import poseidon2 as p2

    rng = np.random.default_rng(9)
    data = torch.from_numpy(rng.integers(0, 256, 2000, dtype=np.uint8))
    offs, lens = np.array([0, 7, 1500]), np.array([300, 0, 500])
    words = torch.from_numpy(rng.integers(0, 1 << 32, (3, 16)))
    small = [torch.from_numpy(rng.integers(0, 1 << 32, 3)) for _ in range(4)]
    return {
        "sha256_blocks": (lambda: sha256.sha256_rows(data, offs, lens),
                          lambda: sha256.sha256_rows_plain(
                              data, offs, lens)[0]),
        "keccak_absorb": (lambda: keccak.keccak_rows(data, offs, lens),
                          lambda: keccak.keccak_rows_plain(data, offs, lens)),
        "b3_rows": (lambda: blake3.blake3_rows(data, offs, lens),
                    lambda: blake3.blake3_rows_plain(data, offs, lens)),
        "p2_sponge_bytes": (lambda: p2.sponge_hash_rows(data, offs, lens),
                            lambda: p2.sponge_hash_rows_plain(data, offs,
                                                              lens)),
        "b3_compress": (lambda: blake3.b3_compress_batch(None, words,
                                                         *small),
                        lambda: blake3.b3_compress_plain(None, words,
                                                         *small)),
    }


@pytest.mark.parametrize("name", ["sha256_blocks", "keccak_absorb",
                                  "b3_rows", "b3_compress",
                                  "p2_sponge_bytes"])
def test_crypto_entry_point_takes_its_plain_version_on_the_cpu(name):
    """A hash kernel's wrapper, given CPU tensors, returns its plain
    version's words and counts no launch; the count exists for the card."""
    from zkir_tpu_torch import _kernels

    wrapper, plain = _crypto_calls()[name]
    before = _kernels.launches[name]
    assert torch.equal(wrapper(), plain())
    assert _kernels.launches[name] == before


def test_sponge_hash_bytes_batch_equals_the_scalar_sponge():
    from zkir_tpu_torch.ops import poseidon2 as p2
    from zkir_tpu_torch.ops.poseidon2_ref import poseidon2_sponge_hash_bytes

    rng = np.random.default_rng(5)
    messages = [bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
                for n in (0, 1, 3, 4, 31, 32, 33, 64, 100)]
    got = p2.sponge_hash_bytes_batch(messages, "cpu")
    assert got.tolist() == [poseidon2_sponge_hash_bytes(m) for m in messages]


@pytest.mark.parametrize("name", ["qm31_inv_scaled", "m31_exclusive_scan"])
def test_partial_sum_entry_point_takes_its_plain_version_on_the_cpu(name):
    """The LogUp partial sums' wrappers (``qm31_inv_scaled`` with a row of
    y for all rows and a subtracted second term; ``exclusive_cumsum4``),
    given CPU tensors, return their plain versions' words and count no
    launch."""
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.ops import qm31

    x = tuple(words(60 + k, (3, 40)) for k in range(4))
    y = tuple(words(70 + k, (1, 40)) for k in range(4))
    a, b = words(80, (3, 40)), words(81, (3, 40))
    before = _kernels.launches[name]
    if name == "qm31_inv_scaled":
        got = qm31.qm31_inv_scaled(x, a, y, b, subtract=True)
        want = qm31.qm31_inv_scaled_plain(x, a, y, b, subtract=True)
    else:
        got = qm31.exclusive_cumsum4(x)
        want = qm31.exclusive_cumsum4_plain(x)
    assert _kernels.launches[name] == before
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_partial_sum_inversion_descriptor(monkeypatch):
    """What ``qm31_inv_scaled`` tells its kernel for the lookup channels'
    layout (x [3, n] with constant coordinates 1-3, a table row y [1, n]
    for all rows, subtracted): rows, length, rows a thread, flags, each
    operand's row stride (0: one row for all, or an immediate) and
    immediates; the launch is faked (no card)."""
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.ops import qm31

    calls = []
    monkeypatch.setattr(_kernels, "launch",
                        lambda name, *args: calls.append((name, args)))
    w, t, m = words(90, (3, 40)), words(91, (1, 40)), words(92, (3, 40))
    out = qm31._inv_scaled_cuda((w, 5, 6, P + 7), 1, (t, 5, 6, 7), m, True)
    assert [tuple(c.shape) for c in out] == [(3, 40)] * 4
    (name, args), = calls
    assert name == "qm31_inv_scaled"
    ptrs, desc = args[:10], list(args[11])
    assert ptrs[0] == w.data_ptr() and ptrs[4] == t.data_ptr()
    assert ptrs[9] == m.data_ptr()
    assert ptrs[1:4] == ptrs[5:8] == (None,) * 3 and ptrs[8] is None
    assert desc[:4] == [3, 40, 3, 1 | 2]
    assert desc[4:14] == [40, 0, 0, 0, 0, 0, 0, 0, 0, 40]
    assert desc[14:24] == [0, 5, 6, 7, 0, 5, 6, 7, 1, 0]
    # One row (the memory term's layout, both sides): folded into rows
    # that share a thread's exponent chain, runs of at most 4.
    for n, rows in ((64, 4), (36, 4), (6, 2), (7, 1)):
        v, r = words(94, (n,)), words(95, (n,))
        out = qm31._inv_scaled_cuda((v, v, v, v), v, (r, r, r, r), r, True)
        assert [tuple(c.shape) for c in out] == [(n,)] * 4
        (_, args), = calls[1:]
        del calls[1:]
        desc = list(args[11])
        assert desc[:4] == [rows, n // rows, rows, 1 | 2]
        assert desc[4:14] == [n // rows if rows > 1 else 0] * 10


def test_partial_sum_scan_arguments(monkeypatch):
    """What ``exclusive_cumsum4`` tells its kernel: the four coordinates'
    rows, zero words for its tiles (one a tile of 4,096 words of each
    row, and the counter), the row count and length, and whether two words
    a load fit (an even length); the launch is faked (no card)."""
    from zkir_tpu_torch import _kernels
    from zkir_tpu_torch.ops import qm31

    calls = []
    monkeypatch.setattr(_kernels, "launch",
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(qm31, "_on_cuda", lambda values: True)
    zeros = []
    real_zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: zeros.append(
        real_zeros(*a, **k)) or zeros[-1])
    for shape, vec, tiles in (((5, 64), 1, 5), ((7,), 0, 1),
                              ((2, 4097), 0, 4)):
        term = tuple(words(93 + k, shape) for k in range(4))
        out = qm31.exclusive_cumsum4(term)
        name, args = calls.pop()
        status = zeros.pop()
        assert name == "m31_exclusive_scan"
        assert args[:4] == tuple(c.data_ptr() for c in term)
        assert args[5] == status.data_ptr()
        assert status.shape == (4 * tiles + 1,) and not status.any()
        assert args[6:] == (shape[0] if len(shape) == 2 else 1, shape[-1],
                            vec)
        assert [tuple(c.shape) for c in out] == [shape] * 4
