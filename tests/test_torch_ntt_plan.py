"""The CUDA NTT's pass plan, run on the CPU: no JAX, tolerance 0.

``csrc/ntt.cu`` runs the passes that ``ops/ntt.py::ntt_plan`` chooses.
The kernel runs only on a card, so this file translates it into torch:
each pass's asynchronous tile loads (the bit reversal done in the copy's
addresses, the zero fill beyond ``in_len``, a real input's missing
imaginary words left as they were), the thread groups of each register
step and their shared-memory indices, the factor tables of the
pre-multiplication (their records indexed as the kernel indexes them)
and the radix-8 constants, the skipped stages of a
short input (the LDE's four cosets from one tile of coefficients), the
stores with ``post`` and ``scale``, and the device's lazy field words
(in [0, p]) with their 32-bit wraparound.  Each emulated transform is
held to ``ntt_plain``.  Shared memory starts poisoned, so a word the
plan reads before any copy or step wrote it shows.
"""

import numpy as np
import pytest
import torch

from zkir_tpu_torch.ops import ntt

P = (1 << 31) - 1
M32 = (1 << 32) - 1
PAD = 1                  # csrc/ntt.cu: NTT_PAD
POISON = 0xDEADBEEF
SHIFT = ntt._find_generator()
FLAG_IN_PAIRS, FLAG_OUT_PAIRS = 1, 2


# The device helpers (csrc/ntt.cu), word for word on uint32 values.
def lz_add(a, b):
    s = (a + b) & M32
    return torch.minimum(s, (s - P) & M32)


def lz_sub(a, b):
    d = (a - b) & M32
    return torch.minimum(d, (d + P) & M32)


def lz_fold(x):                      # x <= 2 p^2 < 2^63
    s = (x & P) + ((x >> 31) & P) + (x >> 62)
    return torch.minimum(s, (s - P) & M32)


def lz_cmul(a, b):
    (ar, ai), (br, bi) = a, b
    assert int(torch.stack([ar, ai]).max()) <= P
    return (lz_fold(ar * br + (P - ai) * bi), lz_fold(ar * bi + ai * br))


def canon(x):
    return torch.minimum(x, (x - P) & M32)


def shared_row(r):
    """A later pass's shared row of tile row r (bank spread)."""
    return r ^ ((r >> 3) & 3)


def brev(x, bits):
    out = torch.zeros_like(x)
    for b in range(bits):
        out |= ((x >> b) & 1) << (bits - 1 - b)
    return out


class Emulator:
    """One ``cm31_ntt`` launch as the kernel runs it."""

    def __init__(self, log_n, inverse, pre=None, post=None, scale=1,
                 tile_log=ntt.TILE_LOG, pass_log=ntt.PASS_LOG):
        self.L, self.n, self.inverse = log_n, 1 << log_n, inverse
        self.w4_is_i, w8, w8_3 = ntt.dft_constants(log_n, inverse)
        self.w8 = tuple(torch.tensor(c) for c in w8)
        self.w8_3 = tuple(torch.tensor(c) for c in w8_3)
        self.pre = None if pre is None else ntt._on_device(
            ("shift", (tuple(pre), log_n)), "cpu")
        self.post = None if post is None else ntt._on_device(
            ("shift", (tuple(post), log_n)), "cpu")
        self.scale, self.tile_log, self.pass_log = scale, tile_log, pass_log

    def factors(self, g, rl):
        """A step's factor table (``ntt.step_twiddles``), as the kernel
        finds it at the address in the plan."""
        re, im = ntt.step_twiddles(self.L, self.inverse, g, rl)
        return (torch.from_numpy(re.astype(np.int64)),
                torch.from_numpy(im.astype(np.int64)))

    def run(self, re, im, flags=0, plan=None):
        """``re``/``im``: int64 [B, in_len] (or, with FLAG_IN_PAIRS, the
        pairs as ``re`` and ``im`` together).  Returns the int64 pair
        [B, n], or with FLAG_OUT_PAIRS the uint32 pairs [B, n, 2]."""
        L, n = self.L, self.n
        batch, in_len = re.shape
        plan = plan or ntt.ntt_plan(L, batch, in_len, self.tile_log,
                                    self.pass_log)
        self.mid = torch.full((batch, n, 2), POISON, dtype=torch.int64)
        self.out = torch.full((batch, n, 2), POISON, dtype=torch.int64)
        for i, ps in enumerate(plan):
            self._pass(ps, i == 0, i == len(plan) - 1, re, im, in_len, flags)
        if flags & FLAG_OUT_PAIRS:
            return self.out
        return self.out[..., 0], self.out[..., 1]

    def _pass(self, ps, first, last, in_re, in_im, in_len, flags):
        L, n = self.L, self.n
        k, tau, lo = ps.k, ps.tau, ps.lo
        skip = ps.skip if first else 0
        K, T, Kp = 1 << k, 1 << tau, 1 << (k - skip)
        KT = K * T
        per_row = n >> (k + tau)
        assert (k + tau <= L) and (first or 1 <= tau <= lo)
        assert sum(ps.steps) == k - skip and all(1 <= s <= 3
                                                 for s in ps.steps)
        nt = max(KT >> 3, 1)
        assert nt <= 512
        slot_words = (K + PAD) * T if first else KT
        tiles = in_re.shape[0] * per_row
        t = torch.arange(tiles)
        row, blk = (t // per_row)[:, None], (t % per_row)[:, None]
        nlow = lo - tau
        low_b = (blk & ((1 << max(nlow, 0)) - 1)) << tau
        hi_b = (blk >> max(nlow, 0)) << (lo + k)

        def pos(r, q):
            if first:
                return (blk << k) | r | (q << (L - tau))
            return hi_b | (r << lo) | low_b | q

        slot = torch.full((tiles, slot_words, 2), POISON, dtype=torch.int64)
        # The tile's asynchronous copies.
        if first:
            w = torch.arange(Kp * T)[None, :]
            h, c = w >> tau, w & (T - 1)
            idx = (h << (L - k)) | (brev(blk, L - k - tau) << tau) | c
            ok = idx < in_len
            src = torch.where(ok, idx, 0)
            dst = (brev(c, tau) * (Kp + PAD) + brev(h, k - skip)).expand_as(
                idx)
            assert int(dst.max()) < slot_words
            rows = row.expand_as(idx)
            if flags & FLAG_IN_PAIRS:
                coords = ((in_re, 0), (in_im, 1))
            else:
                coords = ((in_re, 0),) + (((in_im, 1),) if in_im is not None
                                          else ())
            for src_t, cc in coords:
                val = torch.where(ok, src_t[rows, src] & M32, 0)
                slot[torch.arange(tiles)[:, None], dst, cc] = val
        else:
            c2 = torch.arange(KT // 2)[None, :]
            r, qq = c2 >> (tau - 1), (c2 & (T // 2 - 1)) << 1
            p = pos(r, qq)
            for d in (0, 1):
                slot[torch.arange(tiles)[:, None],
                     shared_row(r) * T + qq + d] = self.mid[row.expand_as(p),
                                                            p + d]

        s = skip
        batch = tiles
        bi = torch.arange(tiles)[:, None]
        for st, rl in enumerate(ps.steps):
            R = 1 << rl
            groups = KT >> rl
            assert nt * (8 >> rl) >= groups
            gid = torch.arange(groups)[None, :]
            if first:
                lo_ = gid & ((1 << s) - 1)
                rest = gid >> s
                q, hi = rest & (T - 1), rest >> tau
            else:
                q = gid & (T - 1)
                rest = gid >> tau
                lo_, hi = rest & ((1 << s) - 1), rest >> s
            r0 = lo_ | (hi << (s + rl))
            rj = [r0 + (j << s) for j in range(R)]
            pts = []
            for j in range(R):
                if first and st == 0:
                    i = q * (Kp + PAD) + (rj[j] >> skip)
                elif first:
                    i = q * (K + PAD) + rj[j]
                else:
                    i = shared_row(rj[j]) * T + q
                i = i.expand(batch, -1)
                v = [slot[bi, i, 0], slot[bi, i, 1]]
                if first and st == 0:
                    if in_im is None and not flags & FLAG_IN_PAIRS:
                        v[1] = torch.zeros_like(v[1])
                    if self.pre is not None:
                        src_r = (rj[j] >> skip) << skip
                        idx = brev(pos(src_r, q), L).expand(batch, -1)
                        v = list(lz_cmul(v, (self.pre[0][idx],
                                             self.pre[1][idx])))
                pts.append(v)
            if lo + s > 0:
                x0 = lo_ if first else (lo_ << lo) | low_b | q
                table = self.factors(lo + s, rl)
                for j in range(1, R):
                    f = (x0 * (R - 1) + j - 1).expand(batch, -1)
                    pts[j] = list(lz_cmul(pts[j], (table[0][f],
                                                   table[1][f])))
            w4_is_i = self.w4_is_i
            consts = {(2, 1): self.w8, (2, 3): self.w8_3}
            for tt in range(rl):
                for j in range(R):
                    if j >> tt & 1:
                        continue
                    a, b = pts[j], pts[j + (1 << tt)]
                    m = j & ((1 << tt) - 1)
                    if m and (tt, m) in ((1, 1), (2, 2)):   # w4 = +-i
                        b = ([P - b[1], b[0]] if w4_is_i
                             else [b[1], P - b[0]])
                    elif m:
                        b = list(lz_cmul(b, consts[(tt, m)]))
                    pts[j] = [lz_add(a[0], b[0]), lz_add(a[1], b[1])]
                    pts[j + (1 << tt)] = [lz_sub(a[0], b[0]),
                                          lz_sub(a[1], b[1])]
            if st == len(ps.steps) - 1:
                for j in range(R):
                    p = pos(rj[j], q).expand(batch, -1)
                    rows = row.expand_as(p)
                    v = pts[j]
                    if last:
                        if self.post is not None:
                            v = list(lz_cmul(v, (self.post[0][p],
                                                 self.post[1][p])))
                        if self.scale != 1:
                            v = [lz_fold(x * self.scale) for x in v]
                        self.out[rows, p] = torch.stack(
                            [canon(v[0]), canon(v[1])], -1)
                    else:
                        self.mid[rows, p] = torch.stack(v, -1)
            else:
                for j in range(R):
                    i = (q * (K + PAD) + rj[j] if first
                         else shared_row(rj[j]) * T + q)
                    slot[bi, i.expand(batch, -1)] = torch.stack(pts[j], -1)
            s += rl


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """Several pytest workers share the machine: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, P, shape, dtype=np.int64))


def check(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# log_n, batch: every size 2^1 .. 2^20 once, batch 1 above 2^16.
SIZES = [(1, 3), (2, 2), (3, 1), (4, 3), (5, 1), (6, 2), (7, 1), (8, 1),
         (9, 2), (10, 1), (11, 1), (12, 2), (13, 1), (14, 2), (15, 1),
         (16, 2), (17, 1), (18, 1), (19, 1), (20, 1)]


@pytest.mark.parametrize("log_n,batch", SIZES,
                         ids=[f"2^{s}x{b}" for s, b in SIZES])
def test_plan_forward_and_inverse_equal_plain(log_n, batch):
    n = 1 << log_n
    re, im = words(log_n, (batch, n)), words(100 + log_n, (batch, n))
    for inverse in (False, True):
        check(Emulator(log_n, inverse).run(re, im),
              ntt.ntt_plain(re, im, log_n, inverse))


EDGES = {
    "short real, pre, scale": dict(short=4, real=True, pre=SHIFT, scale=3),
    "short, inverse, post, scale": dict(short=2, inverse=True,
                                        post=ntt.cm31_inv_scalar(SHIFT),
                                        scale=5),
    "odd length": dict(short=None, odd=True, pre=SHIFT),
}


@pytest.mark.parametrize("log_n", [3, 13, 18])
@pytest.mark.parametrize("edge", EDGES)
def test_plan_edges_equal_plain(log_n, edge):
    e = EDGES[edge]
    n = 1 << log_n
    in_len = n // e["short"] if e.get("short") else n - 3
    re = words(log_n, (2, in_len))
    im = None if e.get("real") else words(7 + log_n, (2, in_len))
    args = (log_n, e.get("inverse", False), e.get("pre"), e.get("post"),
            e.get("scale", 1))
    check(Emulator(*args).run(re, im), ntt.ntt_plain(re, im, *args))


def test_plan_reads_strided_rows():
    """Rows whose stride is not the row length (a block of a wider
    matrix): the copies address rows through the stride alone."""
    wide = words(5, (3, 1 << 14))
    re, im = wide[:, 8:8 + (1 << 13)], wide[:, 100:100 + (1 << 13)]
    check(Emulator(13, False, pre=SHIFT).run(re, im),
          ntt.ntt_plain(re.contiguous(), im.contiguous(), 13, False,
                        pre=SHIFT))


@pytest.mark.parametrize("log_n,log_blowup", [(4, 2), (8, 1), (12, 2),
                                              (16, 2)])
def test_plan_lde_through_uint32_pairs(log_n, log_blowup):
    """``lde`` on a card: the iNTT multiplies coefficient i by shift^i on
    its store and leaves the coefficients as uint32 pairs
    (FLAG_OUT_PAIRS); the forward transform reads them (FLAG_IN_PAIRS),
    its first pass skipping the stages that only replicate them into the
    2^log_blowup cosets."""
    re = words(log_n, (2, 1 << log_n))
    big = log_n + log_blowup
    coef = Emulator(log_n, True, post=SHIFT, scale=ntt.s_inv(1 << log_n)).run(
        re, None, flags=FLAG_OUT_PAIRS)
    assert ntt.ntt_plan(big, 2, 1 << log_n)[0].skip == min(
        log_blowup, ntt.ntt_plan(big, 2, 1 << log_n)[0].k - 1)
    got = Emulator(big, False).run(coef[..., 0], coef[..., 1],
                                   flags=FLAG_IN_PAIRS)
    check(got, ntt.lde(re, None, log_n, log_blowup, shift=SHIFT))


@pytest.mark.parametrize("tile_log,pass_log", [(12, 10), (11, 8), (13, 9)])
def test_other_plans_equal_plain(tile_log, pass_log):
    """The bench's other tile and pass sizes run the same maps."""
    re, im = words(1, (2, 1 << 16)), words(2, (2, 1 << 16))
    for log_n in (16, 14):
        check(Emulator(log_n, False, tile_log=tile_log,
                       pass_log=pass_log).run(re[:, :1 << log_n],
                                              im[:, :1 << log_n]),
              ntt.ntt_plain(re[:, :1 << log_n], im[:, :1 << log_n], log_n,
                            False))


def test_plan_shapes():
    """What the kernel requires of a plan, at the prover's sizes and the
    bench's: tiles of at most 2^12 points (512 threads of 8 points),
    later passes at least two positions wide (16-byte copies), at most
    four register steps, and the LDE's first pass skipping two stages."""
    for log_n in range(1, 25):
        for batch in (1, 64, 596):
            plan = ntt.ntt_plan(log_n, batch, 1 << log_n)
            assert sum(p.k for p in plan) == log_n
            assert [p.lo for p in plan] == [sum(q.k for q in plan[:i])
                                            for i in range(len(plan))]
            for i, p in enumerate(plan):
                assert p.k + p.tau <= ntt.TILE_LOG
                assert len(p.steps) <= ntt.MAX_STEPS
                assert i == 0 or 1 <= p.tau <= p.lo
    for log_n in (3, 12, 18):
        plan = ntt.ntt_plan(log_n, 3, 1 << log_n)
        words_ = ntt.plan_words(plan, 3, log_n, False)
        assert len(words_) == 5 + len(plan) * (5 + 2 * ntt.MAX_STEPS)
        assert list(words_[:2]) == [len(plan), 3]
    assert ntt.ntt_plan(18, 596, 1 << 16)[0].skip == 2
    assert ntt.ntt_plan(18, 1, (1 << 16) + 1)[0].skip == 1
    assert [p.k for p in ntt.ntt_plan(18, 596, 1 << 18)] == [6, 6, 6]
    assert [p.tau for p in ntt.ntt_plan(18, 596, 1 << 18)] == [6, 6, 6]
    assert [(p.k, p.tau) for p in ntt.ntt_plan(18, 1, 1 << 18)] == [(9, 2),
                                                                    (9, 2)]
    assert [p.k for p in ntt.ntt_plan(16, 596, 1 << 16)] == [8, 8]
