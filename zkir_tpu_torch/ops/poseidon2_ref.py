"""Scalar Poseidon2 permutation over Mersenne-31 (reference implementation).

The upstream reference declares Poseidon2 as a syscall and a witness type but
ships only a stub (``zkir-runtime/src/crypto.rs:306-315`` returns
"Poseidon2 not yet implemented"), so there are no upstream vectors to match.
This implementation follows the Poseidon2 paper construction
(https://eprint.iacr.org/2023/323):

- width t = 16, s-box x^5 (gcd(5, p-1) = 1 over p = 2^31 - 1),
- 8 external (full) rounds, 14 internal (partial) rounds — the parameter
  choice used by Plonky3 for Mersenne-31 width 16,
- external matrix M_E = circ(2*M4, M4, M4, M4) with the paper's M4,
- internal matrix M_I[i][j] = 1 for i != j and mu_i on the diagonal,
- round constants and the internal diagonal mu derived with the Grain LFSR
  procedure from the original Poseidon reference implementation
  (generate_parameters_grain.sage), parameterized (prime field, x^alpha,
  n=31, t=16, R_F=8, R_P=14).  Constants are therefore deterministic,
  nothing-up-my-sleeve, and reproducible from this file alone.

The batched TPU kernel (``zkir_tpu.ops.poseidon2``) is differential-tested
against this module.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

from ..spec.field import M31_PRIME, m31_add, m31_inv, m31_mul

WIDTH = 16
RATE = 8
CAPACITY = WIDTH - RATE
ROUNDS_F = 8  # external rounds (split half before / half after internal)
ROUNDS_P = 14  # internal rounds
ALPHA = 5
N_BITS = 31

# The Poseidon2 paper's 4x4 building block (eprint 2023/323, section 5.1).
_M4 = (
    (5, 7, 1, 3),
    (4, 6, 1, 1),
    (1, 3, 5, 7),
    (1, 1, 4, 6),
)


# ============================================================================
# Grain LFSR parameter generation (Poseidon reference procedure)
# ============================================================================


class _GrainLFSR:
    """80-bit Grain LFSR from the Poseidon reference parameter generator.

    Initialization bit layout (MSB-first): 2 bits field type (0b01 = prime),
    4 bits s-box (0 = x^alpha), 12 bits field size n, 12 bits width t,
    10 bits R_F, 10 bits R_P, then 30 one-bits.  After seeding, 160 output
    bits are discarded; afterwards bits are produced in self-shrinking mode
    (a '1' guard bit emits the next bit, a '0' guard discards it).
    """

    def __init__(self, n: int, t: int, r_f: int, r_p: int):
        bits: List[int] = []

        def push(value: int, width: int) -> None:
            for i in reversed(range(width)):
                bits.append((value >> i) & 1)

        push(0b01, 2)      # prime field
        push(0, 4)         # x^alpha s-box
        push(n, 12)
        push(t, 12)
        push(r_f, 10)
        push(r_p, 10)
        push((1 << 30) - 1, 30)
        assert len(bits) == 80
        self.state = bits

        for _ in range(160):
            self._next_raw_bit()

    def _next_raw_bit(self) -> int:
        s = self.state
        new_bit = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new_bit]
        return new_bit

    def next_bit(self) -> int:
        # Self-shrinking: guard bit 1 -> emit next bit; 0 -> skip it.
        while True:
            guard = self._next_raw_bit()
            bit = self._next_raw_bit()
            if guard == 1:
                return bit

    def next_field_element(self) -> int:
        # Rejection-sample an n-bit integer < p.
        while True:
            value = 0
            for _ in range(N_BITS):
                value = (value << 1) | self.next_bit()
            if value < M31_PRIME:
                return value


def _det_mod_p(matrix: List[List[int]]) -> int:
    """Determinant mod p via Gaussian elimination (invertibility check)."""
    n = len(matrix)
    m = [row[:] for row in matrix]
    det = 1
    for col in range(n):
        pivot = next((r for r in range(col, n) if m[r][col] != 0), None)
        if pivot is None:
            return 0
        if pivot != col:
            m[col], m[pivot] = m[pivot], m[col]
            det = M31_PRIME - det
        det = m31_mul(det, m[col][col])
        inv = m31_inv(m[col][col])
        for r in range(col + 1, n):
            factor = m31_mul(m[r][col], inv)
            for c in range(col, n):
                m[r][c] = (m[r][c] - m31_mul(factor, m[col][c])) % M31_PRIME
    return det


@lru_cache(maxsize=None)
def poseidon2_params():
    """(external_constants, internal_constants, internal_diag) — all derived
    from the Grain LFSR stream in order: R_F*t external constants, R_P
    internal constants, then t diagonal entries (re-drawn until the internal
    matrix is invertible)."""
    grain = _GrainLFSR(N_BITS, WIDTH, ROUNDS_F, ROUNDS_P)
    external = [
        [grain.next_field_element() for _ in range(WIDTH)]
        for _ in range(ROUNDS_F)
    ]
    internal = [grain.next_field_element() for _ in range(ROUNDS_P)]

    while True:
        diag = [grain.next_field_element() for _ in range(WIDTH)]
        m_i = [
            [diag[i] if i == j else 1 for j in range(WIDTH)]
            for i in range(WIDTH)
        ]
        if _det_mod_p(m_i) != 0:
            break

    return external, internal, diag


# ============================================================================
# Permutation
# ============================================================================


def _sbox(x: int) -> int:
    x2 = m31_mul(x, x)
    x4 = m31_mul(x2, x2)
    return m31_mul(x4, x)


def _apply_m4(block: Sequence[int]) -> List[int]:
    # Paper's fast evaluation (eprint 2023/323, appendix B).
    t0 = m31_add(block[0], block[1])
    t1 = m31_add(block[2], block[3])
    t2 = m31_add(m31_add(block[1], block[1]), t1)
    t3 = m31_add(m31_add(block[3], block[3]), t0)
    t4 = m31_add(m31_add(m31_add(t1, t1), m31_add(t1, t1)), t3)
    t5 = m31_add(m31_add(m31_add(t0, t0), m31_add(t0, t0)), t2)
    t6 = m31_add(t3, t5)
    t7 = m31_add(t2, t4)
    return [t6, t5, t7, t4]


def _external_matrix(state: Sequence[int]) -> List[int]:
    """M_E = circ(2*M4, M4, ..., M4): per-block M4, plus the block sums."""
    blocks = [_apply_m4(state[i: i + 4]) for i in range(0, WIDTH, 4)]
    sums = [0, 0, 0, 0]
    for block in blocks:
        for i in range(4):
            sums[i] = m31_add(sums[i], block[i])
    out = []
    for block in blocks:
        for i in range(4):
            out.append(m31_add(block[i], sums[i]))
    return out


def _internal_matrix(state: Sequence[int], diag: Sequence[int]) -> List[int]:
    """(M_I x)_i = sum(x) + (mu_i - 1) * x_i."""
    total = 0
    for x in state:
        total = m31_add(total, x)
    return [
        (total + m31_mul((diag[i] - 1) % M31_PRIME, state[i])) % M31_PRIME
        for i in range(WIDTH)
    ]


def poseidon2_permute(state: Sequence[int]) -> List[int]:
    """Full Poseidon2 permutation on a width-16 state of M31 elements."""
    assert len(state) == WIDTH
    external, internal, diag = poseidon2_params()
    x = [v % M31_PRIME for v in state]

    # Initial external matrix (Poseidon2 applies M_E before the first round).
    x = _external_matrix(x)

    half = ROUNDS_F // 2
    for r in range(half):
        x = [_sbox(m31_add(x[i], external[r][i])) for i in range(WIDTH)]
        x = _external_matrix(x)

    for r in range(ROUNDS_P):
        x[0] = _sbox(m31_add(x[0], internal[r]))
        x = _internal_matrix(x, diag)

    for r in range(half, ROUNDS_F):
        x = [_sbox(m31_add(x[i], external[r][i])) for i in range(WIDTH)]
        x = _external_matrix(x)

    return x


# ============================================================================
# Sponge (rate 8, capacity 8)
# ============================================================================


def bytes_to_field_elements(data: bytes) -> List[int]:
    """Pack bytes into 4-byte LE words reduced mod p."""
    words = []
    for i in range(0, len(data), 4):
        chunk = data[i: i + 4]
        words.append(int.from_bytes(chunk, "little") % M31_PRIME)
    return words


def poseidon2_sponge(elements: Sequence[int]) -> List[int]:
    """Sponge hash: absorb rate-8 blocks (with 1||0* padding), squeeze 8
    field elements."""
    padded = list(elements) + [1]
    while len(padded) % RATE != 0:
        padded.append(0)

    state = [0] * WIDTH
    for off in range(0, len(padded), RATE):
        for i in range(RATE):
            state[i] = m31_add(state[i], padded[off + i])
        state = poseidon2_permute(state)
    return state[:RATE]


def poseidon2_sponge_hash_bytes(data: bytes) -> List[int]:
    """Hash a byte string; returns 8 output words (u32, each < p)."""
    return poseidon2_sponge(bytes_to_field_elements(data))


def poseidon2_compress(left: Sequence[int], right: Sequence[int]) -> List[int]:
    """2-to-1 compression for Merkle trees: permute(left || right)[:8],
    feed-forward with the left input (Davies-Meyer style)."""
    assert len(left) == RATE and len(right) == RATE
    out = poseidon2_permute(list(left) + list(right))
    return [m31_add(out[i], left[i] % M31_PRIME) for i in range(RATE)]
