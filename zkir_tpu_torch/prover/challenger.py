"""Fiat-Shamir transcript over a Poseidon2-M31 duplex sponge.

Deterministic on both prover and verifier: every observed value (commitment
digests, folded-layer roots, final polynomial) feeds the sponge; challenges
(random field elements, query indices) are squeezed from it.
"""

from __future__ import annotations

from typing import Iterable, List

from ..spec.field import M31_PRIME
from ..ops.poseidon2_ref import RATE, WIDTH, poseidon2_permute


class Challenger:
    def __init__(self, device=None):
        # Where grind() runs its trial permutations; nothing else in the
        # transcript touches a device.  Without one (a verifier's
        # transcript) grind() refuses: it never picks a device itself.
        self.device = device
        self._state = [0] * WIDTH
        self._absorb_buf: List[int] = []
        self._squeeze_buf: List[int] = []

    def observe(self, value: int) -> None:
        self._squeeze_buf.clear()
        self._absorb_buf.append(int(value) % M31_PRIME)
        if len(self._absorb_buf) == RATE:
            self._duplex()

    def observe_many(self, values: Iterable[int]) -> None:
        for v in values:
            self.observe(v)

    def _duplex(self) -> None:
        for i, v in enumerate(self._absorb_buf):
            self._state[i] = (self._state[i] + v) % M31_PRIME
        self._absorb_buf.clear()
        self._state = poseidon2_permute(self._state)
        self._squeeze_buf = list(self._state[:RATE])

    def sample(self) -> int:
        """Squeeze one M31 challenge."""
        if self._absorb_buf or not self._squeeze_buf:
            self._duplex()
        return self._squeeze_buf.pop()

    def sample_cm31(self):
        return (self.sample(), self.sample())

    def sample_qm31(self):
        """Squeeze one QM31 challenge (4 M31 draws) — the extension the
        batching/DEEP/FRI/LogUp challenges live in (ops/qm31.py)."""
        return (self.sample(), self.sample(), self.sample(), self.sample())

    def sample_bits(self, bits: int) -> int:
        """Uniform integer in [0, 2^bits) (bits <= 30 per draw)."""
        assert bits <= 30
        return self.sample() & ((1 << bits) - 1)

    def grind(self, bits: int) -> int:
        """Proof-of-work grinding: find and absorb a nonce such that the
        next ``sample_bits(bits)`` draw is zero, then consume that draw.

        Forces ~2^bits Poseidon2 permutations of prover work per
        transcript fork, adding ``bits`` to the soundness budget
        (ethSTARK-style grinding).  One trial is one permutation of a copy
        of the sponge state with the nonce absorbed at rate position 0;
        the lowest hitting nonce wins.  The search is ``ops.poseidon2
        .grind``: one kernel launch on a GPU, batches of plain torch
        permutations on the CPU."""
        if bits == 0:
            return 0
        if self.device is None:
            raise ValueError("Challenger.grind searches on a device: "
                             "construct the Challenger with device=...")
        from ..ops.poseidon2 import grind

        if self._absorb_buf:
            self._duplex()  # trials must share the post-permute state
        nonce = grind(self._state, bits, self.device)
        self.observe(nonce)
        # sample() pops the squeeze buffer from the end: the first draw
        # after a duplex is state[RATE - 1], the word the search tested.
        if self.sample_bits(min(bits, 30)) != 0:
            raise RuntimeError("grind/duplex mismatch")
        return nonce

    def check_pow(self, nonce: int, bits: int) -> bool:
        """Verifier side of ``grind``: absorb the claimed nonce and check
        the next draw is zero."""
        if bits == 0:
            return True
        if self._absorb_buf:
            self._duplex()  # same framing as grind(): nonce absorbed alone
        self.observe(int(nonce))
        return self.sample_bits(min(bits, 30)) == 0
