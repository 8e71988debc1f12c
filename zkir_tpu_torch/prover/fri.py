"""FRI low-degree proof over the CM31 NTT domain, QM31-valued, in torch.

Counterpart of ``zkir_tpu/prover/fri.py``: ``FriConfig`` and the host
verifier ``fri_verify`` are copies; the commit phase (leaf pairing, the
fold, the layer trees) runs on the device of its input.

The committed evaluation domain is the CM31 coset (the 2-adic subgroup
lives in CM31); the *values* are QM31 (the batch combination is taken
with a QM31 challenge, ops/qm31.py), and the fold challenges are QM31 —
so every Schwartz–Zippel term in the soundness accounting scales with
|QM31| ~ 2^124 (round 3's CM31 draws capped end-to-end soundness at 29
bits for a 2^24-row trace; see ``FriConfig.security_bits``).

Commit phase: repeatedly fold the evaluation vector in half with
verifier-supplied challenges, committing each layer with a Poseidon2
Merkle tree whose leaves pair ``(e_j, e_{j+n/2})`` so one query opens
both fold inputs with a single path.  Query phase: spot-check the fold
chain at random indices.

Folding rule on the multiplicative domain x_j = shift * w^j (w of order
n, so x_{j+n/2} = -x_j):

    e'_j = (e_j + e_{j+n/2}) / 2  +  beta * (e_j - e_{j+n/2}) / (2 x_j)

which is exactly f'(x^2) for f'(y) = f_even(y) + beta * f_odd(y); the
new domain is the order-n/2 subgroup.  Each fold halves the committed
degree, so evaluations of a degree < n / 2^log_blowup polynomial end in
a final layer whose componentwise iNTT has only its low
2^(log_final - log_blowup) coefficients non-zero — which the verifier
checks directly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..ops import merkle
from ..ops.field_ops import m31_mul
from ..ops.ntt import (
    cm31_inv_scalar,
    cm31_mul,
    cm31_mul_scalar,
    cm31_pow_scalar,
    intt,
    root_of_unity,
    _on_device,
)
from ..ops.qm31 import (
    qm31_add,
    qm31_add_scalar,
    qm31_mul,
    qm31_mul_cm31,
    qm31_mul_cm31_scalar,
    qm31_mul_scalar,
    qm31_sub,
    qm31_sub_scalar,
)
from ..spec.field import M31_PRIME, m31_inv as s_inv
from .challenger import Challenger

P = M31_PRIME


@dataclasses.dataclass(frozen=True)
class FriConfig:
    """FRI parameters with an enforced soundness budget.

    Soundness arithmetic (conjectured, up-to-capacity regime — the
    standard ethSTARK/Plonky3 estimate):

      * each query contributes ``log_blowup`` bits (a cheating prover's
        per-query survival probability is the rate 2^-log_blowup), so
        the query phase gives ``num_queries * log_blowup`` bits;
      * proof-of-work grinding before query sampling adds
        ``grinding_bits`` (the attacker must redo 2^grinding_bits
        permutations per transcript fork);
      * the commit/batching phase error is bounded by ~L*n/|QM31| with
        all batching/fold challenges drawn from the degree-4 extension
        QM31 (|QM31| = (2^31-1)^4 ~ 2^124): about
        ``124 - log_n - log2(n_terms)`` bits for an n-point committed
        domain batched over n_terms columns/constraints.

    ``__post_init__`` rejects configurations whose FRI-phase budget
    (queries + grinding) is below ``min_security``; ``prove_trace``
    additionally rejects a prove whose *end-to-end*
    ``security_bits(log_n, n_terms)`` falls below ``min_security``.
    Pass ``min_security=0`` only in tests that deliberately shrink
    proofs.
    """

    log_blowup: int = 2
    # Stop folding at 2^log_final evaluations (clamped to log_n - 1 for
    # tiny domains).  6 trades ~1 KB of plaintext final layer for three
    # fewer fold rounds than the round-4 default of 3 — each round is a
    # Merkle build + a host round trip through the Fiat-Shamir
    # transcript, which dominates warm-prove FRI time on a remote-TPU
    # link.  Soundness is unaffected: the verifier checks the final
    # layer's degree directly.
    log_final: int = 6
    num_queries: int = 32
    grinding_bits: int = 16
    min_security: int = 80

    def __post_init__(self):
        budget = self.num_queries * self.log_blowup + self.grinding_bits
        if budget < self.min_security:
            raise ValueError(
                f"FRI soundness budget too small: {self.num_queries} "
                f"queries x {self.log_blowup} bits + {self.grinding_bits} "
                f"grinding = {budget} < min_security={self.min_security} "
                "(raise num_queries/grinding_bits, or pass min_security=0 "
                "for test-size proofs)")

    def security_bits(self, log_n: int = 24, n_terms: int = 512) -> int:
        """Conjectured end-to-end bits for an n = 2^log_n-row trace
        batching n_terms committed terms: min(query-phase budget,
        QM31 batching ceiling).  With QM31 challenges the field term is
        124 - log_n - log2(n_terms) — 91 bits at the north-star 2^24
        rows / 512 terms, so the query phase is the binding term."""
        fri_phase = self.num_queries * self.log_blowup + self.grinding_bits
        field_phase = 124 - log_n - max(n_terms - 1, 1).bit_length()
        return min(fri_phase, field_phase)


def _pair_matrix(vals):
    """Stack (e_j, e_{j+h}) pairs as rows [h, 8] for leaf hashing."""
    h = vals[0].shape[0] // 2
    return torch.stack(
        [vals[0][:h], vals[1][:h], vals[2][:h], vals[3][:h],
         vals[0][h:], vals[1][h:], vals[2][h:], vals[3][h:]], dim=1)


def _fold(cur, beta, sinv, log: int):
    """One FRI fold of a QM31 4-tuple of [2^log] tensors:
    e'_j = (lo + hi)/2 + beta * (lo - hi) / (2 x_j), with
    1/x_j = shift^-1 * w^-j."""
    h = (1 << log) // 2
    inv2 = s_inv(2)
    twr, twi = _on_device(("stage", (log, True, h)), cur[0].device)  # w^-j
    xinv = cm31_mul((twr, twi), sinv)
    lo = tuple(c[:h] for c in cur)
    hi = tuple(c[h:] for c in cur)
    half_s = tuple(m31_mul(c, inv2) for c in qm31_add(lo, hi))
    half_d = tuple(m31_mul(c, inv2) for c in qm31_sub(lo, hi))
    odd = qm31_mul_cm31(half_d, xinv)
    return qm31_add(half_s, qm31_mul(beta, odd))


def fri_prove(vals, log_n: int, challenger: Challenger,
              config: FriConfig = FriConfig(),
              shift=(1, 0)) -> Dict[str, Any]:
    """Prove that ``vals`` (a QM31 4-tuple of [2^log_n] int64 tensors) are
    evaluations of a polynomial of degree < 2^(log_n - log_blowup) on
    the coset ``shift * <w>`` of the order-2^log_n subgroup.  The layers
    stay on the device of ``vals``; per layer only the 8-word root
    crosses to the host (the transcript is sequential)."""
    dev_layers = []      # (device tree levels, device values) per layer
    betas = []
    cur = tuple(vals)
    log = log_n
    cur_shift = tuple(shift)
    log_final = min(config.log_final, log_n - 1)

    while log > log_final:
        leaves = merkle.hash_rows(_pair_matrix(cur))
        levels = merkle.build_tree_fused(leaves)
        layer_root = merkle.root(levels)
        challenger.observe_many(int(x) for x in layer_root)
        beta = challenger.sample_qm31()
        betas.append(beta)
        dev_layers.append((levels, cur))

        cur = _fold(cur, beta, cm31_inv_scalar(cur_shift), log)
        cur_shift = cm31_mul_scalar(cur_shift, cur_shift)
        log -= 1

    layers = [
        (merkle.to_host(levels),
         torch.stack(list(lv)).cpu().numpy().astype(np.uint32))
        for levels, lv in dev_layers
    ]
    final = torch.stack(list(cur)).cpu().numpy().astype(np.uint32)
    for k in range(4):
        challenger.observe_many(int(x) for x in final[k])

    # Proof-of-work grinding binds the query challenges (ethSTARK-style).
    pow_nonce = challenger.grind(config.grinding_bits)

    # Query phase.
    queries = []
    query_indices = []
    for _ in range(config.num_queries):
        idx = challenger.sample_bits(log_n - 1)
        query_indices.append(idx)
        steps = []
        cur_idx = idx
        for depth, (levels, lv) in enumerate(layers):
            n = 1 << (log_n - depth)
            h = n // 2
            leaf_idx = cur_idx % h
            steps.append({
                "leaf_idx": leaf_idx,
                "lo": tuple(int(lv[k, leaf_idx]) for k in range(4)),
                "hi": tuple(int(lv[k, leaf_idx + h]) for k in range(4)),
                "path": [
                    [int(x) for x in sib]
                    for sib in merkle.open_path(levels, leaf_idx)
                ],
            })
            cur_idx = leaf_idx
        queries.append(steps)

    return {
        "log_n": log_n,
        "config": config,
        "pow_nonce": pow_nonce,
        "shift": tuple(shift),
        "roots": [
            [int(x) for x in merkle.root(levels)]
            for levels, _ in layers
        ],
        "final": [[int(x) for x in final[k]] for k in range(4)],
        "queries": queries,
        "query_indices": query_indices,
    }


def fri_verify(proof: Dict[str, Any], challenger: Challenger) -> bool:
    """Verify a FRI proof; the challenger must be in the same state the
    prover's was when fri_prove began."""
    log_n = proof["log_n"]
    config: FriConfig = proof["config"]
    shift = tuple(proof.get("shift", (1, 0)))
    inv2 = s_inv(2)

    # Replay transcript.
    betas = []
    for layer_root in proof["roots"]:
        challenger.observe_many(int(x) for x in layer_root)
        betas.append(challenger.sample_qm31())
    for k in range(4):
        challenger.observe_many(int(x) for x in proof["final"][k])

    # Grinding check must precede query replay (same transcript order as
    # the prover).
    if not challenger.check_pow(proof.get("pow_nonce", 0),
                                config.grinding_bits):
        return False

    log_final = min(config.log_final, log_n - 1)
    num_layers = len(proof["roots"])
    if num_layers != log_n - log_final:
        return False

    # Final layer must be low degree: the componentwise iNTT (QM31 is a
    # 2-dim CM31 vector space; the NTT twiddles are CM31) beyond the
    # degree bound must vanish.
    fv = torch.as_tensor(np.asarray(proof["final"], dtype=np.int64))
    bound = 1 << max(log_final - config.log_blowup, 0)
    for base in (0, 2):
        cr, ci = intt(fv[base], fv[base + 1], log_final)
        if bool(cr[bound:].any()) or bool(ci[bound:].any()):
            return False

    # Every query chain's leaf indices must follow its sampled index; the
    # openings' digests and Merkle paths are then checked in one batch per
    # layer (the reference checks them step by step).
    query_idx = [challenger.sample_bits(log_n - 1) for _ in proof["queries"]]
    per_layer = [[] for _ in range(num_layers)]
    for idx, steps in zip(query_idx, proof["queries"]):
        if len(steps) != num_layers:
            return False
        cur_idx = idx
        for depth, step in enumerate(steps):
            if step["leaf_idx"] != cur_idx % (1 << (log_n - depth - 1)) \
                    or len(step["lo"]) != 4 or len(step["hi"]) != 4:
                return False
            per_layer[depth].append(step)
            cur_idx = step["leaf_idx"]
    for depth, steps in enumerate(per_layer):
        if not all(merkle.verify_rows(
                proof["roots"][depth], [s["leaf_idx"] for s in steps],
                [list(s["lo"]) + list(s["hi"]) for s in steps],
                [s["path"] for s in steps], log_n - depth - 1)):
            return False

    # Check each query chain's folds.
    for idx, steps in zip(query_idx, proof["queries"]):
        cur_idx = idx
        expected = None  # folded value to match at the next layer
        for depth, step in enumerate(steps):
            log = log_n - depth
            h = 1 << (log - 1)
            leaf_idx = step["leaf_idx"]
            lo = tuple(step["lo"])
            hi = tuple(step["hi"])
            if expected is not None:
                # The previous fold is this layer's value at cur_idx:
                # lo if cur_idx is in the lower half, hi otherwise.
                value_here = lo if cur_idx < h else hi
                if value_here != expected:
                    return False
            # Compute the fold (x = shift^(2^depth) * w^leaf_idx).
            beta = betas[depth]
            w_inv = cm31_inv_scalar(root_of_unity(log))
            layer_shift = shift
            for _ in range(depth):
                layer_shift = cm31_mul_scalar(layer_shift, layer_shift)
            xinv = cm31_mul_scalar(
                cm31_pow_scalar(w_inv, leaf_idx),
                cm31_inv_scalar(layer_shift))
            s = qm31_add_scalar(lo, hi)
            d = qm31_sub_scalar(lo, hi)
            half_s = tuple((c * inv2) % P for c in s)
            half_d = tuple((c * inv2) % P for c in d)
            odd = qm31_mul_cm31_scalar(half_d, xinv)
            expected = qm31_add_scalar(half_s, qm31_mul_scalar(beta, odd))
            cur_idx = leaf_idx
        # Final layer: the last fold must equal the plaintext final value.
        final_h = 1 << log_final
        final_idx = cur_idx % final_h
        if tuple(proof["final"][k][final_idx] for k in range(4)) != expected:
            return False

    return True

