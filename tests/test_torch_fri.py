"""The port's FRI prover against the JAX package: the same QM31 values and
the same challenger state must give the same proof dict (tolerance 0),
which both verifiers accept."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from zkir_tpu.prover import fri as rfri
from zkir_tpu.prover.challenger import Challenger as RefChallenger
from zkir_tpu_torch.ops.ntt import _find_generator, coset_ntt
from zkir_tpu_torch.prover import fri as pfri
from zkir_tpu_torch.prover.challenger import Challenger

P = (1 << 31) - 1
CFG = dict(log_blowup=2, log_final=2, num_queries=8, grinding_bits=0,
           min_security=0)


def _low_degree_evals(log_n, log_blowup, shift, seed=0):
    """QM31 evaluations on the coset of a random polynomial of degree
    < 2^(log_n - log_blowup), as int64 tensors."""
    rng = np.random.default_rng(seed)
    n, deg = 1 << log_n, 1 << (log_n - log_blowup)
    out = []
    for _ in range(2):
        coef = np.zeros((2, n), dtype=np.int64)
        coef[:, :deg] = rng.integers(0, P, (2, deg))
        coef = torch.from_numpy(coef)
        out += list(coset_ntt(coef[0], coef[1], log_n, shift=shift))
    return tuple(out)


def test_fri_prove_matches_reference():
    log_n, shift = 3, _find_generator()   # one fold: 8 -> 4
    vals = _low_degree_evals(log_n, CFG["log_blowup"], shift)
    ref_c, port_c = RefChallenger(), Challenger()
    for c in (ref_c, port_c):
        c.observe_many([log_n, 5, 99])
    got = pfri.fri_prove(vals, log_n, port_c, pfri.FriConfig(**CFG),
                         shift=shift)
    want = rfri.fri_prove(
        tuple(jnp.asarray(v.numpy().astype(np.uint32)) for v in vals),
        log_n, ref_c, rfri.FriConfig(**CFG), shift=shift)
    assert dataclasses.asdict(got.pop("config")) == \
        dataclasses.asdict(want.pop("config"))
    assert got == want
    assert port_c.sample() == ref_c.sample()

    got["config"] = pfri.FriConfig(**CFG)
    verifier = Challenger()
    verifier.observe_many([log_n, 5, 99])
    assert pfri.fri_verify(got, verifier)
    got["final"][0][0] = (got["final"][0][0] + 1) % P
    verifier = Challenger()
    verifier.observe_many([log_n, 5, 99])
    assert not pfri.fri_verify(got, verifier)


def test_fri_config_budget():
    assert pfri.FriConfig().security_bits(18, 497) == \
        rfri.FriConfig().security_bits(18, 497)
    try:
        pfri.FriConfig(num_queries=4)
    except ValueError:
        pass
    else:
        raise AssertionError("a config below min_security was accepted")
