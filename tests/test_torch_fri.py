"""The port's FRI prover against the JAX package: the same QM31 values and
the same challenger state must give the same proof dict (tolerance 0),
which both verifiers accept.  The reference's proof dict and next draw on
these seeded values are stored in ``tests/fixtures/torch_port/
fri_reference.json`` by ``make_fixtures.py fri``, which runs
``reference_proof`` here (the reference's prove is several XLA
compiles)."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from zkir_tpu.prover import fri as rfri
from zkir_tpu.prover.challenger import Challenger as RefChallenger
from zkir_tpu_torch.ops.ntt import _find_generator, coset_ntt
from zkir_tpu_torch.prover import fri as pfri
from zkir_tpu_torch.prover.challenger import Challenger

P = (1 << 31) - 1
CFG = dict(log_blowup=2, log_final=2, num_queries=8, grinding_bits=0,
           min_security=0)
REFERENCE = pathlib.Path(__file__).resolve().parent / "fixtures" / \
    "torch_port" / "fri_reference.json"
LOG_N = 3                       # one fold: 8 -> 4


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """The suite runs several pytest workers on one machine; a torch
    intra-op thread per core in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _jsonable(x):
    """A proof dict's words as JSON values (tuples as lists, numpy
    integers as ints)."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return _jsonable(x.tolist())
    return int(x) if isinstance(x, (np.integer, int)) else x


def reference_proof():
    """The reference's FRI proof of this file's values, its config as a
    dict, and its challenger's next draw (what ``make_fixtures.py fri``
    stores)."""
    import jax.numpy as jnp

    shift = _find_generator()
    vals = _low_degree_evals(LOG_N, CFG["log_blowup"], shift)
    ref_c = RefChallenger()
    ref_c.observe_many([LOG_N, 5, 99])
    want = rfri.fri_prove(
        tuple(jnp.asarray(v.numpy().astype(np.uint32)) for v in vals),
        LOG_N, ref_c, rfri.FriConfig(**CFG), shift=shift)
    config = dataclasses.asdict(want.pop("config"))
    return {"proof": _jsonable(want), "config": config,
            "next_sample": _jsonable(ref_c.sample())}


def test_fri_prove_matches_reference():
    log_n, shift = LOG_N, _find_generator()
    vals = _low_degree_evals(log_n, CFG["log_blowup"], shift)
    port_c = Challenger()
    port_c.observe_many([log_n, 5, 99])
    got = pfri.fri_prove(vals, log_n, port_c, pfri.FriConfig(**CFG),
                         shift=shift)
    want = json.loads(REFERENCE.read_text())
    assert dataclasses.asdict(got.pop("config")) == want["config"]
    assert _jsonable(got) == want["proof"]
    assert _jsonable(port_c.sample()) == want["next_sample"]

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
