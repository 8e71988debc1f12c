"""The port's Poseidon2, Merkle trees and grinding against the JAX package.

Tolerance 0.  The Pallas permutation runs in interpret mode, as
``tests/test_ops_kernels.py`` runs it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkir_tpu.ops import merkle as rm
from zkir_tpu.ops import poseidon2 as rp
from zkir_tpu.prover.challenger import Challenger as RefChallenger
from zkir_tpu_torch.convert import poseidon2_params_from_reference
from zkir_tpu_torch.ops import merkle as pm
from zkir_tpu_torch.ops import poseidon2 as pp
from zkir_tpu_torch.ops.poseidon2_ref import (bytes_to_field_elements,
                                              poseidon2_compress,
                                              poseidon2_sponge)
from zkir_tpu_torch.prover.challenger import Challenger

P = (1 << 31) - 1


def words(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, shape, dtype=np.uint32)


def t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def host(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x,
                      dtype=np.uint32)


def test_permute_matches_pallas_and_jnp():
    states = words(1, (8, 16))
    states[0] = 0
    states[1] = P - 1
    got = host(pp.poseidon2_permute_batch(t(states)))
    pallas = host(rp.poseidon2_permute_pallas(jnp.asarray(states),
                                              interpret=True))
    want = host(rp.poseidon2_permute_batch(jnp.asarray(states)))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, want)


def test_pinned_kats():
    """The known-answer vectors of docs/POSEIDON2.md through the batched
    permutation and the row sponge."""
    out = host(pp.poseidon2_permute_batch(t([[0] * 16, list(range(16))])))
    assert out[0, :4].tolist() == [1304355236, 1786230697, 1252711109,
                                   1945258516]
    assert out[1, :4].tolist() == [1663501927, 1148442227, 887313724,
                                   52423570]
    abc = bytes_to_field_elements(b"abc")
    assert host(pm.hash_rows(t([abc])))[0, :4].tolist() == [
        1149247174, 988940175, 1305207541, 208049065]


@pytest.mark.parametrize("width", [16, 13])
def test_hash_rows(width):
    """A width that is a multiple of 8 still gets the 1||0* padding."""
    m = words(2 + width, (32, width))
    np.testing.assert_array_equal(host(pm.hash_rows(t(m))),
                                  host(rm.hash_rows(jnp.asarray(m))))


def test_sponge_and_compress_batch():
    """Against the scalar reference (poseidon2_ref), as
    tests/test_ops_kernels.py checks the jnp versions."""
    elements = [int(x) for x in words(3, 11)]
    padded = elements + [1] + [0] * 4                   # 1||0* to 16
    blocks = t([padded]).reshape(1, 2, 8)
    assert host(pp.poseidon2_sponge_batch(blocks))[0].tolist() == \
        poseidon2_sponge(elements)
    left, right = words(4, (8, 8)), words(5, (8, 8))
    got = host(pp.poseidon2_compress_batch(t(left), t(right)))
    for i in range(8):
        assert got[i].tolist() == poseidon2_compress(
            left[i].tolist(), right[i].tolist())


def test_build_tree_fused_and_paths():
    leaves = words(6, (8, 8))
    got = pm.to_host(pm.build_tree_fused(t(leaves)))
    want = rm.to_host(rm.build_tree_fused(jnp.asarray(leaves)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    root = pm.root(got)
    for idx in (0, 5, 7):
        path = pm.open_path(got, idx)
        for a, b in zip(path, rm.open_path(want, idx)):
            np.testing.assert_array_equal(a, b)
        assert pm.verify_path(root, idx, got[0][idx], path)
        assert not pm.verify_path(root, idx, got[0][idx ^ 1], path)

    # The batched row + path check against the scalar host functions on
    # a tree of hashed rows: honest openings, a changed row, a short path.
    rows = words(7, (8, 13))
    levels = pm.to_host(pm.build_tree(pm.hash_rows(t(rows))))
    root = pm.root(levels)
    idx = [0, 5, 7, 5, 2]
    opened = [rows[i].tolist() for i in idx]
    opened[3][0] = (opened[3][0] + 1) % P
    paths = [pm.open_path(levels, i) for i in idx]
    paths[4] = paths[4][:-1]
    want = [pm.verify_path(root, i, pm.hash_row_host(r), p)
            for i, r, p in zip(idx, opened, paths)]
    assert want == [True, True, True, False, False]
    assert pm.verify_rows(root, idx, opened, paths, 3) == want
    with pytest.raises(AssertionError):
        pm.build_tree(t(leaves[:6]))


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_build_tree_plain_levels_are_views_of_one_buffer(n):
    """Levels 1.. of ``build_tree_plain`` (the layout the kernel's result is
    read through) are consecutive views of one [n - 1, 8] buffer: level j
    has n >> j rows from row n - (n >> (j - 1)), the root last."""
    leaves = t(words(20 + n, (n, 8)))
    levels = pm.build_tree_plain(leaves)
    assert levels[0] is leaves
    assert len(levels) == n.bit_length()
    if n == 1:
        return
    nodes = levels[1]._base
    assert nodes is not None and nodes.shape == (n - 1, 8)
    for j, level in enumerate(levels[1:], start=1):
        assert level._base is nodes
        assert level.shape == (n >> j, 8)
        assert level.storage_offset() == 8 * (n - (n >> (j - 1)))
    assert levels[-1].storage_offset() == 8 * (n - 2)


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_build_tree_matches_the_reference(n):
    """``build_tree`` and ``build_tree_fused`` on CPU tensors (the plain
    version) against the reference's fused tree, word for word; a single
    leaf is its own root and has no internal level."""
    leaves = words(30 + n, (n, 8))
    want = rm.to_host(rm.build_tree_fused(jnp.asarray(leaves)))
    for build in (pm.build_tree, pm.build_tree_fused):
        got = build(t(leaves))
        assert len(got) == len(want) == n.bit_length()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(host(g), w)
        np.testing.assert_array_equal(pm.root(got), rm.root(want))


@pytest.mark.parametrize("n", [2, 8, 64])
def test_to_host_in_one_copy_equals_a_copy_per_level(n):
    levels = pm.build_tree(t(words(40 + n, (n, 8))))
    got = pm.to_host(levels)
    want = [lv.numpy().astype(np.uint32) for lv in levels]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)


def test_to_host_refuses_levels_of_separate_buffers():
    """The one copy reads the levels through the buffer ``build_tree``
    made; levels from anywhere else are refused, not misread."""
    levels = pm.build_tree(t(words(48, (8, 8))))
    with pytest.raises(ValueError, match="one buffer"):
        pm.to_host([levels[0]] + [lv.clone() for lv in levels[1:]])
    assert len(pm.to_host(levels[:1])) == 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("state, bits", [
    ([1] * 15, 4),              # 15 words
    ([1] * 17, 4),              # 17 words
    ([1] * 15 + [P], 4),        # a word that is not canonical
    ([1] * 16, 0),
    ([1] * 16, 32),
])
def test_grind_refuses_bad_arguments(device, state, bits):
    """Refused before any search or launch, on either device (so also here,
    where there is no card)."""
    with pytest.raises(ValueError, match="16 canonical words"):
        pp.grind(state, bits, device)


def test_grind_on_a_card_is_one_entry_point_call(monkeypatch):
    """On a CUDA device ``grind`` makes one ``p2_grind`` call: the 16 words
    by value, the search range, a host word that receives the nonce.  The
    entry point is faked here (no card): it writes the nonce."""
    import ctypes

    from zkir_tpu_torch import _kernels

    calls = []

    def fake_launch(name, state, bits, start, limit, nonce):
        calls.append((name, list(state), bits, start, limit))
        ctypes.cast(nonce, ctypes.POINTER(ctypes.c_longlong))[0] = 1234

    monkeypatch.setattr(_kernels, "launch", fake_launch)
    state = [int(w) for w in words(50, 16)]
    assert pp.grind(state, 12, "cuda") == 1234
    assert calls == [("p2_grind", state, 12, 0, pp.GRIND_LIMIT)]


@pytest.mark.parametrize("bits", [0, 1, 2, 8])
def test_grind_nonce(bits):
    """Same transcript state, same lowest hitting nonce, same next draw,
    from ``Challenger.grind`` and from ``grind_plain`` on the sponge state
    it searches.  The trial batch (2^(bits+2) states) differs per case;
    the nonce does not depend on it.  (bits=1 reuses the [8, 16]
    permutation compiled above.)"""
    def transcript(cls):
        c = cls()
        c.observe_many([7, 11, bits])
        c.sample()                  # duplexes: nothing is left pending
        return c

    ref = transcript(RefChallenger)
    port = transcript(lambda: Challenger(device="cpu"))
    state = list(port._state)
    nonce = port.grind(bits)
    assert nonce == ref.grind(bits)
    if bits:
        assert nonce == pp.grind_plain(state, bits) \
            == pp.grind(state, bits, "cpu")
    assert port.sample() == ref.sample()
    assert transcript(Challenger).check_pow(nonce, bits)


@pytest.mark.parametrize("bits", [1, 16])
def test_grind_without_a_device_refuses(bits):
    """A transcript made without a device (a verifier's) checks a nonce
    but does not search for one: it names no device it was not given."""
    c = Challenger()
    c.observe_many([7, 11, bits])
    with pytest.raises(ValueError, match="device"):
        c.grind(bits)
    assert c.grind(0) == 0


def test_params_from_reference():
    external, internal, dm1 = rp._params_np()
    got = poseidon2_params_from_reference(external, internal, dm1,
                                          device="cpu")
    for g, w in zip(got, (external, internal, dm1)):
        np.testing.assert_array_equal(host(g), w)
    bad = internal.copy()
    bad[3] ^= 1
    with pytest.raises(ValueError):
        poseidon2_params_from_reference(external, bad, dm1, device="cpu")


def test_params_from_reference_needs_a_device():
    """No CPU default: the caller names the device, as for
    ``machine_state_from_reference``."""
    with pytest.raises(TypeError, match="device"):
        poseidon2_params_from_reference(*rp._params_np())
