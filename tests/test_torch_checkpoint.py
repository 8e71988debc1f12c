"""Prover-stage checkpoints of the port (``prove_trace(checkpoint_dir=)``),
as ``tests/test_prover_checkpoint.py`` holds the reference's: a prove
killed after any stage resumes past the completed stages and emits the
unbroken proof, word for word; a torn stage file is recomputed; another
matrix or configuration does not reuse the files.  All on the CPU,
tolerance 0.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import zkir_tpu_torch.prover.prover as PP
from zkir_tpu_torch.convert import proof_to_json
from zkir_tpu_torch.interp import InterpConfig, TpuInterpreter
from zkir_tpu_torch.prover import (FriConfig, prove_trace, trace_to_matrix,
                                   verify_trace)
from zkir_tpu_torch.spec import Instruction, Op, Program

CFG = FriConfig(num_queries=4, grinding_bits=2, min_security=0)
STAGES = ["commit", "sums", "quotient", "fri"]


@pytest.fixture(scope="module", autouse=True)
def _small_torch_pool():
    """The suite runs several pytest workers on one machine; a torch
    intra-op thread per core in each of them would oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def matrix():
    program = Program.from_instructions([
        Instruction(Op.ADDI, rd=1, rs1=0, imm=7),
        Instruction(Op.ADD, rd=2, rs1=2, rs2=1),
        Instruction(Op.SW, rs1=0, rs2=2, imm=0x3000),
        Instruction(Op.LW, rd=3, rs1=0, imm=0x3000),
        Instruction(Op.EBREAK),
    ])
    interp = TpuInterpreter(program, InterpConfig(
        lanes=1, chunk=16, collect_trace=True), device="cpu")
    return trace_to_matrix(interp.run([[]], max_cycles=16)["trace"])


def prove(matrix, **kwargs):
    return prove_trace(matrix, CFG, range_lookup=True, device="cpu", **kwargs)


@pytest.fixture(scope="module")
def baseline(matrix):
    """The unbroken proof, without checkpoints."""
    return proof_to_json(prove(matrix))


class Killed(BaseException):
    """Stands for the process dying: no ``except Exception`` catches it."""


@pytest.mark.parametrize("last", STAGES)
def test_resume_after_kill_is_bit_identical(matrix, baseline, tmp_path,
                                            monkeypatch, last):
    """The first attempt dies right after stage ``last`` persisted; the
    rerun recomputes only the later stages."""
    real_save = PP._StageStore.save

    def save_then_die(self, stage, obj):
        real_save(self, stage, obj)
        if stage == last:
            raise Killed(stage)

    monkeypatch.setattr(PP._StageStore, "save", save_then_die)
    with pytest.raises(Killed):
        prove(matrix, checkpoint_dir=str(tmp_path))
    monkeypatch.setattr(PP._StageStore, "save", real_save)
    done = STAGES[:STAGES.index(last) + 1]
    assert sorted(p.name.split(".")[-2] for p in tmp_path.iterdir()) \
        == sorted(done)

    calls = {"lde": 0, "quotient_evals": 0, "fri_prove": 0}
    for name in calls:
        def counting(*a, _real=getattr(PP, name), _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(PP, name, counting)
    resumed = prove(matrix, checkpoint_dir=str(tmp_path))
    assert calls == {
        "lde": ("commit" not in done) + ("sums" not in done),
        "quotient_evals": int("quotient" not in done),
        "fri_prove": int("fri" not in done)}
    assert proof_to_json(resumed) == baseline
    if last == "fri":
        assert verify_trace(resumed, device="cpu")


@pytest.fixture(scope="module")
def stored(matrix, tmp_path_factory):
    """A directory holding all four stages of one checkpointed prove, and
    that prove's proof."""
    directory = tmp_path_factory.mktemp("stages")
    return directory, prove(matrix, checkpoint_dir=str(directory))


def test_checkpointed_prove_matches_plain_and_binds_its_inputs(
        matrix, baseline, stored, tmp_path):
    directory, first = stored
    shutil.copytree(directory, tmp_path, dirs_exist_ok=True)
    again = prove(matrix, checkpoint_dir=str(tmp_path))
    assert proof_to_json(first) == proof_to_json(again) == baseline
    files = sorted(p.name for p in tmp_path.iterdir())
    assert [f.split(".")[-2] for f in files] == sorted(STAGES)

    # Another trace, configuration, flag or program has another key.
    other = matrix.copy()
    other[0, 8 + 1] ^= 1
    key = PP._StageStore(str(tmp_path), matrix, CFG, True, None).key
    assert files[0].startswith(key)
    program = Program.from_instructions([Instruction(Op.EBREAK)])
    for args in ((other, CFG, True, None),
                 (matrix, FriConfig(num_queries=5, grinding_bits=2,
                                    min_security=0), True, None),
                 (matrix, CFG, False, None),
                 (matrix, CFG, True, program)):
        store = PP._StageStore(str(tmp_path), *args)
        assert store.key != key
        assert store.load("commit") is None
    assert sorted(p.name for p in tmp_path.iterdir()) == files


def test_corrupt_stage_is_recomputed(matrix, baseline, stored, tmp_path):
    shutil.copytree(stored[0], tmp_path, dirs_exist_ok=True)
    for p in tmp_path.iterdir():
        p.write_bytes(p.read_bytes()[:100] if "quotient" in p.name
                      else b"torn write garbage")
    redo = prove(matrix, checkpoint_dir=str(tmp_path))
    assert proof_to_json(redo) == baseline
    # The recomputed stages replaced the torn files.
    store = PP._StageStore(str(tmp_path), matrix, CFG, True, None)
    for stage in STAGES:
        assert store.load(stage) is not None


def test_stored_tensors_are_host_words(matrix, stored):
    """Device tensors are stored as numpy uint32; the FRI stage is the
    proof's own dict."""
    directory, proof = stored
    store = PP._StageStore(str(directory), matrix, CFG, True, None)
    commit = store.load("commit")
    assert commit["ext_r"].dtype == np.uint32
    assert commit["ext_r"].shape == (proof["n_cols"], 1 << 12)
    assert isinstance(commit["levels1"], list)
    assert json.loads(proof_to_json({"fri": store.load("fri")})) \
        == json.loads(proof_to_json({"fri": proof["fri"]}))
