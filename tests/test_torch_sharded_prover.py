"""The port's sharded prover on gloo CPU ranks, tolerance 0.

``prove_trace(mesh=)`` and ``prove_trace_streaming(mesh=)`` run SPMD: every
rank of a ``make_mesh(D, device="cpu")`` mesh proves the same matrix.  One
spawn of 4 ranks and one of 2 (both through ``run_local_ranks``) run while
a world of one rank runs in this process.  Each rank proves golden B
one-shot (493 columns: every rank's block padded with zero columns on 2 and
4 ranks), golden E with its program bound and a checkpoint directory, then
again from rank 0's stage files, and golden C by streaming with
``col_block=6`` (on 4 ranks every block padded).  Each proof, after a JSON
round trip, must equal the stored reference proof (the reference's own
single-device ``prove_trace``; its ``tests/test_sharded_prover.py`` holds
its sharded proof equal to that).  Also ``cols_to_rows`` against a plain
slice of the whole matrix, and the refusals: a mesh that is not a power of
two, one larger than the rows, a ``device`` that is not the mesh's, and a
mesh on ``cuda`` without a GPU; and a rank that fails stops the others.
"""

import concurrent.futures
import json
import pathlib
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from zkir_tpu_torch import parallel as par
from zkir_tpu_torch.convert import fixture_from_reference, proof_to_json
from zkir_tpu_torch.parallel.mesh import Mesh
from zkir_tpu_torch.prover import prove_trace
from zkir_tpu_torch.prover import prover as prover_mod
from zkir_tpu_torch.prover.streaming import prove_trace_streaming

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
P = (1 << 31) - 1
WORLDS = (4, 2, 1)
CASES = ("b", "e", "e resumed", "c streaming")
RESHARD_SHAPE = (8, 64)         # [C, M]: C and M divide over 1, 2 and 4


def _reshard_matrix():
    return torch.from_numpy(np.random.default_rng(15).integers(
        0, P, RESHARD_SHAPE, dtype=np.int64))


def _spy_stages():
    """Count this process's stage-file writes and the stages it loaded."""
    counts = {"saved": 0, "loaded": 0}
    save, load = prover_mod._StageStore.save, prover_mod._StageStore.load

    def saving(self, stage, obj):
        counts["saved"] += 1
        return save(self, stage, obj)

    def loading(self, stage):
        got = load(self, stage)
        counts["loaded"] += got is not None
        return got

    prover_mod._StageStore.save = saving
    prover_mod._StageStore.load = loading
    return counts, (save, load)


def _rank_cases(world: int, ckpt_dir: str, out_dir: str) -> None:
    """Every case on this rank of a ``world``-rank gloo group: the proofs'
    JSON, the stage files' counts and the reshard, saved under
    ``out_dir``."""
    mesh = par.make_mesh(world, device="cpu")
    rank = mesh.index
    out = {}
    whole = _reshard_matrix()
    c = whole.shape[0]
    out["reshard"] = par.cols_to_rows(
        whole[rank * c // world:(rank + 1) * c // world], mesh).numpy()

    fx = fixture_from_reference(FIXTURES, "golden_b")
    out["b"] = proof_to_json(prove_trace(fx["matrix"], fx["config"],
                                         mesh=mesh, device="cpu"))
    fx = fixture_from_reference(FIXTURES, "golden_e")
    counts, real = _spy_stages()
    try:
        for case in ("e", "e resumed"):
            before = dict(counts)
            out[case] = proof_to_json(prove_trace(
                fx["matrix"], fx["config"], mesh=mesh, range_lookup=True,
                program=fx["program"], checkpoint_dir=ckpt_dir,
                device="cpu"))
            out[f"{case} stages"] = {k: counts[k] - before[k]
                                     for k in counts}
            dist.barrier(group=mesh.group)
            out[f"{case} files"] = sorted(
                f.name.split(".")[1] for f in pathlib.Path(ckpt_dir).iterdir())
    finally:
        prover_mod._StageStore.save, prover_mod._StageStore.load = real
    fx = fixture_from_reference(FIXTURES, "golden_c")
    out["c streaming"] = proof_to_json(prove_trace_streaming(
        fx["matrix"], fx["config"], program=fx["program"], col_block=6,
        mesh=mesh, device="cpu"))
    torch.save(out, pathlib.Path(out_dir) / f"w{world}r{rank}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both spawns started together (a thread each waits on its ranks),
    the world of one run here meanwhile; every rank's results by world."""
    out_dir = tmp_path_factory.mktemp("ranks")
    ckpt = {w: tmp_path_factory.mktemp(f"ckpt{w}") for w in WORLDS}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            spawns = [pool.submit(par.run_local_ranks, _rank_cases, world,
                                  world, str(ckpt[world]), str(out_dir),
                                  device="cpu")
                      for world in (4, 2)]
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
            try:
                _rank_cases(1, str(ckpt[1]), str(out_dir))
            finally:
                dist.destroy_process_group()
            for spawn in spawns:
                spawn.result(timeout=300)
    finally:
        torch.set_num_threads(n)
    return {world: [torch.load(out_dir / f"w{world}r{r}.pt",
                               weights_only=False) for r in range(world)]
            for world in WORLDS}


def _want(name):
    return json.loads((FIXTURES / f"golden_{name}.proof.json").read_text())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_proof_equals_reference(ranks, world, case):
    """Every rank's proof is the stored reference proof, word for word."""
    want = _want(case[0])
    for rank, got in enumerate(ranks[world]):
        assert json.loads(got[case]) == want, (world, rank, case)


@pytest.mark.parametrize("world", WORLDS)
def test_only_rank_zero_writes_stage_files(ranks, world):
    """The first checkpointed prove: rank 0 writes the four stage files,
    the other ranks none; the second: every rank loads all four, none
    writes, and the directory holds the same four files."""
    stages = ["commit", "fri", "quotient", "sums"]
    for rank, got in enumerate(ranks[world]):
        assert got["e stages"] == {"saved": 4 if rank == 0 else 0,
                                   "loaded": 0}, (world, rank)
        assert got["e resumed stages"] == {"saved": 0, "loaded": 4}
        assert got["e files"] == got["e resumed files"] == stages


@pytest.mark.parametrize("world", WORLDS)
def test_cols_to_rows_is_a_slice_of_the_whole(ranks, world):
    """Rank r's reshard of its block of columns is rows r*M/D .. of the
    whole matrix's transpose, every column in order."""
    whole = _reshard_matrix().numpy().T                   # [M, C]
    m = whole.shape[0]
    for rank, got in enumerate(ranks[world]):
        np.testing.assert_array_equal(
            got["reshard"], whole[rank * m // world:(rank + 1) * m // world])


def _fake_mesh(size, device="cpu"):
    """A mesh object of ``size`` ranks with no process group: the provers
    refuse it before any collective."""
    return Mesh(axis_names=("d",), group=None, ranks=tuple(range(size)),
                index=0, device=torch.device(device))


def _prove(kind, mesh, device="cpu"):
    if kind == "one-shot":
        fx = fixture_from_reference(FIXTURES, "golden_b")
        return prove_trace(fx["matrix"], fx["config"], mesh=mesh,
                           device=device)
    fx = fixture_from_reference(FIXTURES, "golden_c")
    return prove_trace_streaming(fx["matrix"], fx["config"], mesh=mesh,
                                 device=device)


@pytest.mark.parametrize("kind", ["one-shot", "streaming"])
@pytest.mark.parametrize("size, device, match", [
    (3, "cpu", "power of two"),
    (2048, "cpu", "does not divide the trace's"),
    (2, "cuda", "not this rank's mesh device cpu"),
    (2, "cpu:1", "not this rank's mesh device cpu")])
def test_refused_meshes(kind, size, device, match):
    with pytest.raises(ValueError, match=match):
        _prove(kind, _fake_mesh(size), device)


def test_cuda_mesh_needs_a_gpu():
    """Without a GPU neither a mesh nor local ranks on ``cuda`` start;
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        par.make_mesh(1, device="cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        par.run_local_ranks(_rank_cases, 2, device="cuda")


def _fail_on_rank_one():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(600)             # rank 0 waits on, for a rank that is gone


def test_a_failing_rank_stops_every_rank():
    """``run_local_ranks`` raises with the failed rank's traceback and
    stops the rank still running: no rank is dropped quietly, and nothing
    waits for it."""
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException,
                       match="rank 1 fails on purpose"):
        par.run_local_ranks(_fail_on_rank_one, 2, device="cpu")
    assert time.monotonic() - t0 < 120
