"""The port's ``zkir_tpu_torch.parallel`` on gloo CPU ranks, tolerance 0.

One spawn of 4 ranks (``make_mesh(4, device="cpu")``) and one of 2 ranks
(started through ``initialize_multihost``) run every distributed function
on seeded inputs; a world of one rank runs in this process.  Each rank
saves its results; the tests hold them, word for word, against the JAX
reference on the conftest's virtual CPU mesh (``zkir_tpu.parallel`` on
``make_mesh(4)`` or ``make_mesh(2)``) and against the port's
single-device functions.  The cases are the reference tests' own
(``tests/test_parallel.py``).  Refusals: a mesh that is not a power of
two, a domain too small for the mesh, more ranks than the world has,
``make_mesh`` on ``cuda`` without CUDA.
"""

import dataclasses
import pathlib
import re
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from zkir_tpu_torch import parallel as par
from zkir_tpu_torch.asm import assemble
from zkir_tpu_torch.interp import HALT_EXIT, InterpConfig, TpuInterpreter
from zkir_tpu_torch.ops import merkle, ntt
from zkir_tpu_torch.spec import Instruction, Op, Program
from zkir_tpu_torch.tools.mesh_bench import single_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = (1 << 31) - 1
FIB = [0, 1, 1, 2, 3, 5, 8, 13]
SPAWN_SECONDS = 240


def _words(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.int64)


def _inputs():
    """Seeded inputs: the NTT vectors (log_n 8, 10, 12; 8 with a zero
    imaginary part), the Merkle matrices [64, 6] and [16, 3], the LDE
    columns [16, 2^6] (blowup 2) and [4, 2^5] (blowup 1, coset shift)."""
    rng = np.random.default_rng(55)
    cases = {f"ntt{k}": (_words(rng, 1 << k), _words(rng, 1 << k))
             for k in (8, 10, 12)}
    cases["ntt8 real"] = (_words(rng, 1 << 8), np.zeros(1 << 8, np.int64))
    cases["merkle [64, 6]"] = _words(rng, (64, 6))
    cases["merkle [16, 3]"] = _words(rng, (16, 3))
    cases["lde [16, 2^6]"] = _words(rng, (16, 1 << 6))
    cases["lde [4, 2^5] shift"] = _words(rng, (4, 1 << 5))
    return cases


# What each world runs: the reference tests' cases (4 ranks: the 8-device
# ones; 2 ranks: the 2-device ones); one rank runs all of them.
WORLD_CASES = {
    4: ("ntt8", "ntt10", "ntt12", "merkle [64, 6]", "lde [16, 2^6]",
        "fib", "step"),
    2: ("ntt8 real", "merkle [16, 3]", "lde [4, 2^5] shift", "step",
        "multihost"),
}
WORLD_CASES[1] = tuple(dict.fromkeys(WORLD_CASES[4] + WORLD_CASES[2]))


def _fib_interp(lanes=8, device="cpu"):
    program = assemble((ROOT / "examples" / "fibonacci.zkasm").read_text())
    return TpuInterpreter(program, InterpConfig(lanes=lanes, chunk=64),
                          device=device)


def _loop_interp(lanes=8, device="cpu"):
    program = Program.from_instructions([
        Instruction(Op.ADDI, rd=1, rs1=0, imm=7),
        Instruction(Op.ADD, rd=2, rs1=2, rs2=1),
        Instruction(Op.JAL, rd=0, imm=-4),
    ])
    return TpuInterpreter(program, InterpConfig(lanes=lanes, chunk=32),
                          device=device)


def _lde_args(name):
    return ((6, 2, (1, 0)) if name == "lde [16, 2^6]"
            else (5, 1, ntt._find_generator()))


def _run_cases(mesh, names, inputs):
    """Every case of ``names`` on this rank: numpy results by name."""
    d, r = mesh.size(), mesh.index
    out = {}
    for name in names:
        if name.startswith("ntt"):
            re, im = (torch.from_numpy(a) for a in inputs[name])
            log_n = re.numel().bit_length() - 1
            rows = par.dist_ntt(re, im, mesh, log_n)
            nat = par.dist_ntt_natural(re, im, mesh, log_n)
            out[name] = {"rows": [t.numpy() for t in rows],
                         "natural": [t.numpy() for t in nat]}
        elif name.startswith("merkle"):
            m = torch.from_numpy(inputs[name])
            k = m.shape[0] // d
            out[name] = par.dist_merkle_root(m[r * k:(r + 1) * k],
                                             mesh).numpy()
        elif name.startswith("lde"):
            cols = torch.from_numpy(inputs[name])
            log_n, log_blowup, shift = _lde_args(name)
            out[name] = [t.numpy() for t in par.dist_lde(
                cols, torch.zeros_like(cols), mesh, log_n, log_blowup,
                shift=shift)]
        elif name == "fib":
            interp = _fib_interp()
            state = interp.init_state([[n] for n in range(8)])
            state = par.sharded_interpreter_state(state, mesh)
            local = interp.with_lanes(8 // d)
            for _ in range(4):
                state, _ = local.chunk_fn(state)
            out[name] = {"halted": state.halted.numpy(),
                         "outputs": state.outputs[:, 0].numpy()}
        elif name == "step":
            interp = _loop_interp()
            state = par.sharded_interpreter_state(
                interp.init_state([[] for _ in range(8)]), mesh)
            new_state, root = par.prove_step_sharded(interp, state, mesh,
                                                     log_n=10)
            out[name] = {"root": root.numpy(),
                         "cycles": new_state.cycles.numpy(),
                         "regs": new_state.regs.numpy()}
        elif name == "multihost":
            x = torch.tensor([2 ** r], dtype=torch.int64)
            dist.all_reduce(x, group=mesh.group)
            out[name] = {"sum": int(x), "info": par.process_info(),
                         "lanes": par.local_lane_slice(64)}
    if d > 1:
        # A domain too small for the mesh: log_n1 = log D - 1.
        log_n = 2 * (d.bit_length() - 1) - 1
        x = torch.zeros(1 << log_n, dtype=torch.int64)
        try:
            par.dist_ntt(x, x, mesh, log_n)
        except ValueError as e:
            out["too small"] = str(e)
    return out


def _rank_main(rank, world, port, inputs, out_dir):
    torch.set_num_threads(1)
    if world == 2:
        # initialize_multihost as a user calls it, rank 0 hosting the store
        # at the address: rank 0 binds its port first, in a store of its
        # own that its group's store then shares (multi_tenant), and hands
        # the address over through the parent's store.
        parent = dist.TCPStore("localhost", port, is_master=False)
        if rank == 0:
            own = dist.TCPStore("localhost", 0, is_master=True,
                                wait_for_workers=False, multi_tenant=True)
            parent.set("address", f"localhost:{own.port}")
        par.initialize_multihost(parent.get("address").decode(), world,
                                 rank, device="cpu")
    else:
        par.join_local_group(port, rank, world, "gloo")
    try:
        mesh = par.make_mesh(world, device="cpu")
        torch.save(_run_cases(mesh, WORLD_CASES[world], inputs),
                   pathlib.Path(out_dir) / f"w{world}r{rank}.pt")
    finally:
        dist.destroy_process_group()


# The reference's cases in four groups of about equal cost, one process
# each: tracing the reference's Poseidon2 inside shard_map takes most of
# its time, and one process would run them one after another.
REFERENCE_GROUPS = (
    ((4, "ntt8"), (4, "ntt10"), (4, "ntt12"), (2, "ntt8 real"),
     (4, "lde [16, 2^6]"), (2, "lde [4, 2^5] shift"), (4, "fib")),
    ((4, "merkle [64, 6]"),),
    ((2, "merkle [16, 3]"),),
    ((4, "step"),),
)


def _reference(cases, inputs):
    """The JAX package's results for ``cases`` ((world, name) pairs) on
    its virtual CPU mesh of ``world`` devices."""
    import jax.numpy as jnp

    from zkir_tpu import parallel as ref
    from zkir_tpu.interp import InterpConfig as RefConfig
    from zkir_tpu.interp import TpuInterpreter as RefInterpreter
    from zkir_tpu.spec import Program as RefProgram

    out = {}
    for world, name in cases:
        mesh = ref.make_mesh(world)
        v = inputs.get(name)
        if name.startswith("ntt"):
            re, im = (jnp.asarray(a.astype(np.uint32)) for a in v)
            zr, zi = ref.dist_ntt(re, im, mesh, re.size.bit_length() - 1)
            out[name] = [np.asarray(zr), np.asarray(zi)]
        elif name.startswith("merkle"):
            out[name] = np.asarray(ref.dist_merkle_root(
                jnp.asarray(v.astype(np.uint32)), mesh))
        elif name.startswith("lde"):
            cols = jnp.asarray(v.astype(np.uint32))
            log_n, log_blowup, shift = _lde_args(name)
            out[name] = [np.asarray(a) for a in ref.dist_lde(
                cols, jnp.zeros_like(cols), mesh, log_n, log_blowup,
                shift=shift)]
        else:
            port = _fib_interp() if name == "fib" else _loop_interp()
            interp = RefInterpreter(
                RefProgram.from_bytes(port.program.to_bytes()),
                RefConfig(lanes=8, chunk=port.config.chunk))
            state = ref.sharded_interpreter_state(interp.init_state(
                [[n] for n in range(8)] if name == "fib"
                else [[] for _ in range(8)]), mesh)
            if name == "fib":
                n_words = jnp.int32(interp.n_words)
                for _ in range(4):
                    state, _ = interp._chunk_fn(interp.code, n_words, state)
                outputs = (np.asarray(state.outputs_lo).astype(np.uint64)
                           | (np.asarray(state.outputs_hi).astype(np.uint64)
                              << np.uint64(32)))
                out[name] = {"halted": np.asarray(state.halted),
                             "outputs": outputs[:, 0]}
            else:
                new_state, root = ref.prove_step_sharded(interp, state,
                                                         mesh, log_n=10)
                out[name] = {"root": np.asarray(root),
                             "cycles": np.asarray(new_state.cycles),
                             "regs_lo": np.asarray(new_state.regs_lo)}
    return out


def _reference_main(index, inputs, out_dir):
    import conftest  # noqa: F401  (the virtual 8-device CPU platform)

    torch.save(_reference(REFERENCE_GROUPS[index], inputs),
               pathlib.Path(out_dir) / f"ref{index}.pt")


def _single(inputs):
    """The port's single-device results (CPU)."""
    out = {}
    for name, v in inputs.items():
        if name.startswith("ntt"):
            re, im = (torch.from_numpy(a) for a in v)
            log_n = re.numel().bit_length() - 1
            zr, zi = ntt.ntt(re, im, log_n)
            n1 = 1 << (log_n // 2)
            out[name] = {"natural": [zr.numpy(), zi.numpy()],
                         "Z": [t.reshape(-1, n1).T.numpy() for t in (zr, zi)]}
        elif name.startswith("merkle"):
            out[name] = merkle.root(merkle.build_tree(
                merkle.hash_rows(torch.from_numpy(v))))
        elif name.startswith("lde"):
            cols = torch.from_numpy(v)
            log_n, log_blowup, shift = _lde_args(name)
            out[name] = [t.numpy() for t in ntt.lde(
                cols, torch.zeros_like(cols), log_n, log_blowup,
                shift=shift)]
    interp = _fib_interp()
    state = interp.init_state([[n] for n in range(8)])
    for _ in range(4):
        state, _ = interp.chunk_fn(state)
    out["fib"] = {"halted": state.halted.numpy(),
                  "outputs": state.outputs[:, 0].numpy()}
    # prove_step_sharded's composition on one device.
    interp = _loop_interp()
    state, root = single_step(interp, interp.init_state([[]] * 8), 10)
    out["step"] = {"root": root.numpy(), "cycles": state.cycles.numpy(),
                   "regs": state.regs.numpy()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns of ranks and the reference's processes started
    together; the single-device results and the one-rank world computed
    here while they run; then every rank's results, by world and rank."""
    out_dir = tmp_path_factory.mktemp("ranks")
    inputs = _inputs()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    # Each world's store is held here until its ranks have finished.
    stores = {world: par.rendezvous_store() for world in (4, 2)}
    contexts = [mp.start_processes(
        _rank_main, args=(world, stores[world].port, inputs, str(out_dir)),
        nprocs=world, join=False, start_method="spawn") for world in (4, 2)]
    contexts.append(mp.start_processes(
        _reference_main, args=(inputs, str(out_dir)),
        nprocs=len(REFERENCE_GROUPS), join=False, start_method="spawn"))
    try:
        single = _single(inputs)
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            one = _run_cases(par.make_mesh(device="cpu"), WORLD_CASES[1],
                             inputs)
        finally:
            dist.destroy_process_group()
        deadline = time.monotonic() + SPAWN_SECONDS
        for ctx in contexts:
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    pytest.fail("the spawned processes did not finish in "
                                "time")
    finally:
        torch.set_num_threads(n)
        for ctx in contexts:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()

    def load(name):
        return torch.load(out_dir / name, weights_only=False)

    ranks = {world: [load(f"w{world}r{r}.pt") for r in range(world)]
             for world in (4, 2)}
    ranks[1] = [one]
    reference = {}
    for i in range(len(REFERENCE_GROUPS)):
        reference.update(load(f"ref{i}.pt"))
    return {"ranks": ranks, "reference": reference, "single": single}


def _cases(kind):
    return [pytest.param(world, name, id=f"{world}-{name}")
            for world in (4, 2, 1) for name in WORLD_CASES[world]
            if name.startswith(kind)]


@pytest.mark.parametrize("world, name", _cases("ntt"))
def test_dist_ntt(runs, world, name):
    """Rank r's rows of Z are rows r*n1/D .. of the single-device NTT's Z
    and of the reference's; the gathered natural order on every rank is
    the single-device NTT's."""
    ref = runs["reference"][name]
    single = runs["single"][name]
    for r, got in enumerate(runs["ranks"][world]):
        for part in range(2):
            rows = got[name]["rows"][part]
            k = rows.shape[0]
            np.testing.assert_array_equal(
                rows, single["Z"][part][r * k:(r + 1) * k])
            np.testing.assert_array_equal(
                rows, ref[part][r * k:(r + 1) * k].astype(np.int64))
            np.testing.assert_array_equal(got[name]["natural"][part],
                                          single["natural"][part])
            np.testing.assert_array_equal(
                got[name]["natural"][part],
                ref[part].T.reshape(-1).astype(np.int64))


@pytest.mark.parametrize("world, name", _cases("merkle"))
def test_dist_merkle_root(runs, world, name):
    for got in runs["ranks"][world]:
        np.testing.assert_array_equal(got[name], runs["single"][name])
        np.testing.assert_array_equal(got[name], runs["reference"][name])


@pytest.mark.parametrize("world, name", _cases("lde"))
def test_dist_lde(runs, world, name):
    """The ranks' blocks in rank order are the single-device LDE and the
    reference's."""
    for part in range(2):
        got = np.concatenate([g[name][part] for g in runs["ranks"][world]])
        np.testing.assert_array_equal(got, runs["single"][name][part])
        np.testing.assert_array_equal(
            got, runs["reference"][name][part].astype(np.int64))


@pytest.mark.parametrize("world", [4, 1])
def test_sharded_interpreter_state(runs, world):
    """The fibonacci lanes, sharded, run 4 chunks of 64 on their own
    interpreters: every lane halts by EXIT with fib(lane) on its tape, as
    on one device and in the reference."""
    got = {k: np.concatenate([g["fib"][k] for g in runs["ranks"][world]])
           for k in ("halted", "outputs")}
    assert (got["halted"] == HALT_EXIT).all()
    assert got["outputs"].tolist() == FIB
    for k in ("halted", "outputs"):
        np.testing.assert_array_equal(got[k], runs["single"]["fib"][k])
    np.testing.assert_array_equal(got["halted"],
                                  runs["reference"]["fib"]["halted"])
    np.testing.assert_array_equal(
        got["outputs"], runs["reference"]["fib"]["outputs"].astype(np.int64))


@pytest.mark.parametrize("world", [4, 2, 1])
def test_prove_step_sharded(runs, world):
    """The ADDI/ADD/JAL loop, 8 lanes, a chunk of 32, log_n 10: the root
    on every rank is the single-device composition's and the reference's;
    the lanes ran 32 cycles and their registers are one device's."""
    ref = runs["reference"]["step"]
    single = runs["single"]["step"]
    for got in runs["ranks"][world]:
        np.testing.assert_array_equal(got["step"]["root"], single["root"])
        np.testing.assert_array_equal(got["step"]["root"], ref["root"])
    regs = np.concatenate([g["step"]["regs"] for g in runs["ranks"][world]])
    cycles = np.concatenate([g["step"]["cycles"]
                             for g in runs["ranks"][world]])
    assert (cycles == 32).all()
    np.testing.assert_array_equal(regs, single["regs"])
    np.testing.assert_array_equal(regs & 0xFFFFFFFF,
                                  ref["regs_lo"].astype(np.int64))
    np.testing.assert_array_equal(cycles, ref["cycles"].astype(np.int64))


def test_multihost(runs):
    """Two ranks started by initialize_multihost: the sum of 2^rank over
    the mesh is 3, and each owns its half of 64 lanes."""
    for rank, got in enumerate(runs["ranks"][2]):
        assert got["multihost"]["sum"] == 3
        assert got["multihost"]["info"] == (rank, 2, 1, 2)
        assert got["multihost"]["lanes"] == (32 * rank, 32 * rank + 32)


def test_domain_too_small(runs):
    for got in runs["ranks"][4] + runs["ranks"][2]:
        assert "too small" in got["too small"]


# Choosing a port by binding port 0, reading its number and closing the
# socket, to bind it again later: any process can take the port in
# between.  (The patterns are split so that this file does not match.)
PORT_RACE = re.compile(r"getsock" r"name\(|free_" r"port\b|"
                       r"\.bind\(\(\s*['\"][^'\"]*['\"]\s*,\s*0\s*\)\)")


def test_no_port_is_chosen_before_it_is_bound():
    """Every local rendezvous of the port, its tests and chip_smoke.py
    goes through a store that holds its port from the moment the OS picks
    it (``parallel.rendezvous_store``), or needs no socket
    (``dist.HashStore``)."""
    root = pathlib.Path(__file__).resolve().parent.parent
    files = [*sorted((root / "zkir_tpu_torch").rglob("*.py")),
             *sorted((root / "tests").glob("test_torch_*.py")),
             root / "chip_smoke.py"]
    found = [f"{f.relative_to(root)}:{n}" for f in files
             for n, line in enumerate(f.read_text().splitlines(), 1)
             if PORT_RACE.search(line)]
    assert not found, found


@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_refusals(world_of_one):
    with pytest.raises(ValueError, match="only 1 available"):
        par.make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            par.make_mesh(1)
    mesh = par.make_mesh(device="cpu")
    three = dataclasses.replace(mesh, ranks=(0, 1, 2))
    x = torch.zeros(1 << 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="power of two"):
        par.dist_ntt(x, x, three, 8)
    with pytest.raises(ValueError, match="do not divide"):
        par.dist_lde(torch.zeros((3, 8), dtype=torch.int64), None,
                     dataclasses.replace(mesh, ranks=(0, 1)), 3, 1)
    with pytest.raises(ValueError, match="a shard of 4 lanes"):
        par.prove_step_sharded(_loop_interp(),
                               _loop_interp(4).init_state([[]] * 4), mesh)


def test_no_group():
    """make_mesh starts no process group of its own, and the multi-host
    start does nothing for one process."""
    par.initialize_multihost()
    par.initialize_multihost("localhost:1", 1, 0)
    assert not dist.is_initialized()
    assert par.process_info() == (0, 1, 1, 1)
    with pytest.raises(RuntimeError, match="initialised process group"):
        par.make_mesh(device="cpu")
