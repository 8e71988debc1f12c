"""Multi-process orchestration.

Counterpart of ``zkir_tpu/parallel/multihost.py``.  ``initialize_multihost``
starts the ``torch.distributed`` process group from a ``tcp://``
rendezvous; the collectives of ``parallel.distributed`` then run over the
ranks of a ``make_mesh`` mesh, within a host and across hosts alike.  I/O
tapes and program loading stay local to each process (each feeds its own
lanes: ``local_lane_slice``).  ``run_local_ranks`` starts the ranks of one
host itself, a process each (``prove --mesh N``): the parent holds the
rendezvous store (``rendezvous_store``) for the whole call and the ranks
join it as clients (``join_local_group``), so the port is bound from the
moment it is chosen and no other process can take it in between.
"""

from __future__ import annotations

import datetime
from typing import Callable, Optional

import torch
import torch.distributed as dist

from .mesh import default_backend


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device="cuda") -> None:
    """Start the default process group of ``num_processes`` ranks, this
    process rank ``process_id``, meeting at ``coordinator_address``
    (``host:port``, a ``tcp://`` rendezvous; ``None``: ``env://``, torch's
    ``MASTER_ADDR``/``MASTER_PORT``/``RANK``), on ``nccl`` for a CUDA
    ``device`` and ``gloo`` for the CPU.  Does nothing when running
    single-process (``num_processes`` None or 1) or when a group is
    already initialised."""
    if num_processes in (None, 1) or dist.is_initialized():
        return
    init_method = ("env://" if coordinator_address is None
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(
        default_backend(device), init_method=init_method,
        world_size=num_processes,
        rank=-1 if process_id is None else process_id)


def process_info():
    """(process index, process count, local device count, global device
    count).

    JAX runs one process a host, driving all of that host's devices: its
    local device count is the host's, and the global mesh holds every
    process's devices.  torch runs one process a device (``make_mesh``
    gives rank r ``cuda:r % device_count``), so each process drives one
    device and the world holds as many devices as ranks.  Without a
    process group: one process of one device."""
    if not dist.is_initialized():
        return 0, 1, 1, 1
    world = dist.get_world_size()
    return dist.get_rank(), world, 1, world


def local_lane_slice(total_lanes: int):
    """The half-open lane range this process owns under even sharding —
    process-local input tapes are built for exactly these lanes."""
    rank, count, _, _ = process_info()
    per = total_lanes // count
    return rank * per, rank * per + per


# How long a rank waits for the others at the store and in collectives.
RENDEZVOUS_TIMEOUT = datetime.timedelta(minutes=10)


def rendezvous_store(timeout=RENDEZVOUS_TIMEOUT) -> dist.TCPStore:
    """The store a world of local ranks meets at: a ``TCPStore`` server on
    ``localhost`` at a port the OS picks as it binds (``store.port``).
    The caller holds it until every rank has returned; the ranks join with
    ``join_local_group(store.port, ...)``."""
    return dist.TCPStore("localhost", 0, is_master=True,
                         wait_for_workers=False, timeout=timeout)


def join_local_group(port: int, rank: int, world: int, backend: str,
                     timeout=RENDEZVOUS_TIMEOUT) -> None:
    """Start the default process group as rank ``rank`` of ``world`` on
    ``backend``, through the store another process holds at
    ``localhost:port`` (``rendezvous_store``), joined as a client."""
    store = dist.TCPStore("localhost", port, is_master=False,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=timeout)


def _local_rank(rank: int, fn: Callable, world: int, port: int, device: str,
                threads: int, args: tuple) -> None:
    """One rank of ``run_local_ranks``: its process group, then ``fn``."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(threads)
    join_local_group(port, rank, world, default_backend(device))
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_local_ranks(fn: Callable, n: int, *args, device="cuda") -> None:
    """Start ``n`` ranks on this host, a process each (``spawn``), in one
    process group (through a ``rendezvous_store`` held here; NCCL
    with rank r on ``cuda:r``, or gloo for ``device="cpu"``), and run
    ``fn(*args)`` on each; ``fn`` and ``args`` must pickle.  Returns when
    every rank has returned.  If a rank fails, the others are stopped and
    this raises ``torch.multiprocessing.ProcessRaisedException`` (or
    ``ProcessExitedException``) with the failed rank's traceback.  On
    ``cuda`` every rank needs its own card: ``n`` above
    ``torch.cuda.device_count()`` raises ``ValueError`` before any start
    (NCCL puts no two ranks on one card).  CPU ranks share this process's
    torch threads."""
    import torch.multiprocessing as mp

    if n < 1:
        raise ValueError(f"requested {n} devices")
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "run_local_ranks: device cuda needs an NVIDIA GPU and "
                "torch.cuda.is_available() is false")
        available = torch.cuda.device_count()
        if n > available:
            raise ValueError(f"requested {n} devices, only {available} "
                             "available")
    threads = max(1, torch.get_num_threads() // n)
    store = rendezvous_store()   # held until every rank has returned
    mp.start_processes(_local_rank, args=(fn, n, store.port, str(device),
                                          threads, args),
                       nprocs=n, join=True, start_method="spawn")
