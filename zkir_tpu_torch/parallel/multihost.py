"""Multi-process orchestration.

Counterpart of ``zkir_tpu/parallel/multihost.py``.  ``initialize_multihost``
starts the ``torch.distributed`` process group from a ``tcp://``
rendezvous; the collectives of ``parallel.distributed`` then run over the
ranks of a ``make_mesh`` mesh, within a host and across hosts alike.  I/O
tapes and program loading stay local to each process (each feeds its own
lanes: ``local_lane_slice``).
"""

from __future__ import annotations

from typing import Optional

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
