"""Mesh construction over a ``torch.distributed`` process group.

Counterpart of ``zkir_tpu/parallel/mesh.py``.  A JAX mesh is an array of
devices that one program drives; here every rank is a process that drives
one device (``cuda:rank % device_count``, or the CPU), and the mesh names
the process group its collectives run on.  The group must exist already
(``multihost.initialize_multihost`` or ``init_process_group``): nothing
here starts one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the global ranks ``ranks`` in axis order, the process
    group of their collectives, this process's place on the axis
    (``index``, ``None`` on a rank outside the mesh) and its device."""

    axis_names: Tuple[str, ...]
    group: Optional[dist.ProcessGroup]
    ranks: Tuple[int, ...]
    index: Optional[int]
    device: torch.device

    def size(self) -> int:
        return len(self.ranks)


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(n_devices: Optional[int] = None, axis: str = "d", *,
              device="cuda", backend: Optional[str] = None) -> Mesh:
    """1-D mesh named ``axis`` over the first ``n_devices`` ranks of the
    initialised process group (default all).

    Every rank of the group must call it (a mesh of fewer ranks makes a
    new group, which is collective).  Rank r's device is ``cuda:r %
    torch.cuda.device_count()``, made the current CUDA device (the
    kernels launch on the current device's stream), or the CPU for
    ``device="cpu"``.  The collectives run on ``backend``: ``nccl`` on
    CUDA and ``gloo`` on the CPU unless another is named; a group of
    another backend than the default group's is made for the mesh."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: device cuda needs an NVIDIA GPU and "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "the kernels' plain versions on gloo ranks")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: call "
            "initialize_multihost or torch.distributed.init_process_group "
            "first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is None:
        n_devices = world
    if not 0 < n_devices <= world:
        raise ValueError(f"requested {n_devices} devices, only {world} "
                         "available")
    backend = backend or default_backend(kind)
    ranks = tuple(range(n_devices))
    if n_devices == world and backend == dist.get_backend():
        group = dist.group.WORLD
    else:
        group = dist.new_group(ranks=list(ranks), backend=backend)
    if kind == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(kind)
    return Mesh(axis_names=(axis,), group=group, ranks=ranks,
                index=rank if rank < n_devices else None, device=dev)
