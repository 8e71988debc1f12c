"""Multi-device parallelism on ``torch.distributed``: meshes, distributed
kernels, multi-process start.

Counterpart of ``zkir_tpu/parallel``.  Each rank is a process driving one
device; the functions run SPMD on every rank of a mesh:

- lane parallelism: interpreter lanes sharded over the mesh;
- trace-row sharding: commitment rows partitioned across ranks;
- distributed four-step NTT: local column NTTs + twiddle + an
  ``all_to_all_single`` transpose + local row NTTs;
- distributed Merkle: per-shard subtrees, ``all_gather`` of the subtree
  roots, replicated top levels;
- the sharded prover (``prove_trace(mesh=)``, ``prove_trace_streaming(
  mesh=)``): the LDE by column blocks, ``cols_to_rows``, hashing by row
  blocks, the digests ``all_gather``-ed;
- ``run_local_ranks``: N local ranks, a process each (``prove --mesh N``).
"""

from .mesh import Mesh, make_mesh
from .distributed import (
    all_gather_rows,
    cols_to_rows,
    dist_lde,
    dist_ntt,
    dist_ntt_natural,
    dist_merkle_root,
    sharded_interpreter_state,
    prove_step_sharded,
)
from .multihost import (initialize_multihost, join_local_group,
                        local_lane_slice, process_info, rendezvous_store,
                        run_local_ranks)
