"""The data-parallel layer: one process a card, a ``torch.distributed``
process group where JAX has a device mesh (port of `parallel/`: the mesh,
multi-host and FSDP; tensor, sequence, pipeline and expert parallelism are
not ported yet)."""
from .fsdp import fsdp_specs, shard_state_fsdp
from .mesh import (all_reduce_mean, batch_sharding, gather_rows, make_mesh,
                   pad_to_multiple, replicate, replicated, shard_batch)
from .multihost import (distributed_init, make_global_mesh, mesh_process_count,
                        place_global, process_local_batch_size,
                        replicate_global, shard_batch_global)
