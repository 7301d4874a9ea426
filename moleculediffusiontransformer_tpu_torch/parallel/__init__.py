"""The parallel layer: one process a card, a ``torch.distributed`` process
group where JAX has a device mesh (port of `parallel/`): the data mesh,
multi-host and FSDP; tensor (``tp``), sequence (``sp``), pipeline (``pp``)
and expert (``ep``) parallelism over a 2-D mesh; and the autograd-aware
collectives they rest on (``collectives``)."""
from .fsdp import fsdp_specs, shard_state_fsdp
from .mesh import (all_reduce_mean, batch_sharding, gather_rows, make_mesh,
                   pad_to_multiple, replicate, replicated, shard_batch)
from .multihost import (distributed_init, make_global_mesh, mesh_process_count,
                        place_global, process_local_batch_size,
                        replicate_global, shard_batch_global)
from .tp import make_mesh_2d, shard_params_tp, tensor_parallel_specs
from .sp import make_mesh_sp, seq_sharding, shard_batch_sp, shard_seq
from .ep import (expert_parallel_specs, make_mesh_ep, shard_batch_ep,
                 shard_params_ep)
from .pp import (make_layer_apply, make_mesh_pp, pipeline_forward,
                 pipeline_layers, shard_model_pp, shard_stacked,
                 split_microbatches, stack_layer_params, unstack_layer_params)
