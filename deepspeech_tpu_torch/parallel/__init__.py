"""Multi-GPU training: the (data, model) mesh over torch.distributed, the
JAX sharding rule, and tensor parallelism over the model axis (the JAX
package's ``parallel/``)."""

from deepspeech_tpu_torch.parallel.mesh import (Mesh, attach,
                                                equalize_batch_padding,
                                                gather_state,
                                                local_batch_to_global,
                                                make_mesh, metrics_to_local,
                                                param_spec, reduce_sum,
                                                shard_dim, shard_dims,
                                                shard_params, shard_slice,
                                                shard_state, unshard)
from deepspeech_tpu_torch.parallel.tp_rnn import (direction_sharded_rnn,
                                                  gathered,
                                                  maybe_direction_sharded)

__all__ = ["Mesh", "attach", "direction_sharded_rnn",
           "equalize_batch_padding", "gather_state", "gathered",
           "local_batch_to_global", "make_mesh", "maybe_direction_sharded",
           "metrics_to_local", "param_spec", "reduce_sum", "shard_dim",
           "shard_dims", "shard_params", "shard_slice", "shard_state",
           "unshard"]
