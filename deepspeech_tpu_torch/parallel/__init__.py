"""Multi-GPU training: the (data, model) mesh over torch.distributed and
direction-sharded RNN tensor parallelism (the JAX package's
``parallel/``)."""

from deepspeech_tpu_torch.parallel.mesh import (Mesh, attach,
                                                equalize_batch_padding,
                                                gather_state,
                                                local_batch_to_global,
                                                make_mesh, metrics_to_local,
                                                param_spec, reduce_sum,
                                                shard_params, shard_state,
                                                unshard)
from deepspeech_tpu_torch.parallel.tp_rnn import (direction_sharded_rnn,
                                                  maybe_direction_sharded)

__all__ = ["Mesh", "attach", "direction_sharded_rnn",
           "equalize_batch_padding", "gather_state", "local_batch_to_global",
           "make_mesh", "maybe_direction_sharded", "metrics_to_local",
           "param_spec", "reduce_sum", "shard_params", "shard_state",
           "unshard"]
