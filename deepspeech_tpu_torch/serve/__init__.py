"""Serving runtime: low-latency streaming inference (the JAX package's
``serve``).

A chunk step carries all sequential state (conv context, RNN hiddens,
lookahead FIFO, running normalization statistics, running SE sums) as
tensors on the model's device; ``StreamPool`` gives slots of that step
independent lifecycles.
"""

from deepspeech_tpu_torch.serve.pool import StreamPool
from deepspeech_tpu_torch.serve.streaming import StreamingTranscriber
from deepspeech_tpu_torch.serve.streaming_cnn import CNNStreamingTranscriber

__all__ = ["StreamingTranscriber", "CNNStreamingTranscriber", "StreamPool"]
