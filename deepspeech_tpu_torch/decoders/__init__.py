from deepspeech_tpu_torch.decoders.base import Decoder
from deepspeech_tpu_torch.decoders.greedy import GreedyDecoder, greedy_ids

__all__ = ["Decoder", "GreedyDecoder", "greedy_ids"]
