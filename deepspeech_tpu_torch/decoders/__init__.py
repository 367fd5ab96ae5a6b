from deepspeech_tpu_torch.decoders.base import Decoder
from deepspeech_tpu_torch.decoders.beam import BeamCTCDecoder, ctc_beam_search
from deepspeech_tpu_torch.decoders.beam_device import (DeviceBeamCTCDecoder,
                                                       ctc_beam_search_device)
from deepspeech_tpu_torch.decoders.greedy import GreedyDecoder, greedy_ids
from deepspeech_tpu_torch.decoders.lm import ArpaLM

__all__ = ["Decoder", "BeamCTCDecoder", "ctc_beam_search", "GreedyDecoder",
           "greedy_ids", "ArpaLM", "DeviceBeamCTCDecoder",
           "ctc_beam_search_device"]
