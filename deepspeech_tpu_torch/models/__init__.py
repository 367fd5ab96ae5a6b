from deepspeech_tpu_torch.models.conformer import Conformer
from deepspeech_tpu_torch.models.ds2 import DeepSpeech2, conv_out_lengths
from deepspeech_tpu_torch.models.factory import build_model, model_from_meta

__all__ = ["Conformer", "DeepSpeech2", "build_model", "conv_out_lengths",
           "model_from_meta"]
