from deepspeech_tpu_torch.text.labels import Labels, load_labels
from deepspeech_tpu_torch.text.num2words import num2words

__all__ = ["Labels", "load_labels", "num2words"]
