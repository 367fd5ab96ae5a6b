from deepspeech_tpu_torch.audio.features import (N_BINS, AudioConf,
                                                 featurize_batch, make_window,
                                                 normalize_spectrogram_batch)
from deepspeech_tpu_torch.audio.io import load_audio_norm

__all__ = ["N_BINS", "AudioConf", "featurize_batch", "make_window",
           "normalize_spectrogram_batch", "load_audio_norm"]
