from deepspeech_tpu_torch.metrics.edit_distance import (cer, edit_distance,
                                                        get_cer_wer,
                                                        string_distance, wer)

__all__ = ["cer", "edit_distance", "get_cer_wer", "string_distance", "wer"]
