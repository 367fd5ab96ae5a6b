from deepspeech_tpu_torch.metrics.edit_distance import (batch_edit_distance,
                                                        cer, edit_distance,
                                                        get_cer_wer,
                                                        string_distance, wer)

__all__ = ["batch_edit_distance", "cer", "edit_distance", "get_cer_wer",
           "string_distance", "wer"]
