"""The benchmark of ``deepspeech_tpu_torch`` on one NVIDIA H100."""
