from deepspeech_tpu_torch.augment.spectrogram import (
    FrequencyMask,
    SCompose,
    SComposePipelines,
    SOneOf,
    SOneOrOther,
    TimeMask,
    band_zero_8khz,
    spec_augment,
)
from deepspeech_tpu_torch.augment.waveform import (
    AddNoise,
    AudioDistort,
    ChangeAudioSpeed,
    Compose,
    OneOf,
    OneOrOther,
    PitchShift,
    Shift,
    build_waveform_pipeline,
)

__all__ = [
    "AddNoise", "AudioDistort", "ChangeAudioSpeed", "Compose", "OneOf",
    "OneOrOther", "PitchShift", "Shift", "build_waveform_pipeline",
    "FrequencyMask", "SCompose", "SComposePipelines", "SOneOf", "SOneOrOther",
    "TimeMask", "band_zero_8khz", "spec_augment",
]
