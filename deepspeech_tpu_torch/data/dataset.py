"""Audio dataset over a manifest (the JAX package's ``data/dataset.py``
without augmentation and curriculum, which are not ported yet).

A sample is the peak-normalized waveform at the configured sample rate,
its target ids and its path; the STFT and normalization run batched on the
device inside the train step (``train/step.py``).
"""

from __future__ import annotations

import numpy as np

from deepspeech_tpu_torch.audio.dsp import resample
from deepspeech_tpu_torch.audio.features import AudioConf
from deepspeech_tpu_torch.audio.io import load_audio_norm
from deepspeech_tpu_torch.data.manifest import read_manifest
from deepspeech_tpu_torch.text.labels import Labels


class AudioDataset:
    """Manifest-backed dataset of {"audio", "target", "path", "duration"}."""

    def __init__(self, audio_conf, manifest_filepath: str, labels,
                 max_items: int | None = None):
        self.conf = (audio_conf if isinstance(audio_conf, AudioConf)
                     else AudioConf.from_dict(audio_conf))
        self.labels = labels if isinstance(labels, Labels) else Labels(labels)
        self.ids = read_manifest(manifest_filepath, max_items)
        self._transcript_cache: dict[str, list[int]] = {}

    def load_waveform(self, audio_path: str) -> np.ndarray:
        y, sr = load_audio_norm(audio_path)
        if sr != self.conf.sample_rate:
            y = resample(y, sr, self.conf.sample_rate)
        return np.asarray(y, np.float32)

    def parse_transcript(self, transcript_path: str) -> list[int]:
        """Memoized text -> ids (reference data_loader_aug.py:505-514)."""
        if transcript_path not in self._transcript_cache:
            text = ""
            if transcript_path:
                with open(transcript_path, encoding="utf8") as f:
                    text = f.read()
            self._transcript_cache[transcript_path] = self.labels.parse(text)
        return self._transcript_cache[transcript_path]

    def __getitem__(self, index: int) -> dict:
        wav, txt, dur = self.ids[index]
        return {"path": wav, "duration": dur,
                "audio": self.load_waveform(wav),
                "target": np.asarray(self.parse_transcript(txt), np.int32)}

    def __len__(self):
        return len(self.ids)
