"""Audio dataset over a manifest (the JAX package's ``data/dataset.py``
without augmentation, which is not ported yet).

A sample is the peak-normalized waveform at the configured sample rate,
its target ids and its path; the STFT and normalization run batched on the
device inside the train step (``train/step.py``). The manifest's rows are
``all_ids``; ``ids`` is the current epoch's list, which
``set_curriculum_epoch`` resamples by curriculum probability (or keeps
whole) and shuffles with the epoch as the seed, as the JAX package does
before every epoch. The curriculum store keeps each utterance's running
CER and WER (``data/curriculum.py``).
"""

from __future__ import annotations

import numpy as np

from deepspeech_tpu_torch.audio.dsp import resample
from deepspeech_tpu_torch.audio.features import AudioConf
from deepspeech_tpu_torch.audio.io import load_audio_norm
from deepspeech_tpu_torch.data.curriculum import Curriculum, CurriculumStore
from deepspeech_tpu_torch.data.manifest import read_manifest
from deepspeech_tpu_torch.text.labels import Labels


class AudioDataset:
    """Manifest-backed dataset of {"audio", "target", "path", "duration"}.

    :param curriculum_filepath: optional CSV sidecar to preload the CER
        history from; otherwise every wav starts at CER 0.999.
    """

    def __init__(self, audio_conf, manifest_filepath: str, labels,
                 max_items: int | None = None,
                 curriculum_filepath: str | None = None):
        self.conf = (audio_conf if isinstance(audio_conf, AudioConf)
                     else AudioConf.from_dict(audio_conf))
        self.labels = labels if isinstance(labels, Labels) else Labels(labels)
        self.epoch = 0
        self.all_ids = read_manifest(manifest_filepath, max_items)
        self.ids = list(self.all_ids)
        self._transcript_cache: dict[str, list[int]] = {}
        if curriculum_filepath:
            self.curriculum = CurriculumStore.load(curriculum_filepath)
        else:
            self.curriculum = CurriculumStore(
                [wav for wav, _, _ in self.all_ids])

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

    def get_reference_transcript(self, txt_path: str) -> str:
        return self.labels.render_transcript(self.parse_transcript(txt_path))

    def __getitem__(self, index: int) -> dict:
        wav, txt, dur = self.ids[index]
        return {"path": wav, "duration": dur,
                "audio": self.load_waveform(wav),
                "target": np.asarray(self.parse_transcript(txt), np.int32)}

    def __len__(self):
        return len(self.ids)

    # -- curriculum (reference data_loader_aug.py:462-503) --------------------

    def get_curriculum_info(self, item):
        """(reference text, CER) of a manifest row; a wav the store does
        not know counts as CER 0.999."""
        wav, txt, _ = item
        row = self.curriculum.get(wav)
        if row is None:
            return self.get_reference_transcript(txt), 0.999
        return row["text"], row["cer"]

    def set_curriculum_epoch(self, epoch: int, sample: bool = False,
                             sample_size: float = 0.5):
        """This epoch's list: the rows drawn by curriculum probability
        (``sample``; at least ``sample_size`` x the manifest) or all of
        them, then shuffled by ``np.random.default_rng(epoch)``
        (reference data_loader_aug.py:468-483)."""
        self.epoch = epoch
        if sample:
            self.ids = list(Curriculum.sample(
                self.all_ids, self.get_curriculum_info, epoch=epoch,
                min=len(self.all_ids) * sample_size))
        else:
            self.ids = list(self.all_ids)
        np.random.default_rng(epoch).shuffle(self.ids)

    def update_curriculum(self, wav, reference, transcript, offsets, cer,
                          wer, times_used=None):
        """Record one decode of ``wav``; ``times_used=None`` increments its
        counter (reference train.py:376-381, 481-486, 581-586)."""
        self.curriculum.update(wav, reference, transcript, offsets, cer, wer,
                               times_used)

    def save_curriculum(self, path: str):
        self.curriculum.save(path)
