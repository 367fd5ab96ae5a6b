"""Audio dataset over a manifest (the JAX package's ``data/dataset.py``).

A sample is the peak-normalized waveform at the configured sample rate
(with ``augment``, passed through the host waveform pipeline of
``aug_type``), its target ids and its path; the STFT and normalization run
batched on the device inside the train step (``train/step.py``). With
``emit="spect"`` it is the host spectrogram instead (``parse_audio_np``,
with the train-time jitter and SpecAugment masks when augmenting), the
JAX package's parity path. The per-sample augmentation RNG is
``default_rng(SeedSequence([seed, epoch, index]))``, as there, so both
packages draw the same augmentation for the same (seed, epoch, index).

The manifest's rows are ``all_ids``; ``ids`` is the current epoch's list,
which ``set_curriculum_epoch`` resamples by curriculum probability (or
keeps whole) and shuffles with the epoch as the seed, as the JAX package
does before every epoch. The curriculum store keeps each utterance's
running CER and WER (``data/curriculum.py``).
"""

from __future__ import annotations

import numpy as np

from deepspeech_tpu_torch.audio.dsp import resample
from deepspeech_tpu_torch.audio.features import AudioConf, parse_audio_np
from deepspeech_tpu_torch.audio.io import load_audio_norm
from deepspeech_tpu_torch.augment.spectrogram import (FrequencyMask, SOneOf,
                                                      TimeMask)
from deepspeech_tpu_torch.augment.waveform import build_waveform_pipeline
from deepspeech_tpu_torch.data.curriculum import Curriculum, CurriculumStore
from deepspeech_tpu_torch.data.manifest import read_manifest
from deepspeech_tpu_torch.text.labels import Labels


class AudioDataset:
    """Manifest-backed dataset of {"audio" (or "spect"), "target", "path",
    "duration"}.

    :param normalize: normalization mode (only used when emit="spect").
    :param augment: enable the waveform augs (prob from
        audio_conf.noise_prob).
    :param curriculum_filepath: optional CSV sidecar to preload the CER
        history from; otherwise every wav starts at CER 0.999.
    :param seed: the per-sample RNG's first seed.
    :param aug_type: waveform pipeline variant 0-3 (reference
        data_loader_aug.py:367-412).
    :param emit: "audio" (device featurize; default) or "spect" (host).
    """

    def __init__(self, audio_conf, manifest_filepath: str, labels,
                 max_items: int | None = None,
                 curriculum_filepath: str | None = None,
                 normalize: str = "max_frame", augment: bool = False,
                 seed: int = 123456, aug_type: int = 0,
                 emit: str = "audio"):
        self.conf = (audio_conf if isinstance(audio_conf, AudioConf)
                     else AudioConf.from_dict(audio_conf))
        self.labels = labels if isinstance(labels, Labels) else Labels(labels)
        self.normalize = normalize
        self.augment = augment
        self.emit = emit
        self.seed = seed
        self.epoch = 0
        self.all_ids = read_manifest(manifest_filepath, max_items)
        self.ids = list(self.all_ids)
        self._transcript_cache: dict[str, list[int]] = {}
        noise_samples = ()
        if self.conf.noise_dir:
            import glob
            noise_samples = sorted(glob.glob(self.conf.noise_dir))
        self.augs = (build_waveform_pipeline(self.conf.noise_prob,
                                             noise_samples,
                                             self.conf.sample_rate,
                                             aug_type=aug_type)
                     if augment else None)
        # host SpecAugment for emit="spect" (reference
        # data_loader_aug.py:424-433)
        self.augs_spect = None
        if augment and self.conf.aug_prob_spect > 0:
            self.augs_spect = SOneOf(
                [FrequencyMask(bands=2, prob=self.conf.aug_prob_spect,
                               dropout_width=20),
                 TimeMask(bands=2, prob=self.conf.aug_prob_spect,
                          dropout_length=50, max_dropout_ratio=0.15)],
                prob=self.conf.noise_prob)
        if curriculum_filepath:
            self.curriculum = CurriculumStore.load(curriculum_filepath)
        else:
            self.curriculum = CurriculumStore(
                [wav for wav, _, _ in self.all_ids])

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index]))

    def load_waveform(self, audio_path: str, rng=None) -> np.ndarray:
        y, sr = load_audio_norm(audio_path)
        if sr != self.conf.sample_rate:
            y = resample(y, sr, self.conf.sample_rate)
        if self.augs is not None and rng is not None:
            y, _ = self.augs(y, self.conf.sample_rate, rng)
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
        rng = self._rng(index) if self.augment else None
        y = self.load_waveform(wav, rng)
        sample = {"path": wav, "duration": dur,
                  "target": np.asarray(self.parse_transcript(txt), np.int32)}
        if self.emit == "spect":
            spect = parse_audio_np(y, self.conf, self.normalize,
                                   jitter_rng=rng)
            if self.augs_spect is not None and rng is not None:
                spect = self.augs_spect(spect, rng)
            sample["spect"] = spect.astype(np.float32)
        else:
            sample["audio"] = y
        return sample

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
