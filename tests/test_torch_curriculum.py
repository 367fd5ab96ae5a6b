"""PyTorch port: curriculum sampling, its CSV sidecars and the train CLI's
epoch order, against the JAX package.

The port's copy of ``Curriculum`` draws the same ids and gives the same
probabilities as the JAX class; ``CurriculumStore`` writes the same CSV
bytes, and a sidecar written by either package loads in the other. The
epoch order: the JAX train CLI sets each epoch's list before it builds the
sampler (``set_curriculum_epoch``: all rows or a curriculum draw, then a
numpy shuffle seeded by the epoch, ``deepspeech_tpu/cli/train.py:612-614``);
the port's ``epoch_loader`` must give the same batches, by path, on the
SortaGrad epoch 0 and the shuffled epoch 1. The train CLI with
``--use-curriculum`` writes both sidecars beside every checkpoint, and
``--curriculum`` preloads the train store from a JAX-written CSV.
"""

import csv
import os

import numpy as np
import pytest

from deepspeech_tpu.audio import AudioConf as JaxAudioConf
from deepspeech_tpu.data import AudioDataLoader as JaxLoader
from deepspeech_tpu.data import AudioDataset as JaxDataset
from deepspeech_tpu.data import BucketingSampler as JaxSampler
from deepspeech_tpu.data.curriculum import Curriculum as JaxCurriculum
from deepspeech_tpu.data.curriculum import CurriculumStore as JaxStore
from deepspeech_tpu_torch.audio.features import AudioConf
from deepspeech_tpu_torch.audio.io import save_wav
from deepspeech_tpu_torch.cli.train import build_parser, epoch_loader
from deepspeech_tpu_torch.cli.train import main as train_main
from deepspeech_tpu_torch.data import AudioDataset, BucketSpec
from deepspeech_tpu_torch.data.curriculum import (CURRICULUM_FIELDS,
                                                  Curriculum, CurriculumStore)

LABELS = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ2 "
TEXTS = ("HELLO WORLD", "THE CAT", "A DOG RAN", "GOOD DAY", "YES", "NO",
         "SPEECH", "ON THE CARD")


def _manifest(d, n):
    rng = np.random.default_rng(n)
    rows = []
    for i in range(n):
        m = int(16000 * (0.2 + 0.05 * i))
        t = np.arange(m) / 16000
        y = (np.sin(2 * np.pi * (200 + 40 * i) * t)
             + 0.1 * rng.standard_normal(m))
        wav, txt = os.path.join(d, f"u{i}.wav"), os.path.join(d, f"u{i}.txt")
        save_wav(wav, (y / np.abs(y).max()).astype(np.float32), 16000)
        with open(txt, "w") as f:
            f.write(TEXTS[i % len(TEXTS)])
        rows.append(f"{wav},{txt},{m / 16000}")
    path = os.path.join(d, "manifest.csv")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def _rows(n=30):
    rng = np.random.default_rng(5)
    cers = rng.choice([0.0, 0.05, 0.15, 0.2, 0.3, 0.5, 0.51, 0.8, 0.999], n)
    return [(f"/d/u{i}.wav", f"/d/u{i}.txt", 1.0) for i in range(n)], cers


@pytest.mark.parametrize("epoch,share", [(0, 0.5), (1, 0.5), (7, 1.5)])
def test_sample_matches_jax(epoch, share):
    items, cers = _rows()
    info = {w: (LABELS[:3 + i], float(c))
            for i, ((w, _, _), c) in enumerate(zip(items, cers))}

    def getter(item):
        return info[item[0]]

    got = list(Curriculum.sample(items, getter, epoch, len(items) * share))
    want = list(JaxCurriculum.sample(items, getter, epoch,
                                     len(items) * share))
    assert got == want and len(got) >= len(items) * share


def test_get_prob_matches_jax():
    for cer in np.linspace(0, 1.2, 61):
        for text in ("", "A", "HELLO WORLD"):
            assert (Curriculum.get_prob(text, float(cer))
                    == JaxCurriculum.get_prob(text, float(cer)))
    with pytest.raises(ValueError):
        list(Curriculum.sample([], lambda item: ("", 0.5), 0))


def _fill(store):
    store.update("/d/a.wav", "HELLO, WORLD", 'SAY "HI"', None, 0.25, 0.5)
    store.update("/d/a.wav", "HELLO, WORLD", "HELO", [1, 2], 0.1, 0.5)
    store.update("/d/b.wav", "YES", "", None, 1.0, 1.0, times_used=7)
    return store


def test_sidecar_bytes_match_jax(tmp_path):
    ours, theirs = tmp_path / "port.csv", tmp_path / "jax.csv"
    _fill(CurriculumStore(["/d/a.wav", "/d/b.wav", "/d/c.wav"])).save(
        str(ours))
    _fill(JaxStore(["/d/a.wav", "/d/b.wav", "/d/c.wav"])).save(str(theirs))
    assert ours.read_bytes() == theirs.read_bytes()
    with open(ours, newline="") as f:
        assert next(csv.reader(f)) == CURRICULUM_FIELDS


def test_sidecars_load_across_packages(tmp_path):
    a, b = tmp_path / "a.csv", tmp_path / "b.csv"
    _fill(JaxStore(["/d/c.wav"])).save(str(a))
    ours = CurriculumStore.load(str(a))
    assert ours.rows == JaxStore.load(str(a)).rows and len(ours) == 3
    assert ours.get("/d/a.wav")["times_used"] == 2
    ours.update("/d/c.wav", "NO", "N", None, 0.5, 1.0)
    ours.save(str(b))
    theirs = JaxStore.load(str(b))
    assert theirs.rows == CurriculumStore.load(str(b)).rows
    assert theirs.get("/d/c.wav")["cer"] == 0.5


@pytest.mark.parametrize("use_curriculum", [False, True])
def test_epoch_batches_match_jax(tmp_path, use_curriculum):
    """Both packages' dataset, sampler and loader as their train CLIs
    drive them, 8 utterances at batch 2: the same paths in every batch on
    epoch 0 (SortaGrad) and epoch 1 (shuffled)."""
    manifest = _manifest(str(tmp_path), 8)
    flags = ["--batch-size", "2", "--num-workers", "1"]
    args = build_parser().parse_args(
        flags + (["--use-curriculum"] if use_curriculum else []))
    ours = AudioDataset(AudioConf(), manifest, LABELS)
    theirs = JaxDataset(JaxAudioConf(), manifest, LABELS)
    bucket = BucketSpec()
    for epoch in (0, 1):
        got = [b["paths"] for b in epoch_loader(ours, epoch, args, bucket)]
        theirs.set_curriculum_epoch(epoch, sample=use_curriculum,
                                    sample_size=0.5)
        sampler = JaxSampler(len(theirs), 2)
        if epoch > 0:
            sampler.shuffle(epoch)
        want = [b["paths"] for b in JaxLoader(theirs, sampler, 2,
                                              num_workers=1)]
        assert got == want, epoch
        assert ours.ids == theirs.ids
    assert ours.ids != ours.all_ids  # the shuffle moved the rows


def _train(tmp_path, *flags):
    manifest = _manifest(str(tmp_path), 4)
    save = tmp_path / "models"
    rc = train_main(["--device", "cpu", "--train-manifest", manifest,
                     "--val-manifest", manifest, "--epochs", "1",
                     "--batch-size", "2", "--val-batch-size", "2",
                     "--hidden-size", "8", "--hidden-layers", "1",
                     "--compute-dtype", "float32", "--num-workers", "1",
                     "--checkpoint", "--silent", "--save-folder", str(save),
                     *flags])
    assert rc == 0
    return save, [row.split(",")[0]
                  for row in open(manifest).read().splitlines()]


def test_train_cli_writes_both_sidecars(tmp_path):
    save, wavs = _train(tmp_path, "--use-curriculum")
    for name in ("deepspeech_epoch_001.ckpt", "best_model.ckpt",
                 "deepspeech_final.ckpt"):
        for sidecar in (".curriculum.csv", ".val.curriculum.csv"):
            store = JaxStore.load(str(save / (name + sidecar)))
            assert sorted(store.rows) == sorted(wavs), (name, sidecar)
    train = CurriculumStore.load(str(save / "deepspeech_final.ckpt"
                                      ".curriculum.csv"))
    val = CurriculumStore.load(str(save / "deepspeech_final.ckpt"
                                    ".val.curriculum.csv"))
    drawn = [r for r in train.rows.values() if r["times_used"]]
    assert drawn and all(r["cer"] != 0.999 and r["text"] for r in drawn)
    assert all(r["times_used"] == 1 and r["cer"] != 0.999
               for r in val.rows.values())


def test_train_cli_preloads_a_jax_curriculum(tmp_path):
    d = tmp_path / "pre"
    d.mkdir()
    wavs = [row.split(",")[0]
            for row in open(_manifest(str(tmp_path), 4)).read().splitlines()]
    store = JaxStore()
    for wav in wavs + ["/elsewhere/x.wav"]:
        store.update(wav, "OLD", "OLD", None, 0.3, 0.4, times_used=5)
    store.save(str(d / "jax.csv"))
    save, _ = _train(tmp_path, "--curriculum", str(d / "jax.csv"))
    train = CurriculumStore.load(str(save / "deepspeech_final.ckpt"
                                      ".curriculum.csv"))
    assert train.get("/elsewhere/x.wav")["times_used"] == 5
    assert all(train.get(w)["times_used"] == 6 for w in wavs)
    assert all(train.get(w)["text"] != "OLD" for w in wavs)
