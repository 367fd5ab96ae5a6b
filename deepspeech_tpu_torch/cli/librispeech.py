"""LibriSpeech dataset preparation (reference data/librispeech.py:10-113;
the JAX package's ``cli/librispeech.py``, ported).

    python -m deepspeech_tpu_torch.cli.librispeech --target-dir D \
        --files-to-use test-clean.tar.gz

Downloads (when the network allows), unpacks, converts FLAC -> 16 kHz mono
wav with the in-tree native FLAC decoder + polyphase resampler (replacing
the reference's sox shell-out, librispeech.py:45), extracts per-utterance
transcripts, and writes duration-sorted manifests. Pre-downloaded tarballs
or pre-extracted LibriSpeech/ trees are picked up without network access.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tarfile

LIBRI_SPEECH_URLS = {
    "train": ["http://www.openslr.org/resources/12/train-clean-100.tar.gz",
              "http://www.openslr.org/resources/12/train-clean-360.tar.gz",
              "http://www.openslr.org/resources/12/train-other-500.tar.gz"],
    "val": ["http://www.openslr.org/resources/12/dev-clean.tar.gz",
            "http://www.openslr.org/resources/12/dev-other.tar.gz"],
    "test_clean": ["http://www.openslr.org/resources/12/test-clean.tar.gz"],
    "test_other": ["http://www.openslr.org/resources/12/test-other.tar.gz"],
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Processes and downloads the LibriSpeech dataset.")
    p.add_argument("--target-dir", default="LibriSpeech_dataset/")
    p.add_argument("--sample-rate", default=16000, type=int)
    p.add_argument("--files-to-use",
                   default="train-clean-100.tar.gz,train-clean-360.tar.gz,"
                           "train-other-500.tar.gz,dev-clean.tar.gz,"
                           "dev-other.tar.gz,test-clean.tar.gz,"
                           "test-other.tar.gz")
    p.add_argument("--min-duration", default=1, type=int)
    p.add_argument("--max-duration", default=15, type=int)
    p.add_argument("--remove-tarballs", action="store_true")
    return p


def _preprocess_transcript(phrase: str) -> str:
    return phrase.strip().upper()


def convert_flac_to_wav(flac_path: str, wav_path: str, sample_rate: int):
    """Native decode + resample + mono mixdown + 16-bit wav write."""
    import numpy as np

    from deepspeech_tpu_torch.audio.dsp import resample
    from deepspeech_tpu_torch.audio.io import read_flac, save_wav

    data, sr, bits = read_flac(flac_path)
    y = data.astype(np.float32) / float(1 << (bits - 1))
    if y.ndim > 1:
        y = y.mean(axis=1)
    if sr != sample_rate:
        y = resample(y, sr, sample_rate)
    save_wav(wav_path, y, sample_rate)


def process_file(wav_dir: str, txt_dir: str, base_filename: str,
                 root_dir: str, sample_rate: int):
    """One utterance: flac -> wav + transcript txt
    (reference librispeech.py:41-58)."""
    full_recording_path = os.path.join(root_dir, base_filename)
    wav_path = os.path.join(wav_dir, base_filename.replace(".flac", ".wav"))
    convert_flac_to_wav(full_recording_path, wav_path, sample_rate)
    txt_path = os.path.join(txt_dir, base_filename.replace(".flac", ".txt"))
    transcript_file = os.path.join(
        root_dir, "-".join(base_filename.split("-")[:-1]) + ".trans.txt")
    with open(transcript_file) as f:
        transcriptions = {line.split()[0].split("-")[-1]:
                          " ".join(line.split()[1:])
                          for line in f.read().strip().split("\n")}
    key = base_filename.replace(".flac", "").split("-")[-1]
    with open(txt_path, "w") as f:
        f.write(_preprocess_transcript(transcriptions[key]))


def maybe_download(url: str, target_dir: str) -> str | None:
    filename = url.split("/")[-1]
    target = os.path.join(target_dir, filename)
    if os.path.exists(target):
        return target
    try:
        subprocess.run(["wget", "-q", "-O", target + ".part", url],
                       check=True, timeout=3600)
        os.replace(target + ".part", target)
        return target
    except Exception:
        for suffix in (".part",):
            try:
                os.remove(target + suffix)
            except OSError:
                pass
        print(f"download failed (offline?): {url}")
        return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from deepspeech_tpu_torch.data import create_manifest

    files_to_dl = args.files_to_use.strip().split(",")
    os.makedirs(args.target_dir, exist_ok=True)
    for split_type, urls in LIBRI_SPEECH_URLS.items():
        split_dir = os.path.join(args.target_dir, split_type)
        wav_dir = os.path.join(split_dir, "wav")
        txt_dir = os.path.join(split_dir, "txt")
        os.makedirs(wav_dir, exist_ok=True)
        os.makedirs(txt_dir, exist_ok=True)
        extracted_dir = os.path.join(split_dir, "LibriSpeech")
        for url in urls:
            if not any(f in url for f in files_to_dl):
                print(f"Skipping url: {url}")
                continue
            tarball = maybe_download(url, split_dir)
            if tarball:
                print(f"Unpacking {os.path.basename(tarball)}...")
                with tarfile.open(tarball) as tar:
                    tar.extractall(split_dir, filter="data")
                if args.remove_tarballs:
                    os.remove(tarball)
            if not os.path.exists(extracted_dir):
                continue
            print("Converting flac files and extracting transcripts...")
            n = 0
            for root, _, files in os.walk(extracted_dir):
                for f in files:
                    if f.endswith(".flac"):
                        process_file(wav_dir, txt_dir, f, root,
                                     args.sample_rate)
                        n += 1
            print(f"Converted {n} utterances from {url}")
            shutil.rmtree(extracted_dir)
        manifest = f"libri_{split_type}_manifest.csv"
        if os.listdir(wav_dir):
            if split_type == "train":
                create_manifest(split_dir, manifest, args.min_duration,
                                args.max_duration)
            else:
                create_manifest(split_dir, manifest)
            print(f"Wrote {manifest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
