"""Merge manifest CSVs in a folder into one duration-sorted manifest
(reference data/merge_manifests.py:10-31; the JAX package's
``cli/merge_manifests.py``, ported).

    python -m deepspeech_tpu_torch.cli.merge_manifests --merge-dir D \
        --output-path merged.csv
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Merges all manifest CSV files in specified folder.")
    p.add_argument("--merge-dir", default="manifests/")
    p.add_argument("--min-duration", default=1, type=int)
    p.add_argument("--max-duration", default=15, type=int)
    p.add_argument("--output-path", default="merged_manifest.csv")
    args = p.parse_args(argv)

    from deepspeech_tpu_torch.data import merge_manifests

    paths = [os.path.join(args.merge_dir, f)
             for f in os.listdir(args.merge_dir) if f.endswith(".csv")]
    n = merge_manifests(paths, args.output_path, args.min_duration,
                        args.max_duration)
    print(f"Wrote {n} entries to {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
