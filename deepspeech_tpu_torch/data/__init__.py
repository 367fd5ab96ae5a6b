from deepspeech_tpu_torch.data.dataset import AudioDataset
from deepspeech_tpu_torch.data.loader import (AudioDataLoader, BucketSpec,
                                              collate_batch)
from deepspeech_tpu_torch.data.manifest import (create_manifest,
                                                merge_manifests,
                                                order_and_prune_files,
                                                read_manifest, write_manifest)
from deepspeech_tpu_torch.data.sampler import BucketingSampler

__all__ = ["AudioDataLoader", "AudioDataset", "BucketSpec",
           "BucketingSampler", "collate_batch", "create_manifest",
           "merge_manifests", "order_and_prune_files", "read_manifest",
           "write_manifest"]
