from deepspeech_tpu_torch.data.dataset import AudioDataset
from deepspeech_tpu_torch.data.loader import (AudioDataLoader, BucketSpec,
                                              collate_batch,
                                              stack_microbatches)
from deepspeech_tpu_torch.data.manifest import (create_manifest,
                                                merge_manifests,
                                                order_and_prune_files,
                                                read_manifest, write_manifest)
from deepspeech_tpu_torch.data.sampler import (BucketingSampler,
                                               DistributedBucketingSampler)

__all__ = ["AudioDataLoader", "AudioDataset", "BucketSpec",
           "BucketingSampler", "DistributedBucketingSampler", "collate_batch", "create_manifest",
           "merge_manifests", "order_and_prune_files", "read_manifest",
           "stack_microbatches", "write_manifest"]
