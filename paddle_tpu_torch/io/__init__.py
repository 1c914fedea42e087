"""Datasets, samplers, the DataLoader and the device prefetcher
(``paddle_tpu.io`` counterpart). ``io/data_feed.py`` is not ported yet."""
from .collate import default_collate_fn, default_convert_fn
from .dataloader import DataLoader, WorkerInfo, get_worker_info
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .prefetch import DevicePrefetcher, ShapeBuckets
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["DataLoader", "get_worker_info", "WorkerInfo",
           "default_collate_fn", "default_convert_fn", "Dataset",
           "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "SubsetRandomSampler", "DevicePrefetcher", "ShapeBuckets"]
