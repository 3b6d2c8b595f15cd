"""paddle.io counterpart: datasets, samplers, DataLoader and the device
prefetcher (`paddle_tpu/io/`)."""
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, WeightedRandomSampler,
)
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .prefetch import DevicePrefetcher, maybe_wrap  # noqa: F401


class WorkerInfo:
    """Per-worker metadata inside a DataLoader worker process
    (`io/dataloader/worker.py` get_worker_info)."""

    def __init__(self, id, num_workers, seed, dataset):
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset


_WORKER_INFO = [None]


def get_worker_info():
    """None in the main process; a WorkerInfo inside a worker subprocess
    (used by IterableDataset shards to split work)."""
    return _WORKER_INFO[0]
