"""Multi-dataset mixing (host-side; the reference's
create_training_dataset.py, the JAX package's data/mixing.py):
name-parsed composition ('llff+ibrnet_collected'), weighted sampling
across datasets, and a per-host strided slice of one seeded sample stream
(in place of DistributedSamplerWrapper)."""
from __future__ import annotations

import numpy as np


class WeightedMixDataset:
    """Sample from several datasets with given probabilities."""

    def __init__(self, datasets: list, weights: list[float], seed: int = 0):
        if not (len(datasets) == len(weights) and len(datasets) > 0):
            raise ValueError(f"{len(datasets)} datasets and {len(weights)} weights")
        self.datasets = datasets
        w = np.asarray(weights, np.float64)
        self.weights = w / w.sum()
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        d = self.rng.choice(len(self.datasets), p=self.weights)
        ds = self.datasets[d]
        return ds[self.rng.randint(len(ds))]

    def host_shard_iter(self, host_id: int, num_hosts: int, seed: int = 0):
        """Every host draws from the same seeded stream and keeps its
        stride-slice, so streams are disjoint and reproducible."""
        rng = np.random.RandomState(seed)
        i = 0
        while True:
            d = rng.choice(len(self.datasets), p=self.weights)
            j = rng.randint(len(self.datasets[d]))
            if i % num_hosts == host_id:
                yield self.datasets[d][j]
            i += 1


def create_training_dataset(cfg, dataset_classes: dict, mode: str = "train"):
    """The (possibly mixed) training dataset cfg.train.train_dataset names,
    e.g. 'llff+ibrnet_collected' with cfg.train.dataset_weights."""
    names = cfg.train.train_dataset.split("+")
    datasets = []
    for name in names:
        if name not in dataset_classes:
            raise KeyError(f"unknown dataset: {name} (have {list(dataset_classes)})")
        datasets.append(dataset_classes[name](cfg, mode))
    if len(datasets) == 1:
        return datasets[0]
    return WeightedMixDataset(datasets, list(cfg.train.dataset_weights), seed=cfg.train.seed)
