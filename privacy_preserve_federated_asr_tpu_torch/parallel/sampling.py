"""Client data partition samplers (reference: the Federated-Learning-
PyTorch template samplers in federated/Jack_Multiprocess開發/sampling.py:
10-201 — iid / non-iid shard / unequal-shard partitions). Generic over any
dataset size / label array instead of MNIST/CIFAR-specific."""

from __future__ import annotations

import numpy as np


def iid_partition(num_items: int, num_clients: int, seed: int = 0) -> dict[int, np.ndarray]:
    """Uniform random equal-size split of item indices across clients."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_items)
    per = num_items // num_clients
    return {c: np.sort(perm[c * per : (c + 1) * per]) for c in range(num_clients)}


def noniid_shard_partition(
    labels: np.ndarray, num_clients: int, shards_per_client: int = 2, seed: int = 0
) -> dict[int, np.ndarray]:
    """Label-sorted shard partition: sort items by label, cut into
    ``num_clients * shards_per_client`` shards, deal each client
    ``shards_per_client`` random shards (the classic pathological non-IID
    split)."""
    rng = np.random.default_rng(seed)
    num_shards = num_clients * shards_per_client
    order = np.argsort(np.asarray(labels), kind="stable")
    shards = np.array_split(order, num_shards)
    shard_ids = rng.permutation(num_shards)
    out = {}
    for c in range(num_clients):
        mine = shard_ids[c * shards_per_client : (c + 1) * shards_per_client]
        out[c] = np.sort(np.concatenate([shards[s] for s in mine]))
    return out


def noniid_unequal_partition(
    labels: np.ndarray, num_clients: int, min_shards: int = 1, max_shards: int = 30,
    num_shards: int | None = None, seed: int = 0,
) -> dict[int, np.ndarray]:
    """Unequal non-IID: random shard counts per client in
    [min_shards, max_shards], normalized to use every shard once."""
    rng = np.random.default_rng(seed)
    n = len(labels)
    num_shards = num_shards or max(num_clients * 2, min(n, num_clients * max_shards) // 10)
    order = np.argsort(np.asarray(labels), kind="stable")
    shards = np.array_split(order, num_shards)
    counts = rng.integers(min_shards, max_shards + 1, size=num_clients).astype(float)
    counts = np.maximum((counts / counts.sum() * num_shards).astype(int), 1)
    while counts.sum() > num_shards:
        counts[np.argmax(counts)] -= 1
    while counts.sum() < num_shards:
        counts[np.argmin(counts)] += 1
    shard_ids = rng.permutation(num_shards)
    out, pos = {}, 0
    for c in range(num_clients):
        mine = shard_ids[pos : pos + counts[c]]
        pos += counts[c]
        out[c] = np.sort(np.concatenate([shards[s] for s in mine])) if len(mine) else np.array([], dtype=int)
    return out
