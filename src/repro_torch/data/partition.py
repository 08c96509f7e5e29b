"""Non-IID client partitioning (paper §IV: Dirichlet, γ = 0.5)."""

from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import IntentDataset

__all__ = ["dirichlet_partition", "iid_partition", "split_public_private"]


def dirichlet_partition(
    labels: np.ndarray, num_clients: int, *, gamma: float = 0.5, seed: int = 0, min_per_client: int = 2
) -> list[np.ndarray]:
    """Partition sample indices by class with a Dirichlet(γ) draw per class
    (the paper's heterogeneity model).  Returns one index array per client."""
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    client_indices: list[list[int]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, gamma))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client, part in enumerate(np.split(idx, cuts)):
            client_indices[client].extend(part.tolist())
    out = []
    for client in range(num_clients):
        ids = np.array(sorted(client_indices[client]), dtype=np.int64)
        if ids.size < min_per_client:  # rebalance pathological draws
            donor = int(np.argmax([len(ci) for ci in client_indices]))
            take = np.array(client_indices[donor][:min_per_client], dtype=np.int64)
            client_indices[donor] = client_indices[donor][min_per_client:]
            ids = np.concatenate([ids, take])
        out.append(ids)
    return out


def iid_partition(n: int, num_clients: int, *, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def split_public_private(
    ds: IntentDataset, public_size: int, *, seed: int = 0
) -> tuple[IntentDataset, IntentDataset]:
    """Carve out the shared public set (paper: 2,000 unlabeled samples)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds))
    return ds.subset(idx[:public_size]), ds.subset(idx[public_size:])
