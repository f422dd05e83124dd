"""Client data partitioning for federated simulation.

* ``iid``      — uniform random split (the paper's setting).
* ``dirichlet``— label-skewed non-iid split, Dir(α) over class
                 proportions per client (standard FL heterogeneity
                 knob; beyond-paper ablation).
"""
from __future__ import annotations

import numpy as np

__all__ = ["partition_iid", "partition_dirichlet", "make_client_datasets"]


def partition_iid(n_samples: int, num_clients: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n_samples)
    return np.array_split(perm, num_clients)


def partition_dirichlet(labels: np.ndarray, num_clients: int, alpha: float = 0.5, seed: int = 0):
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    idx_by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_indices = [[] for _ in range(num_clients)]
    for idx in idx_by_class:
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, chunk in enumerate(np.split(idx, cuts)):
            client_indices[cid].extend(chunk.tolist())
    return [np.array(sorted(ci)) for ci in client_indices]


def make_client_datasets(x, y, num_clients: int, scheme: str = "iid",
                         alpha: float = 0.5, seed: int = 0):
    """→ list of (x_i, y_i) per client."""
    if scheme == "iid":
        parts = partition_iid(x.shape[0], num_clients, seed)
    elif scheme == "dirichlet":
        parts = partition_dirichlet(y, num_clients, alpha, seed)
    else:
        raise ValueError(scheme)
    return [(x[p], y[p]) for p in parts]
