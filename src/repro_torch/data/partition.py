"""Client partitioners: IID shuffle-and-split (the paper's setup) and
Dirichlet label-skew for non-IID ablations.  The same key gives the same
split as the reference."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch import random, tree


def partition_iid(key, dataset: dict, n_clients: int) -> List[dict]:
    """Shuffle, then split evenly (paper §IV-A: 'shuffled, assigned to
    client numbers, and distributed')."""
    n = len(tree.leaves(dataset)[0])
    perm = random.permutation(key, n)
    per = n // n_clients
    return [tree.map(lambda a: a[perm[k * per:(k + 1) * per]], dataset)
            for k in range(n_clients)]


def partition_dirichlet(key, dataset: dict, n_clients: int,
                        alpha: float = 0.5, num_classes: int = 10
                        ) -> List[dict]:
    """Label-skewed split: client k's class mix ~ Dirichlet(alpha)."""
    labels = dataset["labels"].cpu().numpy()
    rng_np = np.random.default_rng(
        int(random.randint(key, (), 0, 2**31 - 1)))
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c in range(num_classes):
        idx = np.where(labels == c)[0]
        rng_np.shuffle(idx)
        props = rng_np.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for k, part in enumerate(np.split(idx, cuts)):
            client_idx[k].extend(part.tolist())
    out = []
    for k in range(n_clients):
        idx = torch.as_tensor(sorted(client_idx[k]), dtype=torch.int64,
                              device=dataset["labels"].device)
        out.append(tree.map(lambda a: a[idx], dataset))
    return out
