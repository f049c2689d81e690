"""Batching helpers: reshape a client's dataset into (n_batches, B, ...)
tensors, as the reference stacks them."""
from __future__ import annotations

from repro_torch import tree


def batch_dataset(dataset: dict, batch_size: int) -> dict:
    n = len(tree.leaves(dataset)[0])
    nb = n // batch_size
    return tree.map(
        lambda a: a[:nb * batch_size].reshape(nb, batch_size, *a.shape[1:]),
        dataset)


def client_batches(client_data_list, batch_size: int):
    return [batch_dataset(d, batch_size) for d in client_data_list]
