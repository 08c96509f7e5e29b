"""Batching pipeline: shuffled epochs, drop-remainder, numpy -> device."""

from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.data.synthetic import IntentDataset

__all__ = ["batch_iterator", "epoch_batches", "pad_to_batch"]


def pad_to_batch(arr: np.ndarray, batch: int) -> np.ndarray:
    """Cyclic-pad the leading axis up to ``batch`` (small-client case)."""
    n = arr.shape[0]
    if n >= batch:
        return arr[:batch]
    reps = int(np.ceil(batch / n))
    return np.concatenate([arr] * reps, axis=0)[:batch]


def epoch_batches(
    ds: IntentDataset, batch_size: int, *, rng: np.random.Generator, drop_last: bool = True
) -> Iterator[dict]:
    idx = rng.permutation(len(ds))
    n_full = len(ds) // batch_size
    if n_full == 0:
        # tiny client shard: one cyclically-padded batch
        sel = pad_to_batch(idx, batch_size)
        yield {"tokens": ds.tokens[sel], "labels": ds.labels[sel]}
        return
    for b in range(n_full):
        sel = idx[b * batch_size : (b + 1) * batch_size]
        yield {"tokens": ds.tokens[sel], "labels": ds.labels[sel]}
    if not drop_last and len(ds) % batch_size:
        sel = pad_to_batch(idx[n_full * batch_size :], batch_size)
        yield {"tokens": ds.tokens[sel], "labels": ds.labels[sel]}


def batch_iterator(
    ds: IntentDataset, batch_size: int, *, seed: int = 0, max_batches: int | None = None
) -> Iterator[dict]:
    """Endless (or capped) shuffled batch stream across epochs."""
    rng = np.random.default_rng(seed)
    count = 0
    while True:
        for batch in epoch_batches(ds, batch_size, rng=rng):
            yield batch
            count += 1
            if max_batches is not None and count >= max_batches:
                return
