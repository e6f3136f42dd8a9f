"""Batch loader: collates dataset samples into fixed-shape numpy batches.

Port of ``care_tpu/data/loader.py``.

Replaces torch ``DataLoader`` (reference ``dataloader.py:838-861``): train
batches are shuffled per epoch with a seeded RNG; all arrays in one batch
are stacked to static shapes so the jitted step functions never retrace.
The final partial batch is padded up to ``batch_size`` with repeated
samples and a ``batch_mask`` marks the real rows.
"""

from typing import Any, Dict, Iterator, List

import numpy as np

from care_tpu_torch.data.datasets import (JointDataset, TextOnlyDataset,
                                          VideoOnlyDataset)


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    first = samples[0]
    for key, val in first.items():
        if key == "feats":
            n_streams = len(val)
            out["feats"] = [np.stack([s["feats"][i] for s in samples])
                            for i in range(n_streams)]
        elif isinstance(val, list) and val and isinstance(val[0], np.ndarray):
            out[key] = [np.stack([s[key][i] for s in samples])
                        for i in range(len(val))]
        elif isinstance(val, np.ndarray):
            out[key] = np.stack([s[key] for s in samples])
        else:
            out[key] = [s[key] for s in samples]
    return out


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 seed: int = 0, drop_last: bool = False,
                 pad_to_batch: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = drop_last
        self.pad_to_batch = pad_to_batch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed * 100003 + self.epoch)
            rng.shuffle(order)
        bs = self.batch_size
        n_batches = len(self)
        for b in range(n_batches):
            idx = order[b * bs:(b + 1) * bs]
            real = len(idx)
            if self.pad_to_batch and real < bs:
                idx = np.concatenate([idx, order[:bs - real] if n >= bs
                                      else np.resize(idx, bs - real)])
            batch = collate([self.dataset[i] for i in idx])
            batch["batch_mask"] = (np.arange(len(idx)) < real)
            yield batch


class PrefetchIterator:
    """Background-thread prefetch: overlaps host-side sample assembly and
    HDF5 reads with the device's work (replaces the reference's torch
    DataLoader worker pool, ``dataloader.py:854-861``). The thread prepares
    host batches only; the consumer copies them to the card on its own
    thread, so every copy is ordered before the step that reads it. An
    error in the thread is raised by the consumer's next ``next``."""

    def __init__(self, iterable, prefetch: int = 2):
        import queue
        import threading
        self._queue = queue.Queue(maxsize=prefetch)
        self._sentinel = object()
        self._error = None

        def worker():
            try:
                for item in iterable:
                    self._queue.put(item)
            except Exception as e:  # re-raised in the consumer
                self._error = e
            finally:
                self._queue.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._sentinel:
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def prefetch(iterable, n: int = 2):
    return PrefetchIterator(iterable, prefetch=n)


def get_loader(opt: dict, mode: str, specific: int = -1,
               batch_size: int = None, not_shuffle: bool = False,
               is_validation: bool = False, all_caps: bool = False,
               dataset_type: str = "joint", pad_to_batch: bool = False,
               **kwargs) -> Loader:
    """reference ``dataloader.py:838-861``."""
    cls = {"joint": JointDataset, "video": VideoOnlyDataset,
           "text": TextOnlyDataset}[dataset_type]
    if dataset_type == "joint":
        dataset = cls(opt, mode, specific=specific,
                      is_validation=is_validation, all_caps=all_caps,
                      **kwargs)
    else:
        dataset = cls(opt, mode, specific=specific, **kwargs)
    bs = batch_size or opt.get("batch_size", 64)
    shuffle = (mode == "train") and not not_shuffle
    return Loader(dataset, bs, shuffle, seed=opt.get("seed", 0),
                  pad_to_batch=pad_to_batch)
