"""Data pipeline — the port of `paddle_tpu/io/__init__.py` (reference:
paddle.io, python/paddle/fluid/reader.py:311 DataLoader).

The loader builds numpy batches on the host and hands them out as torch
tensors on the host (float64 turned into float32, as the JAX package's
``_to_tensor_tree`` does; integer ids keep their type, which `embedding`
takes either way).  The caller moves a batch to the card once per step;
``hapi.Model`` does that.

The samplers draw from numpy's global stream (``np.random.permutation``,
``np.random.randint``, ``np.random.choice``), as the JAX package's do, so
``np.random.seed(s)`` gives both packages the same batches.

``num_workers > 0`` takes the JAX package's background-thread prefetch
pipeline (overlapping host batch assembly with the card's step), with the
``reader/wait_time`` histogram.  Still to come: the forked shared-memory
workers (``io/shm.py`` and ``csrc/shm_ring.cc``; ROADMAP Queue 1 item 11)
and ``DistributedBatchSampler`` (item 10).  ``use_shared_memory``,
``timeout``, ``worker_init_fn`` and ``shm_capacity`` are accepted and
serve only those workers, as in JAX, whose thread path does not read
them either.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time as _time

import numpy as np
import torch

from .. import monitor

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "random_split", "ConcatDataset",
    "BatchSampler", "Sampler", "SequenceSampler", "RandomSampler",
    "WeightedRandomSampler", "DataLoader", "default_collate_fn",
    "get_worker_info",
]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long arrays or tensors (numpy arrays or torch
    tensors on the host)."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self.cum[-1])

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if ds_idx == 0 else int(self.cum[ds_idx - 1])
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    # the reference API's contract: numpy's global stream
    perm = np.random.permutation(len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off : off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def get_worker_info():
    """None: no worker process builds batches yet (the thread path runs
    in this process, as the JAX package's does)."""
    return None


def default_collate_fn(batch):
    """Stack a list of samples: numpy arrays and scalars into one numpy
    array, torch tensors into one tensor, tuples, lists and dicts field
    by field."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def _to_tensor_tree(obj):
    """numpy arrays to host tensors, float64 (numpy or torch) to float32;
    tuples, lists and dicts element by element."""
    if isinstance(obj, np.ndarray):
        if obj.dtype == np.float64:
            obj = obj.astype(np.float32)
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, torch.Tensor):
        return obj.float() if obj.dtype == torch.float64 else obj
    if isinstance(obj, tuple):
        return tuple(_to_tensor_tree(o) for o in obj)
    if isinstance(obj, list):
        return [_to_tensor_tree(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_tensor_tree(v) for k, v in obj.items()}
    return obj


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, shm_capacity=64 << 20):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self.shm_capacity = shm_capacity
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        self.return_list = return_list

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("length of IterableDataset loader undefined")
        return len(self.batch_sampler)

    def _iter_batches_np(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        else:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])

    def __iter__(self):
        if self.num_workers <= 0:
            for batch in self._iter_batches_np():
                yield _to_tensor_tree(batch)
            return
        # background-thread prefetch pipeline (overlaps host batch
        # assembly with the card's step)
        q: "queue.Queue" = queue.Queue(
            maxsize=self.prefetch_factor * max(self.num_workers, 1))
        sentinel = object()
        error = []

        def producer():
            try:
                for batch in self._iter_batches_np():
                    q.put(batch)
            except BaseException as e:  # re-raised on the consumer thread
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        wait_h = monitor.histogram(
            "reader/wait_time",
            "seconds the consumer blocked on the reader per batch") \
            if monitor.enabled() else None
        while True:
            if wait_h is not None:
                tw0 = _time.perf_counter()
                item = q.get()
                wait_h.observe(_time.perf_counter() - tw0)
            else:
                item = q.get()
            if item is sentinel:
                if error:
                    raise error[0]
                break
            yield _to_tensor_tree(item)
