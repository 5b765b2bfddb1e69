"""paddle.io: datasets, samplers and ``DataLoader``.

Counterpart of ``paddle_tpu/io/__init__.py``.  The datasets and samplers
are JAX's, line for line: the samplers draw from numpy's global generator,
so the same ``np.random.seed`` gives the same order on both sides.

``DataLoader`` takes one of three paths, JAX's:

* ``num_workers=0``: the batches are made in the caller's thread;
* ``num_workers > 0`` with ``use_shared_memory=True`` (the default): worker
  processes (``io/worker.py``) collate numpy batches and send them back
  through shared memory; the parent reorders them.  With
  ``persistent_workers=True`` the workers outlive an epoch and serve the
  next (JAX accepts the flag and starts them anew each epoch; a spawned
  worker's start costs an import of torch);
* ``num_workers > 0`` with ``use_shared_memory=False``: a thread pool of
  that many threads, ``prefetch_factor`` batches a thread in flight.

Every batch goes to the current place (``_tree_to_tensor``): the card
unless ``paddle.set_device("cpu")``.  An array bound for the card is first
copied into pinned memory, then copied to the card with
``non_blocking=True`` on the current stream, so the copy overlaps the
host's next work.  ``IterableDataset`` runs in the caller's thread, as in
JAX.
"""

from __future__ import annotations

import itertools
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Sequence

import numpy as np
import torch

from ..framework import place as places
from ..tensor.tensor import Tensor, wrap_array

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "DataLoader", "default_collate_fn",
           "get_worker_info", "SubsetRandomSampler"]


class Dataset:
    """Map-style dataset."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence[Tensor]):
        lens = {t.shape[0] for t in tensors}
        if len(lens) != 1:
            raise ValueError("tensors must share dim 0")
        self.tensors = list(tensors)

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
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
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
        self.cumsizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumsizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = int(np.searchsorted(self.cumsizes, idx, side="right"))
        prev = 0 if di == 0 else self.cumsizes[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if all(isinstance(n, float) for n in lengths):
        counts = [int(math.floor(total * n)) for n in lengths]
        for i in range(total - sum(counts)):
            counts[i % len(counts)] += 1
        lengths = counts
    if sum(lengths) != total:
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(total).tolist()
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n]))
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


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__(None)
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__(None)
        self.weights = np.asarray(
            weights.numpy() if isinstance(weights, Tensor) else weights,
            dtype="float64")
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
        super().__init__(dataset)
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else \
                SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

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


def _dist_world():
    """(world size, rank) of torch.distributed's default group, (1, 0)
    without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Shards the index stream across data-parallel ranks (JAX's rule; the
    ranks are torch.distributed's).  In one process it yields what a
    ``BatchSampler`` over the same order does."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _dist_world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n).tolist()
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
        indices += indices[: (self.total_size - n)]
        batch = []
        for idx in indices[self.local_rank::self.nranks]:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


class _WorkerInfo:
    def __init__(self, id=0, num_workers=1, dataset=None):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """The worker's ``id``, ``num_workers`` and ``dataset`` inside a
    DataLoader worker process, None elsewhere."""
    return _worker_info


def _to_place(arr) -> torch.Tensor:
    """A host array or CPU tensor on the current place: through pinned
    memory and a ``non_blocking`` copy when that is the card."""
    t = torch.from_numpy(np.ascontiguousarray(arr)) \
        if isinstance(arr, (np.ndarray, np.generic)) else arr
    dev = places.current_torch_device()
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _tree_to_tensor(batch):
    """A host batch (numpy arrays or CPU tensors, nested in lists, tuples
    and dicts) -> Tensors on the current place."""
    if isinstance(batch, (np.ndarray, np.generic, torch.Tensor)):
        return wrap_array(_to_place(batch))
    if isinstance(batch, (list, tuple)):
        return [_tree_to_tensor(b) for b in batch]
    if isinstance(batch, dict):
        return {k: _tree_to_tensor(v) for k, v in batch.items()}
    return batch


def default_collate_fn(batch: List[Any]):
    """Stack the samples' fields: numpy arrays and numbers into one array
    (then a Tensor on the current place), Tensors with ``stack``, lists /
    tuples field by field, dicts key by key."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return _tree_to_tensor(np.stack(batch))
    if isinstance(sample, Tensor):
        from ..tensor.manipulation import stack
        return stack(batch, axis=0)
    if isinstance(sample, (int, float)):
        return _tree_to_tensor(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch])
                for k in sample}
    return batch


class DataLoader:
    """Mirror of ``paddle.io.DataLoader`` (JAX's three paths, above)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(prefetch_factor, 2)
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self._workers = None          # the persistent workers' iterator
        self.is_iterable_ds = isinstance(dataset, IterableDataset)
        if self.is_iterable_ds:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
            self.batch_size = None
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __del__(self):
        if getattr(self, "_workers", None) is not None:
            try:
                self._workers.shutdown()
            except Exception:  # noqa: BLE001
                pass

    def __len__(self):
        if self.is_iterable_ds:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _iter_batches(self):
        if self.is_iterable_ds:
            it = iter(self.dataset)
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch or (len(batch) < self.batch_size and
                                 self.drop_last):
                    return
                yield self.collate_fn(batch)
        elif self.batch_sampler is None:
            for i in range(len(self.dataset)):
                yield self.dataset[i]
        else:
            for idx_batch in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idx_batch])

    def __iter__(self):
        if self.num_workers == 0 or self.is_iterable_ds:
            yield from self._iter_batches()
            return
        if self.use_shared_memory and self.batch_sampler is not None:
            from .worker import MultiprocessBatchIterator, np_collate
            it = self._workers
            if it is not None and it._procs:
                it.reset(list(self.batch_sampler))
            else:
                worker_collate = self.collate_fn \
                    if self.collate_fn is not default_collate_fn \
                    else np_collate
                it = MultiprocessBatchIterator(
                    self.dataset, list(self.batch_sampler),
                    collate_fn=worker_collate, num_workers=self.num_workers,
                    prefetch_factor=self.prefetch_factor,
                    worker_init_fn=self.worker_init_fn,
                    timeout=self.timeout, to_device=_tree_to_tensor,
                    persistent=self.persistent_workers)
                if self.persistent_workers:
                    self._workers = it
            try:
                yield from it
            finally:
                if not self.persistent_workers:
                    it.shutdown()
            return
        # the thread-pool path (use_shared_memory=False)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            sampler_iter = iter(self.batch_sampler)
            depth = self.num_workers * self.prefetch_factor

            def fetch(idx_batch):
                return self.collate_fn([self.dataset[i] for i in idx_batch])

            pending = [pool.submit(fetch, b)
                       for b in itertools.islice(sampler_iter, depth)]
            while pending:
                fut = pending.pop(0)
                nxt = next(sampler_iter, None)
                if nxt is not None:
                    pending.append(pool.submit(fetch, nxt))
                yield fut.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
