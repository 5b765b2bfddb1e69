"""DataLoader worker processes over shared memory.

Counterpart of ``paddle_tpu/io/worker.py`` with ``io/shm.py``: worker
processes take index batches from a queue each, collate them to numpy and
send them to the parent, which keeps the submission order, raises a
worker's error with its traceback and puts each batch on the device.

The transport is PyTorch's own: each worker copies a batch's arrays into
tensors in shared memory (``Tensor.share_memory_()``) and puts them on a
``torch.multiprocessing`` queue, whose pickler sends a file descriptor of
each tensor's storage instead of its bytes; the parent maps the same
pages.  That is what ``torch.utils.data`` does, and it takes no native
library of its own, where JAX's ring (``core/native/shmring.cc``) is built
C++.  The parent checks that every array of every batch arrived in shared
memory and raises otherwise (no quiet fall back to pickled payloads);
:data:`shm_batches` counts the batches that did.

Workers start with the spawn method by default (a fork of a process whose
CUDA context or threads are up is unsafe), or fork when the dataset or
the functions cannot be pickled (with a warning, as in JAX) or the
``PADDLE_TPU_MP_CONTEXT`` environment variable says so.  A worker never
touches CUDA: it sets the port's place to the CPU and makes only CPU
tensors; importing ``paddle_tpu_torch`` makes no CUDA call.
"""

from __future__ import annotations

import os
import queue as queue_mod
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.multiprocessing as tmp

__all__ = ["np_collate", "MultiprocessBatchIterator", "shm_batches"]

# batches that reached a parent with every array in shared memory
shm_batches = 0


def np_collate(batch: List[Any]):
    """``default_collate_fn`` that stays in numpy (nothing on a device)."""
    sample = batch[0]
    if hasattr(sample, "numpy") and not isinstance(sample, np.ndarray):
        return np.stack([np.asarray(s.numpy()) for s in batch])
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack(batch)
    if isinstance(sample, (int, float)):
        return np.asarray(batch)
    if isinstance(sample, (list, tuple)):
        return [np_collate(list(items)) for items in zip(*batch)]
    if isinstance(sample, dict):
        return {k: np_collate([d[k] for d in batch]) for k in sample}
    return batch


class _WorkerError:
    def __init__(self, exc):
        self.msg = "".join(traceback.format_exception(exc))


def _to_shared(x):
    """A collated batch with each array (or Tensor) copied into a CPU
    tensor in shared memory."""
    if hasattr(x, "numpy") and not isinstance(x, (np.ndarray, np.generic,
                                                  torch.Tensor)):
        x = np.asarray(x.numpy())
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.ascontiguousarray(x)).share_memory_()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().share_memory_()
    if isinstance(x, (list, tuple)):
        return [_to_shared(v) for v in x]
    if isinstance(x, dict):
        return {k: _to_shared(v) for k, v in x.items()}
    return x


def _all_shared(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_shared()
    if isinstance(x, np.ndarray):
        return False
    if isinstance(x, (list, tuple)):
        return all(_all_shared(v) for v in x)
    if isinstance(x, dict):
        return all(_all_shared(v) for v in x.values())
    return True


def _worker_loop(dataset, index_queue, data_queue, collate_fn,
                 worker_init_fn, worker_id, num_workers, base_seed):
    np.random.seed((base_seed + worker_id) % (2 ** 32))
    torch.set_num_threads(1)
    try:
        from .. import io as _io
        from ..framework import place as _places
        _places.set_device("cpu")
        _io._worker_info = _io._WorkerInfo(
            id=worker_id, num_workers=num_workers, dataset=dataset)
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
    except Exception as e:  # noqa: BLE001
        data_queue.put((-1, _WorkerError(e)))
        return
    while True:
        try:
            job = index_queue.get()
        except (EOFError, KeyboardInterrupt):
            return
        if job is None:
            return
        batch_idx, idx_batch = job
        try:
            batch = _to_shared(collate_fn([dataset[i] for i in idx_batch]))
        except Exception as e:  # noqa: BLE001
            data_queue.put((batch_idx, _WorkerError(e)))
        else:
            data_queue.put((batch_idx, batch))


def _start_method(dataset, collate_fn, worker_init_fn, mp_context):
    env_method = os.environ.get("PADDLE_TPU_MP_CONTEXT")
    method = mp_context or env_method or "spawn"
    if method != "spawn" or mp_context is not None or env_method is not None:
        return method
    import pickle

    class _Null:
        def write(self, _):
            return None

    try:
        pickle.Pickler(_Null(), protocol=pickle.HIGHEST_PROTOCOL).dump(
            (dataset, collate_fn, worker_init_fn))
    except Exception:  # noqa: BLE001
        import warnings
        warnings.warn(
            "DataLoader: dataset/collate_fn/worker_init_fn is not "
            "picklable, so worker processes fall back to fork().  Define "
            "them at module level to use the spawn default.",
            RuntimeWarning, stacklevel=4)
        return "fork"
    return "spawn"


class MultiprocessBatchIterator:
    """The collated batches of ``batch_indices`` from worker processes, in
    submission order, each passed through ``to_device`` in the parent.

    ``persistent=True`` keeps the workers when the batches run out:
    ``reset(batch_indices)`` starts the next epoch on them (each job is
    tagged with its epoch, so what an abandoned epoch left in flight is
    dropped).  ``shutdown`` stops them."""

    def __init__(self, dataset, batch_indices, collate_fn=None,
                 num_workers: int = 2, prefetch_factor: int = 2,
                 worker_init_fn: Optional[Callable] = None,
                 timeout: float = 0,
                 to_device: Optional[Callable] = None,
                 mp_context: Optional[str] = None,
                 persistent: bool = False):
        self._persistent = persistent
        self._collate = collate_fn or np_collate
        self._timeout = timeout or None
        self._to_device = to_device or (lambda x: x)
        ctx = tmp.get_context(_start_method(dataset, self._collate,
                                            worker_init_fn, mp_context))
        self._num_workers = max(1, num_workers)
        self._data_queue = ctx.Queue()
        self._index_queues = []
        self._procs = []
        base_seed = int.from_bytes(os.urandom(4), "little")
        for wid in range(self._num_workers):
            iq = ctx.Queue()
            p = ctx.Process(
                target=_worker_loop,
                args=(dataset, iq, self._data_queue, self._collate,
                      worker_init_fn, wid, self._num_workers, base_seed),
                daemon=True)
            p.start()
            self._index_queues.append(iq)
            self._procs.append(p)
        self._depth = self._num_workers * max(prefetch_factor, 2)
        self._epoch = 0
        self._begin(batch_indices)

    def _begin(self, batch_indices):
        self._batches = list(batch_indices)
        self._send_idx = 0
        self._rcvd_idx = 0
        self._reorder = {}
        for _ in range(min(self._depth, len(self._batches))):
            self._dispatch()

    def reset(self, batch_indices):
        """The next epoch, over ``batch_indices``, on the same workers."""
        if not self._procs:
            raise RuntimeError("the DataLoader workers were shut down")
        self._epoch += 1
        self._begin(batch_indices)

    def _dispatch(self):
        if self._send_idx < len(self._batches):
            wid = self._send_idx % self._num_workers
            self._index_queues[wid].put(
                ((self._epoch, self._send_idx),
                 self._batches[self._send_idx]))
            self._send_idx += 1

    def __iter__(self):
        return self

    def _fail(self, msg):
        self.shutdown()
        raise RuntimeError(msg) from None

    def __next__(self):
        global shm_batches
        if self._rcvd_idx >= len(self._batches):
            if not self._persistent:
                self.shutdown()
            raise StopIteration
        waited = 0.0
        while self._rcvd_idx not in self._reorder:
            try:
                idx, payload = self._data_queue.get(timeout=5.0)
            except queue_mod.Empty:
                waited += 5.0
                dead = [p for p in self._procs if not p.is_alive()]
                if dead:
                    self._fail("DataLoader worker exited abnormally (exit "
                               f"codes {[p.exitcode for p in dead]})")
                if self._timeout and waited >= self._timeout:
                    self._fail(f"DataLoader worker timed out after "
                               f"{self._timeout}s")
                continue
            if isinstance(payload, _WorkerError):
                self._fail("DataLoader worker raised:\n" + payload.msg)
            if not _all_shared(payload):
                self._fail("a DataLoader batch arrived outside shared "
                           "memory")
            epoch, idx = idx
            if epoch != self._epoch:        # left by an abandoned epoch
                continue
            shm_batches += 1
            self._reorder[idx] = payload
        batch = self._reorder.pop(self._rcvd_idx)
        self._rcvd_idx += 1
        self._dispatch()
        return self._to_device(batch)

    def shutdown(self):
        for iq in self._index_queues:
            try:
                iq.put(None)
            except Exception:  # noqa: BLE001
                pass
        for p in self._procs:
            p.join(timeout=1.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        self._procs = []
        self._reorder = {}

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001
            pass
