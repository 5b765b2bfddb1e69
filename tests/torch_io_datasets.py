"""Datasets and worker functions for tests/test_torch_io.py and
tests/test_torch_hapi.py, in a module of their own that imports neither
``jax`` nor ``paddle_tpu``: a spawned DataLoader worker imports the
module that defines its dataset, and should start with the port alone."""

import os

import numpy as np

from paddle_tpu_torch.io import Dataset, get_worker_info


class RangeDS(Dataset):
    def __init__(self, n=64):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((4,), i, dtype="float32"),
                np.array([i % 10], dtype="int64"))


class FailingDS(RangeDS):
    def __getitem__(self, i):
        if i == 13:
            raise ValueError("poison sample")
        return super().__getitem__(i)


class InfoDS(RangeDS):
    """Each sample with the worker that made it, the worker count and
    whether CUDA was initialised in that process."""

    def __getitem__(self, i):
        import torch
        info = get_worker_info()
        x, y = super().__getitem__(i)
        return (x, y, np.array([info.id, info.num_workers,
                                int(torch.cuda.is_initialized()),
                                os.getpid()], dtype="int64"))


class TouchInit:
    """A worker_init_fn that leaves a file per worker id."""

    def __init__(self, d):
        self.d = d

    def __call__(self, worker_id):
        open(os.path.join(self.d, f"w{worker_id}"), "w").close()


def double_collate(samples):
    xs = [s[0] for s in samples]
    return np.stack(xs) * 2.0


class ToyDS(Dataset):
    """32 samples of 8 features, labelled by the sign of their sum."""

    def __init__(self, n=32):
        rng = np.random.RandomState(0)
        self.x = rng.randn(n, 8).astype(np.float32)
        self.y = (self.x.sum(1) > 0).astype(np.int64)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]
