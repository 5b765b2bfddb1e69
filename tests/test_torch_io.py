"""The port's ``io`` (datasets, samplers, ``DataLoader`` and its workers),
``vision.datasets`` and ``vision.transforms`` held against paddle_tpu's.

Mirrors tests/test_dataloader_workers.py and JAX's sampler behaviour: the
samplers draw from numpy's global generator, so after the same
``np.random.seed`` both packages give the same indices and batches (held
exactly).  The worker path is the port's own transport (tensors in shared
memory on a ``torch.multiprocessing`` queue): its batches equal the
single-process ones, every batch is counted as having arrived in shared
memory, a worker's error reaches the caller with its traceback,
``worker_init_fn`` and ``get_worker_info`` work, a payload outside shared
memory raises, and ``shutdown`` stops the workers.  Spawned workers cost
an import of torch each, so one module fixture runs the main multiprocess
pass and several tests read it.  The transforms are held to JAX's at
1e-6 (``Resize`` at 1e-5: torch's antialiased bilinear filter against
``jax.image.resize``).
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import paddle_tpu as jp  # noqa: E402
import paddle_tpu.io as jio  # noqa: E402
import paddle_tpu_torch as tp  # noqa: E402
import paddle_tpu_torch.io as tio  # noqa: E402
from paddle_tpu.vision import datasets as jds  # noqa: E402
from paddle_tpu.vision import transforms as jT  # noqa: E402
from paddle_tpu_torch.framework import place as tplace  # noqa: E402
from paddle_tpu_torch.io import worker as tworker  # noqa: E402
from paddle_tpu_torch.vision import datasets as tds  # noqa: E402
from paddle_tpu_torch.vision import transforms as tT  # noqa: E402
from torch_io_datasets import (FailingDS, InfoDS, RangeDS,  # noqa: E402
                               TouchInit, double_collate)


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = tplace._current_place
    tp.set_device("cpu")
    yield
    tplace._current_place = prev


def _np(t):
    return np.asarray(t.numpy())


def _jds(n=40):
    class JRange(jio.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return RangeDS(n)[i]
    return JRange()


def _batches(loader):
    return [[_np(t) for t in b] for b in loader]


@pytest.mark.parametrize("kw", [dict(shuffle=True, batch_size=8),
                                dict(shuffle=True, batch_size=6,
                                     drop_last=True),
                                dict(shuffle=False, batch_size=7)],
                         ids=str)
def test_seeded_dataloader_batches_equal_jax(kw):
    np.random.seed(5)
    j = _batches(jio.DataLoader(_jds(), **kw))
    np.random.seed(5)
    t = _batches(tio.DataLoader(RangeDS(40), **kw))
    assert len(j) == len(t) == len(tio.DataLoader(RangeDS(40), **kw))
    for a, b in zip(j, t):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)


def _stream(mod, name, *args, **kwargs):
    np.random.seed(9)
    return list(getattr(mod, name)(*args, **kwargs))


@pytest.mark.parametrize("case", [
    ("RandomSampler", (list(range(20)),), {}),
    ("RandomSampler", (list(range(20)),), dict(replacement=True,
                                               num_samples=30)),
    ("SubsetRandomSampler", ([3, 5, 7, 11, 13],), {}),
    ("WeightedRandomSampler", ([0.1, 0.5, 0.2, 0.2], 12), {}),
    ("SequenceSampler", (list(range(6)),), {}),
    ("BatchSampler", (list(range(23)),), dict(shuffle=True, batch_size=5)),
    ("DistributedBatchSampler", (list(range(23)), 4), dict(shuffle=True)),
    ("DistributedBatchSampler", (list(range(23)), 4),
     dict(num_replicas=3, rank=1, drop_last=True)),
], ids=lambda c: c[0])
def test_samplers_draw_what_jax_draws(case):
    name, args, kw = case
    assert _stream(tio, name, *args, **kw) == _stream(jio, name, *args, **kw)


def test_datasets_and_random_split_equal_jax():
    xs = np.arange(12, dtype=np.float32).reshape(6, 2)
    ys = np.arange(6, dtype=np.int64)
    for mod, pkg in ((jio, jp), (tio, tp)):
        td = mod.TensorDataset([pkg.to_tensor(xs), pkg.to_tensor(ys)])
        assert len(td) == 6 and _np(td[4][0]).tolist() == [8.0, 9.0]
        cat = mod.ConcatDataset([RangeDS(3), RangeDS(4)])
        assert len(cat) == 7 and cat[5][0][0] == 2 and cat[-1][0][0] == 3
        comp = mod.ComposeDataset([RangeDS(5), RangeDS(6)])
        assert len(comp) == 5 and len(comp[2]) == 4
        sub = mod.Subset(RangeDS(10), [9, 1])
        assert sub[0][0][0] == 9 and len(sub) == 2
    np.random.seed(2)
    j = [d.indices for d in jio.random_split(RangeDS(10), [0.5, 0.3, 0.2])]
    np.random.seed(2)
    t = [d.indices for d in tio.random_split(RangeDS(10), [0.5, 0.3, 0.2])]
    assert t == j


def test_iterable_and_unbatched_loaders():
    class It(tio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(7, dtype=np.float32))

    assert [b.shape for b in tio.DataLoader(It(), batch_size=3,
                                            num_workers=2)] == \
        [[3], [3], [1]]
    assert len(list(tio.DataLoader(It(), batch_size=3,
                                   drop_last=True))) == 2
    raw = list(tio.DataLoader(RangeDS(3), batch_size=None))
    assert len(raw) == 3 and raw[1][0].shape == (4,)


def test_collate_structures():
    batch = [(np.zeros(3), {"a": 1}), (np.ones(3), {"a": 2})]
    out = tworker.np_collate(batch)
    assert out[0].shape == (2, 3) and out[1]["a"].tolist() == [1, 2]
    out = tio.default_collate_fn(batch)
    assert isinstance(out[0], tp.Tensor) and out[1]["a"].tolist() == [1, 2]
    stacked = tio.default_collate_fn([tp.to_tensor([1.0, 2.0]),
                                      tp.to_tensor([3.0, 4.0])])
    assert stacked.shape == [2, 2]


@pytest.fixture(scope="module")
def mp_pass(tmp_path_factory):
    """One spawned two-worker pass over InfoDS(40) with a worker_init_fn."""
    d = str(tmp_path_factory.mktemp("init"))
    before = tworker.shm_batches
    loader = tio.DataLoader(InfoDS(40), batch_size=8, num_workers=2,
                            worker_init_fn=TouchInit(d))
    batches = [[_np(t) for t in b] for b in loader]
    return dict(batches=batches, shm=tworker.shm_batches - before,
                touched=sorted(os.path.basename(p)
                               for p in glob.glob(os.path.join(d, "w*"))))


def test_multiprocess_equals_single_process(mp_pass):
    single = _batches(tio.DataLoader(RangeDS(40), batch_size=8))
    assert len(mp_pass["batches"]) == len(single) == 5
    for got, want in zip(mp_pass["batches"], single):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_every_worker_batch_came_through_shared_memory(mp_pass):
    assert mp_pass["shm"] == 5


def test_worker_init_fn_and_get_worker_info(mp_pass):
    assert mp_pass["touched"] == ["w0", "w1"]
    info = np.concatenate([b[2] for b in mp_pass["batches"]])
    assert set(info[:, 0].tolist()) == {0, 1}
    assert set(info[:, 1].tolist()) == {2}
    assert len(set(info[:, 3].tolist())) == 2
    assert os.getpid() not in set(info[:, 3].tolist())
    assert not info[:, 2].any()          # no worker initialised CUDA
    assert tio.get_worker_info() is None


def test_persistent_workers_serve_every_epoch():
    """One spawn: three epochs on the same two workers (the second
    abandoned after a batch), each as the in-process loader's."""
    loader = tio.DataLoader(InfoDS(24), batch_size=8, num_workers=2,
                            persistent_workers=True)
    single = _batches(tio.DataLoader(RangeDS(24), batch_size=8))
    first = _batches(loader)
    next(iter(loader))                   # an epoch abandoned mid-way
    third = _batches(loader)
    pids = {frozenset(np.concatenate([b[2] for b in run])[:, 3].tolist())
            for run in (first, third)}
    assert len(pids) == 1 and len(next(iter(pids))) == 2
    for run in (first, third):
        assert len(run) == 3
        for got, want in zip(run, single):
            np.testing.assert_array_equal(got[0], want[0])
    workers = loader._workers
    del loader
    assert not workers._procs


def test_worker_error_propagates():
    with pytest.raises(RuntimeError, match="poison sample"):
        list(tio.DataLoader(FailingDS(32), batch_size=8, num_workers=2))


def test_a_payload_outside_shared_memory_raises():
    """The parent's check, fed a pickled numpy payload (what a transport
    without shared memory would deliver) on a plain queue."""
    import queue
    assert tworker._all_shared([torch.zeros(2).share_memory_(),
                                {"a": torch.ones(1).share_memory_()}])
    assert not tworker._all_shared([torch.zeros(2)])
    assert not tworker._all_shared([np.zeros(2)])
    it = tworker.MultiprocessBatchIterator.__new__(
        tworker.MultiprocessBatchIterator)
    it._batches, it._send_idx, it._rcvd_idx, it._reorder = [[0]], 1, 0, {}
    it._procs, it._index_queues, it._num_workers = [], [], 1
    it._timeout, it._to_device = None, lambda x: x
    it._data_queue = queue.Queue()
    it._data_queue.put((0, [np.zeros(2, np.float32)]))
    with pytest.raises(RuntimeError, match="outside shared memory"):
        next(it)


def test_shutdown_stops_the_workers():
    it = tworker.MultiprocessBatchIterator(
        RangeDS(64), [[i, i + 1] for i in range(0, 64, 2)], num_workers=2,
        collate_fn=double_collate)
    first = next(it)
    assert first.is_shared() and first.tolist()[1] == [2.0] * 4
    procs = list(it._procs)
    it.shutdown()
    assert procs and not any(p.is_alive() for p in procs)
    it.shutdown()                        # idempotent


def test_thread_path_equals_single_process():
    threads = _batches(tio.DataLoader(RangeDS(30), batch_size=4,
                                      num_workers=3,
                                      use_shared_memory=False))
    single = _batches(tio.DataLoader(RangeDS(30), batch_size=4))
    assert len(threads) == len(single) == 8
    for got, want in zip(threads, single):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_unpicklable_collate_warns_and_forks():
    def collate(samples):
        return np.stack([s[0] for s in samples])

    with pytest.warns(RuntimeWarning, match="not picklable"):
        out = list(tio.DataLoader(RangeDS(8), batch_size=4, num_workers=2,
                                  collate_fn=collate))
    assert [b.shape for b in out] == [[4, 4], [4, 4]]


@pytest.mark.parametrize("cls,mode", [("MNIST", "train"), ("MNIST", "test"),
                                      ("Cifar10", "test"),
                                      ("Cifar100", "train")])
def test_synthetic_datasets_equal_jax(cls, mode):
    j = getattr(jds, cls)(mode=mode)
    t = getattr(tds, cls)(mode=mode)
    assert len(j) == len(t)
    np.testing.assert_array_equal(t.images, j.images)
    np.testing.assert_array_equal(t.labels, j.labels)
    x, y = t[3]
    assert x.dtype == np.float32 and y.dtype == np.int64


def test_mnist_reads_idx_files(tmp_path):
    import gzip
    import struct
    imgs = np.random.RandomState(0).randint(0, 256, (3, 28, 28), np.uint8)
    with gzip.open(tmp_path / "img.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 3, 28, 28) + imgs.tobytes())
    with gzip.open(tmp_path / "lab.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 3) + bytes([7, 1, 4]))
    t = tds.MNIST(str(tmp_path / "img.gz"), str(tmp_path / "lab.gz"))
    j = jds.MNIST(str(tmp_path / "img.gz"), str(tmp_path / "lab.gz"))
    np.testing.assert_array_equal(t.images, j.images)
    assert t.labels.tolist() == [7, 1, 4]


def _img(seed, shape=(3, 12, 10)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("name,args,tol", [
    ("Normalize", ([0.5, 0.4, 0.3], [0.2, 0.3, 0.4]), 1e-6),
    ("CenterCrop", (6,), 0), ("Pad", (2,), 0), ("Grayscale", (), 1e-6),
    ("Transpose", ((1, 2, 0),), 0), ("Resize", ((24, 20),), 1e-5),
    ("Resize", ((6, 5),), 1e-5)], ids=lambda v: str(v)[:20])
def test_transforms_equal_jax(name, args, tol):
    x = _img(1)
    got = getattr(tT, name)(*args)(x)
    want = np.asarray(getattr(jT, name)(*args)(x))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_random_transforms_draw_what_jax_draws():
    x = _img(2)
    for name, args in (("RandomCrop", (8,)), ("RandomHorizontalFlip", ()),
                       ("RandomErasing", (1.0,)),
                       ("ColorJitter", (0.4, 0.4, 0.4, 0.1))):
        np.random.seed(4)
        want = np.asarray(getattr(jT, name)(*args)(x))
        np.random.seed(4)
        got = getattr(tT, name)(*args)(x)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    u8 = (x * 255).astype(np.uint8).transpose(1, 2, 0)
    np.testing.assert_allclose(tT.ToTensor()(u8), np.asarray(jT.ToTensor()(u8)),
                               rtol=1e-6)
