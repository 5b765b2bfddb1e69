"""Built-in datasets (counterpart of ``paddle_tpu/vision/datasets.py``, a
copy: the file is numpy): ``MNIST``, ``FashionMNIST``, ``Cifar10``,
``Cifar100``, ``Flowers``, ``VOC2012``, ``DatasetFolder`` and
``ImageFolder``.

Downloads are disabled.  Each dataset reads local files (MNIST's idx
files, CIFAR's tarball, a folder of images); without a file, and unless
the environment sets ``PADDLE_TPU_SYNTHETIC_DATA=0``, it makes JAX's
deterministic synthetic set of the right shapes (class prototypes from a
fixed seed plus noise; the same arrays as JAX's), so training pipelines
and benchmarks run everywhere.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Callable, Optional

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "ImageFolder",
           "DatasetFolder", "Flowers", "VOC2012"]


def _synthetic_ok(path) -> bool:
    return path is None and (
        os.environ.get("PADDLE_TPU_SYNTHETIC_DATA", "1") == "1")


class MNIST(Dataset):
    """28 x 28 grayscale digits: ``(image [1, 28, 28] f32, label int64)``;
    the synthetic set has 2,048 train and 512 test samples."""

    NUM_CLASSES = 10
    IMAGE_SHAPE = (1, 28, 28)
    N_SYNTH = {"train": 2048, "test": 512}

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform: Optional[Callable] = None, download=False,
                 backend=None):
        self.mode = mode
        self.transform = transform
        self.backend = backend or "cv2"
        if image_path is not None and label_path is not None:
            self.images = self._read_images(image_path)
            self.labels = self._read_labels(label_path)
        elif _synthetic_ok(image_path):
            n = self.N_SYNTH.get(mode, 512)
            # class prototypes are shared across train/test (same task);
            # only labels and noise differ per split
            proto_rng = np.random.RandomState(12345)
            base = proto_rng.rand(self.NUM_CLASSES, *self.IMAGE_SHAPE) \
                .astype("float32")
            rng = np.random.RandomState(0 if mode == "train" else 1)
            self.labels = rng.randint(0, self.NUM_CLASSES,
                                      n).astype("int64")
            noise = rng.rand(n, *self.IMAGE_SHAPE).astype("float32") * 0.3
            self.images = (base[self.labels] * 0.7 + noise)
        else:
            raise RuntimeError(
                "MNIST: provide image_path/label_path (downloads disabled "
                "in this environment) or enable synthetic data")

    def _read_images(self, path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return (data.reshape(n, 1, rows, cols).astype("float32") / 255.0)

    def _read_labels(self, path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n = struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.astype("int64")

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(label, dtype="int64")

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class _CifarBase(Dataset):
    NUM_CLASSES = 10
    IMAGE_SHAPE = (3, 32, 32)
    N_SYNTH = {"train": 1024, "test": 256}

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        self.mode = mode
        self.transform = transform
        if data_file is not None:
            import pickle
            import tarfile
            images, labels = [], []
            with tarfile.open(data_file) as tar:
                names = [m for m in tar.getmembers()
                         if ("data_batch" in m.name if mode == "train"
                             else "test_batch" in m.name)
                         or (self.NUM_CLASSES == 100 and
                             (mode if mode != "test" else "test")
                             in m.name and m.isfile())]
                for m in names:
                    d = pickle.load(tar.extractfile(m), encoding="bytes")
                    images.append(np.asarray(d[b"data"]))
                    key = b"labels" if b"labels" in d else b"fine_labels"
                    labels.extend(d[key])
            self.images = (np.concatenate(images).reshape(
                -1, 3, 32, 32).astype("float32") / 255.0)
            self.labels = np.asarray(labels, dtype="int64")
        elif _synthetic_ok(data_file):
            n = self.N_SYNTH.get(mode, 256)
            proto_rng = np.random.RandomState(54321)
            base = proto_rng.rand(self.NUM_CLASSES, *self.IMAGE_SHAPE) \
                .astype("float32")
            rng = np.random.RandomState(0 if mode == "train" else 1)
            self.labels = rng.randint(0, self.NUM_CLASSES,
                                      n).astype("int64")
            noise = rng.rand(n, *self.IMAGE_SHAPE).astype("float32") * 0.3
            self.images = (base[self.labels] * 0.7 + noise)
        else:
            raise RuntimeError("Cifar: provide data_file (downloads "
                               "disabled) or enable synthetic data")

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(self.labels[idx], dtype="int64")

    def __len__(self):
        return len(self.images)


class Cifar10(_CifarBase):
    NUM_CLASSES = 10


class Cifar100(_CifarBase):
    NUM_CLASSES = 100


class Flowers(_CifarBase):
    NUM_CLASSES = 102
    IMAGE_SHAPE = (3, 64, 64)
    N_SYNTH = {"train": 510, "test": 102, "valid": 102}


class VOC2012(_CifarBase):
    NUM_CLASSES = 21
    IMAGE_SHAPE = (3, 64, 64)


class DatasetFolder(Dataset):
    """A class-per-subdirectory image tree."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        extensions = extensions or (".png", ".jpg", ".jpeg", ".bmp",
                                    ".npy")
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(extensions):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image
            img = np.asarray(Image.open(path).convert("RGB"),
                             dtype="float32") / 255.0
            return img.transpose(2, 0, 1)
        except ImportError:
            raise RuntimeError("PIL unavailable; use .npy images")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(DatasetFolder):
    """Images without labels."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        extensions = extensions or (".png", ".jpg", ".jpeg", ".bmp",
                                    ".npy")
        self.samples = [os.path.join(root, f)
                        for f in sorted(os.listdir(root))
                        if f.lower().endswith(extensions)]
        self.loader = loader or DatasetFolder._default_loader

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)
