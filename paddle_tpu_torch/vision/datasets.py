"""Vision datasets — the port of `paddle_tpu/vision/datasets.py`: `MNIST`,
`FashionMNIST`, `Cifar10` and `Cifar100`, numpy on the host.

A dataset reads its files where they already are on disk (the IDX files
of MNIST under ``$PTPU_DATA_HOME/mnist`` or explicit paths, a CIFAR
tarball given as ``data_file``); nothing is ever downloaded, and
``download=True`` only means "use a file if it is there".  Without the
files a dataset holds a deterministic synthetic sample with the right
shapes and label space (``.synthetic`` True), bit for bit the JAX
package's (`_synthetic_images`): the same images and labels from the same
seeds, so both packages train on the same data.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100"]

_CACHE = os.path.expanduser(os.environ.get("PTPU_DATA_HOME",
                                           "~/.cache/paddle_tpu"))


def _synthetic_images(n, shape, num_classes, seed):
    """``n`` uint8 images of ``shape`` (noise below 80) and int64 labels
    from ``np.random.RandomState(seed)``; each image carries a bright band
    (230) at rows picked by its class, so small models can fit them
    quickly."""
    rng = np.random.RandomState(seed)
    images = (rng.rand(n, *shape) * 80).astype(np.uint8)
    labels = rng.randint(0, num_classes, size=(n,)).astype(np.int64)
    h = shape[0]
    band = max(h // num_classes, 1)
    for i in range(n):
        c = int(labels[i])
        r0 = (c * band) % (h - band + 1)
        images[i, r0:r0 + band, ...] = 230
    return images, labels


class MNIST(Dataset):
    """(image [1, 28, 28] float32 in [0, 1], label [1] int64) pairs: the
    IDX files (gzipped or not) where both exist, else ``size`` synthetic
    ones (at most 2048 by default; seed 42 for ``"train"``, 7 else)."""
    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="cv2", size=None):
        self.mode = mode
        self.transform = transform
        self.synthetic = False
        n_default = 60000 if mode == "train" else 10000
        stem = "train" if mode == "train" else "t10k"
        img_p = image_path or os.path.join(
            _CACHE, "mnist", f"{stem}-images-idx3-ubyte.gz")
        lbl_p = label_path or os.path.join(
            _CACHE, "mnist", f"{stem}-labels-idx1-ubyte.gz")
        if os.path.exists(img_p) and os.path.exists(lbl_p):
            images = self._read_idx_images(img_p)
            labels = self._read_idx_labels(lbl_p)
        else:
            self.synthetic = True
            n = size or min(n_default, 2048)
            images, labels = _synthetic_images(
                n, (28, 28), 10, seed=42 if mode == "train" else 7)
        self.images = images
        self.labels = labels

    @staticmethod
    def _read_idx_images(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, rows, cols)

    @staticmethod
    def _read_idx_labels(path):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None, :, :] / 255.0
        label = np.array([self.labels[idx]], dtype=np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    """(image [3, 32, 32] float32 in [0, 1], label [1] int64) pairs: the
    python-pickle batches of the tarball ``data_file`` where it exists
    (``data_batch_1`` .. ``5`` for ``"train"``, else ``test_batch``), else
    ``size`` synthetic ones (1024 by default; seed 13 for ``"train"``, 17
    else)."""
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2", size=None):
        self.mode = mode
        self.transform = transform
        self.synthetic = True
        n = size or 1024
        self.images, self.labels = _synthetic_images(
            n, (32, 32, 3), self.NUM_CLASSES,
            seed=13 if mode == "train" else 17)
        if data_file and os.path.exists(data_file):
            with tarfile.open(data_file) as tf:
                imgs, lbls = [], []
                names = ([f"data_batch_{i}" for i in range(1, 6)]
                         if mode == "train" else ["test_batch"])
                for m in tf.getmembers():
                    if os.path.basename(m.name) in names:
                        d = pickle.load(tf.extractfile(m), encoding="bytes")
                        imgs.append(d[b"data"].reshape(-1, 3, 32, 32)
                                    .transpose(0, 2, 3, 1))
                        lbls.extend(d.get(b"labels", d.get(b"fine_labels")))
                if imgs:
                    self.images = np.concatenate(imgs)
                    self.labels = np.asarray(lbls, np.int64)
                    self.synthetic = False

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32).transpose(2, 0, 1) / 255.0
        label = np.array([self.labels[idx]], dtype=np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100
