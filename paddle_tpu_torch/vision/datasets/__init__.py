"""Vision datasets of the port (`paddle_tpu/vision/datasets/__init__.py`;
reference `python/paddle/vision/datasets/`): `MNIST` and `FashionMNIST`
read from local idx files when given; they, `Cifar10`/`Cifar100`,
`Flowers` and `VOC2012` are otherwise the JAX package's deterministic
synthetic samples (nothing downloads). `ImageFolder` and `DatasetFolder`
read local image files (PIL, imported when an image is read). Samples are
numpy arrays: a transform runs in the DataLoader's workers, which touch
no card."""

import gzip
import os
import struct

import numpy as np

from paddle_tpu_torch.io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "ImageFolder",
           "DatasetFolder", "Flowers", "VOC2012"]


class MNIST(Dataset):
    """reference: `python/paddle/vision/datasets/mnist.py:41`"""

    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.images, self.labels = self._load(image_path, label_path, mode)

    def _load(self, image_path, label_path, mode):
        if image_path and label_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), np.uint8)
            return images.astype(np.float32) / 255.0, labels.astype(np.int64)
        # synthetic fallback: class-dependent patterns, deterministic
        n = 2048 if mode == "train" else 512
        rng = np.random.RandomState(0 if mode == "train" else 1)
        labels = rng.randint(0, 10, n).astype(np.int64)
        images = rng.rand(n, 28, 28).astype(np.float32) * 0.1
        for i, l in enumerate(labels):
            images[i, (l * 2):(l * 2 + 6), 4:24] += 0.8  # class-coded stripe
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx][None]  # [1, 28, 28]
        label = np.asarray([self.labels[idx]], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    """reference: `python/paddle/vision/datasets/cifar.py`"""

    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None, download=True,
                 backend=None):
        self.transform = transform
        n = 2048 if mode == "train" else 512
        rng = np.random.RandomState(2 if mode == "train" else 3)
        self.labels = rng.randint(0, self.NUM_CLASSES, n).astype(np.int64)
        self.images = rng.rand(n, 3, 32, 32).astype(np.float32) * 0.1
        for i, l in enumerate(self.labels):
            self.images[i, l % 3, (l * 3):(l * 3 + 2), :] += 0.9

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], np.int64)

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class ImageFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None, is_valid_file=None):
        self.samples = []
        self.transform = transform
        if os.path.isdir(root):
            for dirpath, _, files in os.walk(root):
                for f in sorted(files):
                    self.samples.append(os.path.join(dirpath, f))

    def __getitem__(self, idx):
        path = self.samples[idx]
        img = np.asarray(_load_image(path))
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None, is_valid_file=None):
        self.classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))) if os.path.isdir(root) else []
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples = []
        self.transform = transform
        for c in self.classes:
            cdir = os.path.join(root, c)
            for f in sorted(os.listdir(cdir)):
                self.samples.append((os.path.join(cdir, f), self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = np.asarray(_load_image(path))
        if self.transform is not None:
            img = self.transform(img)
        return img, target

    def __len__(self):
        return len(self.samples)


def _load_image(path):
    try:
        from PIL import Image

        return Image.open(path).convert("RGB")
    except Exception:
        return np.zeros((32, 32, 3), np.uint8)


class Flowers(Dataset):
    """reference vision/datasets/flowers.py (Oxford 102 flowers).
    Synthetic stand-in (zero-egress image): class-coded color fields at
    the real 3xHxW shape and 102-class label space."""

    N_CLASSES = 102

    def __init__(self, mode="train", transform=None, backend=None,
                 image_size=64, n_items=128):
        rng = np.random.default_rng(0 if mode == "train" else 1)
        n = n_items if mode == "train" else max(16, n_items // 4)
        self.labels = rng.integers(0, self.N_CLASSES, n).astype("int64")
        hue = (self.labels[:, None, None, None] / self.N_CLASSES)
        base = rng.random((n, 3, image_size, image_size)).astype("float32")
        self.images = (0.5 * base + 0.5 * hue).astype("float32")
        self.transform = transform

    def __getitem__(self, idx):
        img, lab = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, lab

    def __len__(self):
        return len(self.labels)


class VOC2012(Dataset):
    """reference vision/datasets/voc2012.py: segmentation pairs
    (image, mask). Synthetic stand-in: images with a class-coded
    rectangle and the matching 21-class mask."""

    N_CLASSES = 21

    def __init__(self, mode="train", transform=None, backend=None,
                 image_size=64, n_items=64):
        rng = np.random.default_rng(0 if mode == "train" else 1)
        n = n_items if mode == "train" else max(8, n_items // 4)
        s = image_size
        self.images = rng.random((n, 3, s, s)).astype("float32") * 0.3
        self.masks = np.zeros((n, s, s), "int64")
        for i in range(n):
            cls = int(rng.integers(1, self.N_CLASSES))
            x0, y0 = rng.integers(0, s // 2, 2)
            h, w = rng.integers(s // 4, s // 2, 2)
            self.images[i, :, y0:y0 + h, x0:x0 + w] += cls / self.N_CLASSES
            self.masks[i, y0:y0 + h, x0:x0 + w] = cls
        self.transform = transform

    def __getitem__(self, idx):
        img, mask = self.images[idx], self.masks[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self.images)
