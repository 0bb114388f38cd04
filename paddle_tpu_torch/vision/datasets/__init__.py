"""Vision datasets of the port (`paddle_tpu/vision/datasets/__init__.py`;
reference `python/paddle/vision/datasets/mnist.py:41`): `MNIST` and
`FashionMNIST`, read from local idx files when given, else the JAX
package's deterministic synthetic sample (no download). The other
datasets are ported with ROADMAP A10d."""

import gzip
import os
import struct

import numpy as np

from paddle_tpu_torch.io import Dataset

__all__ = ["MNIST", "FashionMNIST"]


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
