"""paddle.vision of the port (`paddle_tpu/vision/`; reference
`python/paddle/vision/`): `models` (the JAX package's zoo: ResNet, VGG,
MobileNet v1-v3, ShuffleNetV2, SqueezeNet, DenseNet, AlexNet, GoogLeNet,
InceptionV3, ViT, LeNet), `datasets`, `transforms` (numpy, host side),
`ops` (detection and RoI ops in plain torch) and the image backend."""

from paddle_tpu_torch.vision import datasets, models, ops, transforms  # noqa: F401

_image_backend = "pil"


def set_image_backend(backend):
    if backend not in ("pil", "cv2", "tensor"):
        raise ValueError(
            f"Expected backend 'pil', 'cv2' or 'tensor', got {backend!r}")
    if backend == "cv2":
        raise ValueError(
            "cv2 is not available in this image; use 'pil' or 'tensor'")
    global _image_backend
    _image_backend = backend


def get_image_backend():
    return _image_backend


def image_load(path, backend=None):
    """reference vision/image.py image_load: a PIL image (or an HWC Tensor
    with backend='tensor', on the creation place). PIL is imported here,
    in the call."""
    from PIL import Image

    backend = backend or _image_backend
    img = Image.open(path)
    if backend == "tensor":
        import numpy as np

        import paddle_tpu_torch as paddle

        return paddle.to_tensor(np.asarray(img))
    return img
