"""Vision transforms over numpy arrays (`paddle_tpu/vision/transforms/`;
reference `python/paddle/vision/transforms/`). Host-side preprocessing in
numpy, run in the DataLoader's workers: `ToTensor` returns a numpy CHW
float array, as in the JAX package, and nothing here makes a card tensor.
The random transforms draw from numpy's global RNG with the JAX package's
calls in its order, so under one `np.random.seed` both give the same
images. `Resize` is the JAX package's `jax.image.resize(..., "linear")`
written in numpy: a triangle kernel at half-pixel centres, widened by the
scale when downsampling (antialiased)."""

import math
import numbers

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img, np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and arr.shape[-1] in (1, 3, 4) and self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return arr


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img, np.float32)
        if self.data_format == "CHW":
            shape = [-1] + [1] * (arr.ndim - 1)
        else:
            shape = [1] * (arr.ndim - 1) + [-1]
        return (arr - self.mean.reshape(shape)) / self.std.reshape(shape)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img, np.float32)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        if chw:
            out_shape = (arr.shape[0],) + self.size
        else:
            out_shape = self.size + ((arr.shape[-1],) if arr.ndim == 3 else ())
        return _resize_linear(arr, out_shape)


_F32_EPS = float(np.finfo(np.float32).eps)


def _weight_mat(n_in, n_out):
    """[n_in, n_out] f32 interpolation weights of one axis
    (`jax.image.scale.compute_weight_mat` with the triangle kernel and
    antialiasing)."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * _F32_EPS,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _resize_linear(arr, out_shape):
    """`jax.image.resize(arr, out_shape, "linear")` in numpy f32: each axis
    whose size changes contracted with its weight matrix."""
    out = arr.astype(np.float32)
    for d, (n_in, n_out) in enumerate(zip(arr.shape, out_shape)):
        if n_in == n_out:
            continue
        out = np.moveaxis(np.tensordot(out, _weight_mat(n_in, n_out),
                                       axes=([d], [0])), -1, d)
    return out


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        h, w = (arr.shape[1], arr.shape[2]) if chw else (arr.shape[0], arr.shape[1])
        th, tw = self.size
        i, j = max((h - th) // 2, 0), max((w - tw) // 2, 0)
        return arr[:, i:i + th, j:j + tw] if chw else arr[i:i + th, j:j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        h, w = (arr.shape[1], arr.shape[2]) if chw else (arr.shape[0], arr.shape[1])
        th, tw = self.size
        i = np.random.randint(0, max(h - th, 0) + 1)
        j = np.random.randint(0, max(w - tw, 0) + 1)
        return arr[:, i:i + th, j:j + tw] if chw else arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        arr = np.asarray(img)
        if np.random.rand() < self.prob:
            return arr[..., ::-1].copy()
        return arr


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        arr = np.asarray(img)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        if np.random.rand() < self.prob:
            return (arr[:, ::-1] if chw else arr[::-1]).copy()
        return arr


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return np.asarray(img).transpose(self.order)


def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


# the rest of the reference transforms surface
# (reference python/paddle/vision/transforms/transforms.py)

from paddle_tpu_torch.vision.transforms import functional as F  # noqa: E402
from paddle_tpu_torch.vision.transforms.functional import (  # noqa: E402,F401
    adjust_brightness, adjust_contrast, adjust_hue, affine, center_crop,
    crop, erase, hflip, pad, perspective, rotate, to_grayscale, vflip,
)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        # float v means jitter in [max(0, 1-v), 1+v]; an explicit
        # (lo, hi) tuple is passed through (reference _check_input)
        if isinstance(value, (list, tuple)):
            lo, hi = value
        else:
            if value < 0:
                raise ValueError("brightness value should be non-negative")
            lo, hi = max(0.0, 1 - value), 1 + value
        if lo > hi or lo < 0:
            raise ValueError(f"invalid brightness range {(lo, hi)}")
        self.value = (float(lo), float(hi))

    def _apply_image(self, img):
        lo, hi = self.value
        if lo == hi == 1.0:
            return img
        return F.adjust_brightness(img, np.random.uniform(lo, hi))


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        # float v means jitter in [max(0, 1-v), 1+v]; an explicit
        # (lo, hi) tuple is passed through (reference _check_input)
        if isinstance(value, (list, tuple)):
            lo, hi = value
        else:
            if value < 0:
                raise ValueError("contrast value should be non-negative")
            lo, hi = max(0.0, 1 - value), 1 + value
        if lo > hi or lo < 0:
            raise ValueError(f"invalid contrast range {(lo, hi)}")
        self.value = (float(lo), float(hi))

    def _apply_image(self, img):
        lo, hi = self.value
        if lo == hi == 1.0:
            return img
        return F.adjust_contrast(img, np.random.uniform(lo, hi))


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        # float v means jitter in [max(0, 1-v), 1+v]; an explicit
        # (lo, hi) tuple is passed through (reference _check_input)
        if isinstance(value, (list, tuple)):
            lo, hi = value
        else:
            if value < 0:
                raise ValueError("saturation value should be non-negative")
            lo, hi = max(0.0, 1 - value), 1 + value
        if lo > hi or lo < 0:
            raise ValueError(f"invalid saturation range {(lo, hi)}")
        self.value = (float(lo), float(hi))

    def _apply_image(self, img):
        lo, hi = self.value
        if lo == hi == 1.0:
            return img
        return F.adjust_saturation(img, np.random.uniform(lo, hi))


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        if not 0 <= value <= 0.5:
            raise ValueError("hue value should be in [0, 0.5]")
        self.value = float(value)

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return F.adjust_hue(img, np.random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    """Apply brightness/contrast/saturation/hue jitter in random order
    (reference transforms.ColorJitter)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.transforms = [BrightnessTransform(brightness),
                           ContrastTransform(contrast),
                           SaturationTransform(saturation),
                           HueTransform(hue)]

    def _apply_image(self, img):
        order = np.random.permutation(len(self.transforms))
        for idx in order:
            img = self.transforms[idx]._apply_image(img)
        return img


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return F.to_grayscale(img, self.num_output_channels)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding, self.fill, self.padding_mode = padding, fill, padding_mode

    def _apply_image(self, img):
        return F.pad(img, self.padding, self.fill, self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("degrees must be non-negative")
            degrees = (-degrees, degrees)
        self.degrees = tuple(degrees)
        self.expand, self.center, self.fill = expand, center, fill

    def _apply_image(self, img):
        angle = np.random.uniform(*self.degrees)
        return F.rotate(img, angle, expand=self.expand, center=self.center,
                        fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = tuple(degrees)
        self.translate, self.scale_rng, self.shear = translate, scale, shear
        self.fill, self.center = fill, center

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = (arr.shape[:2] if arr.ndim == 2 or arr.shape[-1] in (1, 3, 4)
                else arr.shape[1:3])
        angle = np.random.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = np.random.uniform(-self.translate[0], self.translate[0]) * w
            ty = np.random.uniform(-self.translate[1], self.translate[1]) * h
        scale = (np.random.uniform(*self.scale_rng)
                 if self.scale_rng is not None else 1.0)
        shear = (0.0, 0.0)
        if self.shear is not None:
            sh = self.shear
            if isinstance(sh, numbers.Number):
                sh = (-sh, sh)
            shear = (np.random.uniform(sh[0], sh[1]),
                     np.random.uniform(sh[2], sh[3]) if len(sh) == 4 else 0.0)
        return F.affine(img, angle, (tx, ty), scale, shear, fill=self.fill,
                        center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob, self.distortion_scale, self.fill = (
            prob, distortion_scale, fill)

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        arr = np.asarray(img)
        h, w = arr.shape[:2] if (arr.ndim == 2 or arr.shape[-1] in (1, 3, 4)) \
            else arr.shape[1:3]
        d = self.distortion_scale
        dx, dy = int(d * w / 2), int(d * h / 2)
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(np.random.randint(0, dx + 1), np.random.randint(0, dy + 1)),
               (w - 1 - np.random.randint(0, dx + 1),
                np.random.randint(0, dy + 1)),
               (w - 1 - np.random.randint(0, dx + 1),
                h - 1 - np.random.randint(0, dy + 1)),
               (np.random.randint(0, dx + 1),
                h - 1 - np.random.randint(0, dy + 1))]
        return F.perspective(img, start, end, fill=self.fill)


class RandomResizedCrop(BaseTransform):
    """Crop a random area/aspect patch and resize it (reference
    transforms.RandomResizedCrop — the ImageNet training crop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) \
            else tuple(size)
        self.scale, self.ratio = scale, ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = np.asarray(img)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4) \
            and arr.shape[-1] not in (1, 3, 4)
        h, w = (arr.shape[1], arr.shape[2]) if chw else arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = math.exp(np.random.uniform(math.log(self.ratio[0]),
                                            math.log(self.ratio[1])))
            cw = int(round(math.sqrt(target * ar)))
            ch = int(round(math.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                break
        else:
            cw, ch = min(w, h), min(w, h)
            i, j = (h - ch) // 2, (w - cw) // 2
        patch = arr[:, i:i + ch, j:j + cw] if chw \
            else arr[i:i + ch, j:j + cw]
        return Resize(self.size, self.interpolation)(patch)


class RandomErasing(BaseTransform):
    """Randomly blank a rectangle (reference transforms.RandomErasing;
    Zhong et al. 2017)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value, self.inplace = value, inplace

    def _apply_image(self, img):
        if np.random.rand() >= self.prob:
            return img
        arr = np.asarray(img if not hasattr(img, "numpy") else img.numpy())
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4) \
            and arr.shape[-1] not in (1, 3, 4)
        h, w = (arr.shape[1], arr.shape[2]) if chw else arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.random.uniform(*self.ratio)
            eh = int(round(math.sqrt(target / ar)))
            ew = int(round(math.sqrt(target * ar)))
            if eh < h and ew < w:
                i = np.random.randint(0, h - eh + 1)
                j = np.random.randint(0, w - ew + 1)
                if self.value == "random":
                    vshape = ((arr.shape[0], eh, ew) if chw
                              else (eh, ew) + ((arr.shape[2],)
                                               if arr.ndim == 3 else ()))
                    v = np.random.standard_normal(vshape).astype(np.float32)
                else:
                    v = self.value
                if chw:
                    out = arr.copy()
                    out[:, i:i + eh, j:j + ew] = v
                    return out
                return F.erase(img, i, j, eh, ew, v, inplace=self.inplace)
        return img

