"""Functional vision transforms (`paddle_tpu/vision/transforms/
functional.py`; reference `python/paddle/vision/transforms/
functional{,_pil,_cv2,_tensor}.py`). One numpy implementation, the JAX
package's: inputs may be PIL images, numpy arrays (HWC or CHW), or port
Tensors; output matches the input family (PIL -> PIL, Tensor -> Tensor on
the input's place, ndarray -> ndarray). Geometric ops use an inverse-map
bilinear warp vectorized in numpy. This is host-side preprocessing: it
runs in DataLoader workers and touches no card (a Tensor comes back on the
place it came from). PIL is imported only for a PIL input."""

from __future__ import annotations

import math
import numbers

import numpy as np

__all__ = [
    "to_tensor", "normalize", "resize", "hflip", "vflip", "crop",
    "center_crop", "pad", "adjust_brightness", "adjust_contrast",
    "adjust_hue", "adjust_saturation", "to_grayscale", "rotate", "affine",
    "perspective", "erase",
]


def _unwrap(img):
    """-> (hwc float-preserving ndarray, restore_fn)."""
    try:
        from PIL import Image

        if isinstance(Image, type(None)):
            pass
    except ImportError:
        Image = None
    from paddle_tpu_torch.core.tensor import Tensor

    if Image is not None and hasattr(img, "convert") and hasattr(img, "size"):
        arr = np.asarray(img)
        mode = img.mode

        def restore(a):
            from PIL import Image as I

            return I.fromarray(np.clip(a, 0, 255).astype(np.uint8), mode)

        return arr, restore
    if isinstance(img, Tensor):
        arr = img.numpy()
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4) \
            and arr.shape[-1] not in (1, 3, 4)
        if chw:
            arr = arr.transpose(1, 2, 0)

            def restore(a):
                import paddle_tpu_torch as paddle

                return paddle.to_tensor(
                    np.ascontiguousarray(a.transpose(2, 0, 1)),
                    place=img.place)
        else:
            def restore(a):
                import paddle_tpu_torch as paddle

                return paddle.to_tensor(np.ascontiguousarray(a),
                                        place=img.place)

        return arr, restore
    arr = np.asarray(img)
    chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4) \
        and arr.shape[-1] not in (1, 3, 4)
    if chw:
        arr = arr.transpose(1, 2, 0)
        return arr, lambda a: np.ascontiguousarray(
            a.transpose(2, 0, 1)).astype(np.asarray(img).dtype, copy=False)
    return arr, lambda a: a.astype(arr.dtype, copy=False) \
        if np.issubdtype(arr.dtype, np.integer) else a


def _clip_like(a, ref_dtype):
    if np.issubdtype(ref_dtype, np.integer):
        return np.clip(a, 0, 255)
    return a


# -- already-present wrappers re-exported for the functional namespace ------

def to_tensor(pic, data_format="CHW"):
    from paddle_tpu_torch.vision.transforms import ToTensor

    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    from paddle_tpu_torch.vision.transforms import Normalize

    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    from paddle_tpu_torch.vision.transforms import Resize

    return Resize(size, interpolation)(img)


def hflip(img):
    arr, restore = _unwrap(img)
    return restore(arr[:, ::-1].copy())


def vflip(img):
    arr, restore = _unwrap(img)
    return restore(arr[::-1].copy())


def crop(img, top, left, height, width):
    arr, restore = _unwrap(img)
    return restore(arr[top:top + height, left:left + width].copy())


def center_crop(img, output_size):
    if isinstance(output_size, numbers.Number):
        output_size = (int(output_size), int(output_size))
    arr, restore = _unwrap(img)
    h, w = arr.shape[:2]
    th, tw = output_size
    return restore(arr[max((h - th) // 2, 0):max((h - th) // 2, 0) + th,
                       max((w - tw) // 2, 0):max((w - tw) // 2, 0) + tw]
                   .copy())


_PAD_MODES = {"constant": "constant", "edge": "edge",
              "reflect": "reflect", "symmetric": "symmetric"}


def pad(img, padding, fill=0, padding_mode="constant"):
    arr, restore = _unwrap(img)
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl, pt = padding
        pr, pb = padding
    else:
        pl, pt, pr, pb = padding
    widths = [(pt, pb), (pl, pr)] + [(0, 0)] * (arr.ndim - 2)
    mode = _PAD_MODES[padding_mode]
    kw = {"constant_values": fill} if mode == "constant" else {}
    return restore(np.pad(arr, widths, mode=mode, **kw))


def adjust_brightness(img, brightness_factor):
    arr, restore = _unwrap(img)
    out = arr.astype(np.float32) * brightness_factor
    return restore(_clip_like(out, arr.dtype))


def adjust_contrast(img, contrast_factor):
    arr, restore = _unwrap(img)
    f = arr.astype(np.float32)
    gray = f.mean() if f.ndim == 2 else (
        f[..., :3] @ np.array([0.299, 0.587, 0.114], np.float32)).mean()
    out = gray * (1 - contrast_factor) + f * contrast_factor
    return restore(_clip_like(out, arr.dtype))


def adjust_saturation(img, saturation_factor):
    arr, restore = _unwrap(img)
    f = arr.astype(np.float32)
    if f.ndim == 2:
        return restore(arr)
    gray = f[..., :3] @ np.array([0.299, 0.587, 0.114], np.float32)
    out = f.copy()
    out[..., :3] = (gray[..., None] * (1 - saturation_factor)
                    + f[..., :3] * saturation_factor)
    return restore(_clip_like(out, arr.dtype))


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5] turns), via vectorized
    RGB<->HSV (reference functional_tensor.adjust_hue)."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr, restore = _unwrap(img)
    f = arr.astype(np.float32)
    if f.ndim == 2:
        return restore(arr)
    scale = 255.0 if np.issubdtype(arr.dtype, np.integer) else 1.0
    rgb = f[..., :3] / scale
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    safe = np.where(diff == 0, 1.0, diff)
    h = np.select(
        [mx == r, mx == g],
        [((g - b) / safe) % 6.0, (b - r) / safe + 2.0],
        default=(r - g) / safe + 4.0) / 6.0
    h = np.where(diff == 0, 0.0, h)
    s = np.where(mx == 0, 0.0, diff / np.where(mx == 0, 1.0, mx))
    v = mx
    h = (h + hue_factor) % 1.0
    i = np.floor(h * 6.0)
    fr = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - fr * s)
    t = v * (1 - (1 - fr) * s)
    i = i.astype(np.int32) % 6
    out = np.stack([
        np.choose(i, [v, q, p, p, t, v]),
        np.choose(i, [t, v, v, q, p, p]),
        np.choose(i, [p, p, t, v, v, q]),
    ], axis=-1) * scale
    res = f.copy()
    res[..., :3] = out
    return restore(_clip_like(res, arr.dtype))


def to_grayscale(img, num_output_channels=1):
    arr, restore = _unwrap(img)
    f = arr.astype(np.float32)
    if f.ndim == 2:
        gray = f
    else:
        gray = f[..., :3] @ np.array([0.299, 0.587, 0.114], np.float32)
    out = np.repeat(gray[..., None], num_output_channels, axis=-1) \
        if num_output_channels > 1 else gray[..., None] \
        if arr.ndim == 3 else gray
    return restore(_clip_like(out, arr.dtype))


def _warp(arr, inv_matrix, fill=0.0):
    """Bilinear inverse warp: out[y, x] = in @ inv_matrix*(x, y, 1)."""
    h, w = arr.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ones = np.ones_like(xs)
    coords = np.stack([xs, ys, ones], axis=-1) @ np.asarray(
        inv_matrix, np.float32).T        # [h, w, 3]
    denom = coords[..., 2]
    sx = coords[..., 0] / np.where(denom == 0, 1.0, denom)
    sy = coords[..., 1] / np.where(denom == 0, 1.0, denom)
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    wx = sx - x0
    wy = sy - y0
    valid = (sx >= -1) & (sx <= w) & (sy >= -1) & (sy <= h)

    def sample(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = np.clip(xi, 0, w - 1)
        yi_c = np.clip(yi, 0, h - 1)
        v = arr[yi_c, xi_c].astype(np.float32)
        m = inside.astype(np.float32)
        return v * (m[..., None] if arr.ndim == 3 else m)

    wxe = wx[..., None] if arr.ndim == 3 else wx
    wye = wy[..., None] if arr.ndim == 3 else wy
    out = (sample(y0, x0) * (1 - wxe) * (1 - wye)
           + sample(y0, x0 + 1) * wxe * (1 - wye)
           + sample(y0 + 1, x0) * (1 - wxe) * wye
           + sample(y0 + 1, x0 + 1) * wxe * wye)
    if fill:
        ve = valid[..., None] if arr.ndim == 3 else valid
        out = np.where(ve, out, np.float32(fill))
    return out


def _affine_inv(angle, translate, scale, shear, center):
    """Inverse of the output->input affine map the reference composes
    (functional.affine: rot(angle) @ shear @ scale about center, then
    translate)."""
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    cx, cy = center
    tx, ty = translate
    # forward matrix M (input->output), reference cv2 convention
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    M = np.array([[scale * a, scale * b,
                   cx + tx - scale * (a * cx + b * cy)],
                  [scale * c, scale * d,
                   cy + ty - scale * (c * cx + d * cy)],
                  [0, 0, 1]], np.float32)
    return np.linalg.inv(M)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    arr, restore = _unwrap(img)
    h, w = arr.shape[:2]
    c = center or ((w - 1) * 0.5, (h - 1) * 0.5)
    inv = _affine_inv(-angle, (0, 0), 1.0, (0.0, 0.0), c)
    if expand:
        rad = math.radians(angle)
        nw = int(abs(w * math.cos(rad)) + abs(h * math.sin(rad)) + 0.5)
        nh = int(abs(h * math.cos(rad)) + abs(w * math.sin(rad)) + 0.5)
        shift = np.array([[1, 0, (w - nw) * 0.5], [0, 1, (h - nh) * 0.5],
                          [0, 0, 1]], np.float32)
        inv = inv @ shift
        padded = np.zeros((nh, nw) + arr.shape[2:], arr.dtype)
        out = _warp_into(arr, padded.shape[:2], inv, fill)
        return restore(_clip_like(out, arr.dtype))
    out = _warp(arr, inv, fill)
    return restore(_clip_like(out, arr.dtype))


def _warp_into(arr, out_hw, inv_matrix, fill=0.0):
    h, w = arr.shape[:2]
    oh, ow = out_hw
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float32)
    coords = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ np.asarray(
        inv_matrix, np.float32).T
    sx = coords[..., 0]
    sy = coords[..., 1]
    x0 = np.floor(sx).astype(np.int32)
    y0 = np.floor(sy).astype(np.int32)
    wx = sx - x0
    wy = sy - y0

    def sample(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = arr[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(
            np.float32)
        m = inside.astype(np.float32)
        return v * (m[..., None] if arr.ndim == 3 else m)

    wxe = wx[..., None] if arr.ndim == 3 else wx
    wye = wy[..., None] if arr.ndim == 3 else wy
    return (sample(y0, x0) * (1 - wxe) * (1 - wye)
            + sample(y0, x0 + 1) * wxe * (1 - wye)
            + sample(y0 + 1, x0) * (1 - wxe) * wye
            + sample(y0 + 1, x0 + 1) * wxe * wye)


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    arr, restore = _unwrap(img)
    h, w = arr.shape[:2]
    if isinstance(shear, numbers.Number):
        shear = (shear, 0.0)
    c = center or ((w - 1) * 0.5, (h - 1) * 0.5)
    inv = _affine_inv(angle, tuple(translate), scale, tuple(shear), c)
    return restore(_clip_like(_warp(arr, inv, fill), arr.dtype))


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Warp so that startpoints map to endpoints (reference
    functional.perspective): solve the 8-dof homography, then inverse
    sample."""
    arr, restore = _unwrap(img)
    A = []
    bv = []
    for (sx, sy), (ex, ey) in zip(startpoints, endpoints):
        A.append([sx, sy, 1, 0, 0, 0, -ex * sx, -ex * sy])
        bv.append(ex)
        A.append([0, 0, 0, sx, sy, 1, -ey * sx, -ey * sy])
        bv.append(ey)
    coeff = np.linalg.solve(np.asarray(A, np.float64),
                            np.asarray(bv, np.float64))
    H = np.append(coeff, 1.0).reshape(3, 3).astype(np.float32)
    inv = np.linalg.inv(H)
    return restore(_clip_like(_warp(arr, inv, fill), arr.dtype))


def erase(img, i, j, h, w, v, inplace=False):
    """Fill img[..., i:i+h, j:j+w] with v (reference functional.erase;
    Tensor path is CHW)."""
    from paddle_tpu_torch.core.tensor import Tensor

    if isinstance(img, Tensor):
        arr = img.numpy() if not inplace else img.numpy()
        chw = arr.ndim == 3
        val = np.broadcast_to(np.asarray(v, arr.dtype),
                              (arr.shape[0], h, w) if chw else (h, w))
        out = arr.copy()
        if chw:
            out[:, i:i + h, j:j + w] = val
        else:
            out[i:i + h, j:j + w] = val
        import paddle_tpu_torch as paddle

        res = paddle.to_tensor(out, place=img.place)
        if inplace:
            with paddle.no_grad():
                img._data.copy_(res._data)
            return img
        return res
    arr, restore = _unwrap(img)
    out = arr.copy()
    out[i:i + h, j:j + w] = np.asarray(v, out.dtype)
    return restore(out)
