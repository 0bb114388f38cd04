"""`vision.transforms`, `vision.datasets` and the image backend of the port
against the JAX package's on the CPU: every transform class and functional
transform on numpy HWC (uint8) and CHW (float32) images, the random ones
under one `np.random.seed` on both sides, equal bit for bit (Resize and
what resizes to f32 rtol 1e-6: the port's numpy contraction sums in another
order than XLA's einsum); a port Tensor keeps its place; each dataset by
value (the synthetic ones) or from files under tmp_path (the folder ones);
a DataLoader with 2 workers over Cifar10 with a Compose equal to
num_workers=0."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.vision as jvision
import paddle_tpu.vision.datasets as JD
import paddle_tpu.vision.transforms as JT
import paddle_tpu.vision.transforms.functional as JF
import paddle_tpu_torch as P
import paddle_tpu_torch.vision as tvision
import paddle_tpu_torch.vision.datasets as TD
import paddle_tpu_torch.vision.transforms as TT
import paddle_tpu_torch.vision.transforms.functional as TF
from paddle_tpu_torch.framework import device as port_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _images():
    rng = np.random.default_rng(0)
    return {"hwc_uint8": rng.integers(0, 256, (24, 28, 3)).astype(np.uint8),
            "chw_float": rng.random((3, 24, 28)).astype(np.float32)}


# name -> (factory of the transform from a module M (T or F), resizes)
TRANSFORMS = {
    "Compose": (lambda M: M.Compose([M.CenterCrop(20), M.ToTensor()]),
                False),
    "ToTensor": (lambda M: M.ToTensor(), False),
    "ToTensor_HWC": (lambda M: M.ToTensor(data_format="HWC"), False),
    "Normalize": (lambda M: M.Normalize(0.4, 0.2), False),
    "Resize": (lambda M: M.Resize((16, 20)), True),
    "Resize_up": (lambda M: M.Resize(40), True),
    "CenterCrop": (lambda M: M.CenterCrop((10, 12)), False),
    "RandomCrop": (lambda M: M.RandomCrop(12), False),
    "RandomHorizontalFlip": (lambda M: M.RandomHorizontalFlip(0.5), False),
    "RandomVerticalFlip": (lambda M: M.RandomVerticalFlip(0.5), False),
    "Transpose": (lambda M: M.Transpose((1, 2, 0)), False),
    "BrightnessTransform": (lambda M: M.BrightnessTransform(0.4), False),
    "ContrastTransform": (lambda M: M.ContrastTransform((0.5, 1.5)), False),
    "SaturationTransform": (lambda M: M.SaturationTransform(0.4), False),
    "HueTransform": (lambda M: M.HueTransform(0.2), False),
    "ColorJitter": (lambda M: M.ColorJitter(0.4, 0.4, 0.4, 0.1), False),
    "Grayscale": (lambda M: M.Grayscale(3), False),
    "Pad": (lambda M: M.Pad((1, 2, 3, 4), fill=7), False),
    "Pad_reflect": (lambda M: M.Pad(2, padding_mode="reflect"), False),
    "RandomRotation": (lambda M: M.RandomRotation(30, fill=3), False),
    "RandomRotation_expand": (lambda M: M.RandomRotation(30, expand=True),
                              False),
    "RandomAffine": (lambda M: M.RandomAffine(
        15, translate=(0.1, 0.2), scale=(0.8, 1.2), shear=(-5, 5, -3, 3)),
        False),
    "RandomPerspective": (lambda M: M.RandomPerspective(1.0, 0.4), False),
    "RandomResizedCrop": (lambda M: M.RandomResizedCrop(16), True),
    "RandomErasing": (lambda M: M.RandomErasing(1.0, value=5), False),
    "RandomErasing_random": (lambda M: M.RandomErasing(1.0, value="random"),
                             False),
    "to_tensor": (lambda M: M.to_tensor, False),
    "normalize": (lambda M: lambda img: M.normalize(img, 0.5, 0.25), False),
    "resize": (lambda M: lambda img: M.resize(img, (12, 14)), True),
    "hflip": (lambda M: M.hflip, False),
    "vflip": (lambda M: M.vflip, False),
    "crop": (lambda M: lambda img: M.crop(img, 2, 3, 10, 12), False),
    "center_crop": (lambda M: lambda img: M.center_crop(img, 9), False),
    "pad": (lambda M: lambda img: M.pad(img, (2, 3), padding_mode="edge"),
            False),
    "adjust_brightness": (lambda M: lambda img: M.adjust_brightness(img, 1.3),
                          False),
    "adjust_contrast": (lambda M: lambda img: M.adjust_contrast(img, 0.7),
                        False),
    "adjust_hue": (lambda M: lambda img: M.adjust_hue(img, -0.2), False),
    "to_grayscale": (lambda M: lambda img: M.to_grayscale(img), False),
    "rotate": (lambda M: lambda img: M.rotate(img, 20, center=(5, 6)), False),
    "affine": (lambda M: lambda img: M.affine(img, 10, (2, -1), 1.1, 4),
               False),
    "perspective": (lambda M: lambda img: M.perspective(
        img, [(0, 0), (27, 0), (27, 23), (0, 23)],
        [(2, 1), (25, 0), (26, 22), (1, 20)]), False),
    "erase": (lambda M: lambda img: M.erase(img, 2, 3, 5, 6, 9), False),
}
# per-channel statistics: the CHW layout, and HWC when told so
PER_CHANNEL = {
    "chw_float": lambda M: M.Normalize([0.4, 0.5, 0.6], [0.2, 0.3, 0.4]),
    "hwc_uint8": lambda M: M.Normalize([0.4, 0.5, 0.6], [0.2, 0.3, 0.4],
                                       data_format="HWC")}
FUNCTIONAL_ONLY = {"adjust_saturation": (
    lambda M: lambda img: M.adjust_saturation(img, 1.4), False)}


def _apply(factory, M, img):
    np.random.seed(7)
    return np.asarray(factory(M)(img.copy()))


@pytest.mark.parametrize("kind", ["hwc_uint8", "chw_float"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_the_jax_one(name, kind):
    factory, resizes = TRANSFORMS[name]
    img = _images()[kind]
    want = _apply(factory, JT, img)
    got = _apply(factory, TT, img)
    assert got.shape == want.shape and got.dtype == want.dtype
    if resizes:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 *
                                   max(1.0, float(np.abs(want).max())))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(PER_CHANNEL))
def test_per_channel_normalize_matches_the_jax_one(kind):
    img = _images()[kind]
    np.testing.assert_array_equal(_apply(PER_CHANNEL[kind], TT, img),
                                  _apply(PER_CHANNEL[kind], JT, img))


@pytest.mark.parametrize("kind", ["hwc_uint8", "chw_float"])
@pytest.mark.parametrize("name", sorted(
    n for n in list(TRANSFORMS) + list(FUNCTIONAL_ONLY) if n.islower()))
def test_functional_module_matches_the_jax_one(name, kind):
    factory, resizes = {**TRANSFORMS, **FUNCTIONAL_ONLY}[name]
    img = _images()[kind]
    want = _apply(factory, JF, img)
    got = _apply(factory, TF, img)
    np.testing.assert_allclose(got, want, rtol=1e-6 if resizes else 0,
                               atol=1e-6 if resizes else 0)


@pytest.mark.parametrize("fn", ["hflip", "crop", "adjust_contrast", "erase"])
def test_a_port_tensor_comes_back_a_tensor_on_its_place(fn):
    img = _images()["chw_float"]
    factory = TRANSFORMS[fn][0]
    got = factory(TF)(P.to_tensor(img))
    want = factory(JF)(paddle_tpu.to_tensor(img))
    assert isinstance(got, P.Tensor) and got.place == P.to_tensor(img).place
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    t = P.to_tensor(img)
    assert TF.erase(t, 1, 1, 2, 2, 0.0, inplace=True) is t
    assert float(t.numpy()[:, 1:3, 1:3].sum()) == 0.0


def test_pil_images_round_trip(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    pil = Image.fromarray(_images()["hwc_uint8"])
    for name in ("hflip", "rotate", "adjust_hue", "pad"):
        got, want = TRANSFORMS[name][0](TF)(pil), TRANSFORMS[name][0](JF)(pil)
        assert hasattr(got, "convert")
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    path = str(tmp_path / "img.png")
    pil.save(path)
    for backend in ("pil", "tensor"):
        got = tvision.image_load(path, backend=backend)
        want = jvision.image_load(path, backend=backend)
        np.testing.assert_array_equal(np.asarray(
            got.numpy() if backend == "tensor" else got), np.asarray(
                want.numpy() if backend == "tensor" else want))


def test_image_backend():
    prev = tvision.get_image_backend()
    assert prev == jvision.get_image_backend() == "pil"
    try:
        tvision.set_image_backend("tensor")
        assert tvision.get_image_backend() == "tensor"
        for bad in ("cv2", "opencv"):
            with pytest.raises(ValueError):
                tvision.set_image_backend(bad)
    finally:
        tvision.set_image_backend(prev)


def test_transform_argument_checks_match():
    for make in (lambda M: M.BrightnessTransform(-1),
                 lambda M: M.ContrastTransform((1.5, 0.5)),
                 lambda M: M.HueTransform(0.7),
                 lambda M: M.RandomRotation(-3)):
        for M in (TT, JT):
            with pytest.raises(ValueError):
                make(M)
    for M in (TF, JF):
        with pytest.raises(ValueError):
            M.adjust_hue(_images()["hwc_uint8"], 0.9)


@pytest.mark.parametrize("cls,mode", [("Cifar10", "train"),
                                      ("Cifar10", "test"),
                                      ("Cifar100", "train"),
                                      ("Flowers", "train"),
                                      ("Flowers", "test"),
                                      ("VOC2012", "train"),
                                      ("FashionMNIST", "test")])
def test_synthetic_datasets_equal_the_jax_ones(cls, mode):
    kw = {"transform": TT.Normalize(0.5, 0.5)} if cls != "VOC2012" else {}
    port = getattr(TD, cls)(mode=mode, **kw)
    ref = getattr(JD, cls)(mode=mode, **({"transform": JT.Normalize(
        0.5, 0.5)} if kw else {}))
    assert len(port) == len(ref)
    for i in (0, 1, len(ref) - 1):
        for g, w in zip(port[i], ref[i]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _write_folder(root, Image):
    rng = np.random.default_rng(4)
    for c in ("cat", "dog"):
        (root / c).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (6, 5, 3)).astype(
                np.uint8)).save(str(root / c / f"{i}.png"))
    (root / "dog" / "notes.txt").write_text("not an image")


def test_folder_datasets_read_the_same_files(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    _write_folder(tmp_path, Image)
    for cls in ("DatasetFolder", "ImageFolder"):
        port = getattr(TD, cls)(str(tmp_path), transform=TT.ToTensor())
        ref = getattr(JD, cls)(str(tmp_path), transform=JT.ToTensor())
        assert len(port) == len(ref) == 5
        for i in range(len(ref)):
            for g, w in zip(port[i], ref[i]):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    folder = TD.DatasetFolder(str(tmp_path))
    assert folder.classes == ["cat", "dog"] and folder[4][1] == 1
    assert TD.ImageFolder(str(tmp_path / "missing")).samples == []


def test_a_two_worker_loader_over_cifar10_equals_num_workers_0():
    ds = TD.Cifar10(mode="test", transform=TT.Compose([
        TT.CenterCrop(28), TT.Normalize([0.5, 0.5, 0.5], [0.2, 0.2, 0.2])]))
    runs = []
    for workers in (0, 2):
        loader = P.io.DataLoader(ds, batch_size=64, num_workers=workers)
        runs.append([[t.numpy() for t in b] for b in loader])
    assert len(runs[0]) == len(runs[1]) == 8
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    x, y = runs[0][0]
    assert x.shape == (64, 3, 28, 28) and y.shape == (64, 1)
    assert x.dtype == np.float32 and y.dtype == np.int64
