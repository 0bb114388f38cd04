"""`vision.ops` of the port against the JAX package's on the CPU: the box
and RoI functions (nms, box_area/box_iou, roi_align, roi_pool, box_coder,
prior_box, the FPN proposals, box_clip, bipartite_match), deform_conv2d,
read_file/decode_jpeg and the `_C_ops` vision targets, on the same numpy
inputs: indices and counts exactly, floats to f32 rtol 1e-5 / atol 1e-6;
the differentiable ones also by their input gradients
(`torch_vision_ops_parity`). The detection heads:
`test_torch_vision_detection.py`."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu.vision import ops as jops
from paddle_tpu_torch.framework import device as port_device
from paddle_tpu_torch.vision import ops as tops
from torch_vision_ops_parity import _boxes, _call, _np, _same, _with_grads

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


@pytest.mark.parametrize("case", ["plain", "scores", "categories", "top_k"])
def test_nms(case):
    rng = np.random.default_rng(0)
    b = _boxes(rng, 40)
    kw = {"iou_threshold": 0.3}
    if case != "plain":
        kw["scores"] = rng.random(40).astype(np.float32)
    if case == "categories":
        kw["category_idxs"] = rng.integers(0, 3, 40).astype(np.int64)
        kw["categories"] = [0, 1, 2]
    if case == "top_k":
        kw["top_k"] = 5
    got, want = _call("nms", b, **kw)
    _same(got, want, exact=True)
    assert len(_np(got)) < 40


def test_box_area_and_iou():
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    _same(*_call("box_area", a))
    _same(*_call("box_iou", a, b))


@pytest.mark.parametrize("sampling_ratio,aligned", [(-1, True), (2, False)])
def test_roi_align_and_its_gradient(sampling_ratio, aligned):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 12, 14)).astype(np.float32)
    boxes = _boxes(rng, 5, size=20.0)
    num = np.array([2, 3], np.int32)
    kw = dict(output_size=(3, 4), spatial_scale=0.5,
              sampling_ratio=sampling_ratio, aligned=aligned)
    outs, grads = _with_grads("roi_align", [x, boxes, num], kw, [0])
    _same(*outs)
    _same(*grads)


def test_roi_pool_and_its_gradient():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 12, 14)).astype(np.float32)
    boxes = _boxes(rng, 4, size=24.0)
    num = np.array([1, 3], np.int32)
    kw = dict(output_size=3, spatial_scale=0.5)
    outs, grads = _with_grads("roi_pool", [x, boxes, num], kw, [0])
    _same(*outs)
    _same(*grads)


@pytest.mark.parametrize("code_type,normalized,axis", [
    ("encode_center_size", True, 0), ("encode_center_size", False, 0),
    ("decode_center_size", True, 0), ("decode_center_size", False, 1)])
def test_box_coder(code_type, normalized, axis):
    rng = np.random.default_rng(4)
    prior = _boxes(rng, 6)
    var = rng.uniform(0.1, 0.3, (6, 4)).astype(np.float32)
    if code_type == "encode_center_size":
        target = _boxes(rng, 3)
    else:
        target = rng.standard_normal(
            (6 if axis == 1 else 3, 6 if axis == 0 else 3, 4)).astype(
                np.float32) * 0.2
        if axis == 1:
            target = rng.standard_normal((6, 3, 4)).astype(np.float32) * 0.2
    _same(*_call("box_coder", prior, var, target, code_type=code_type,
                 box_normalized=normalized, axis=axis))


@pytest.mark.parametrize("order", [False, True])
def test_prior_box(order):
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((1, 2, 4, 5)).astype(np.float32)
    img = rng.standard_normal((1, 3, 32, 40)).astype(np.float32)
    _same(*_call("prior_box", feat, img, min_sizes=[4.0, 8.0],
                 max_sizes=[8.0, 16.0], aspect_ratios=(1.0, 2.0), flip=True,
                 clip=True, min_max_aspect_ratios_order=order))


@pytest.mark.parametrize("with_num", [False, True])
def test_distribute_fpn_proposals(with_num):
    rng = np.random.default_rng(6)
    rois = _boxes(rng, 20, size=200.0)
    kw = {}
    if with_num:
        kw["rois_num"] = np.array([8, 12], np.int32)
    got, want = _call("distribute_fpn_proposals", rois, 2, 5, 4, 56, **kw)
    _same(got, want)


@pytest.mark.parametrize("batched", [False, True])
def test_box_clip_and_its_gradient(batched):
    rng = np.random.default_rng(7)
    boxes = rng.uniform(-10, 60, (2, 5, 4) if batched else (5, 4)).astype(
        np.float32)
    info = np.array([[40, 50, 1.0], [30, 30, 0.5]], np.float32)
    if not batched:
        info = info[:1]
    outs, grads = _with_grads("box_clip", [boxes, info], {}, [0])
    _same(*outs)
    _same(*grads)


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
@pytest.mark.parametrize("batched", [False, True])
def test_bipartite_match(match_type, batched):
    rng = np.random.default_rng(8)
    d = rng.random((3, 4, 7) if batched else (4, 7)).astype(np.float32)
    got, want = _call("bipartite_match", d, match_type=match_type,
                      dist_threshold=0.4)
    _same(got, want, exact=True)


@pytest.mark.parametrize("batched", [False, True])
def test_collect_fpn_proposals(batched):
    rng = np.random.default_rng(9)
    rois = [_boxes(rng, 6), _boxes(rng, 4)]
    scores = [rng.random(6).astype(np.float32),
              rng.random(4).astype(np.float32)]
    kw = {"post_nms_top_n": 5}
    if batched:
        kw["rois_num_per_level"] = [np.array([2, 4], np.int32),
                                    np.array([3, 1], np.int32)]
    out = []
    for M, mod in ((P, tops), (paddle_tpu, jops)):
        k = dict(kw)
        if batched:
            k["rois_num_per_level"] = [M.to_tensor(v) for v in
                                       kw["rois_num_per_level"]]
        out.append(mod.collect_fpn_proposals(
            [M.to_tensor(r) for r in rois], [M.to_tensor(s) for s in scores],
            2, 3, **k))
    _same(*out)


@pytest.mark.parametrize("v2", [False, True])
def test_deform_conv2d_and_its_gradient(v2):
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2, 4, 7, 8)).astype(np.float32)
    w = rng.standard_normal((6, 2, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    off = rng.standard_normal((2, 2 * 2 * 9, 4, 4)).astype(np.float32)
    arrays = [x, off, w, b]
    kw = dict(stride=2, padding=1, dilation=1, deformable_groups=2,
              groups=2)
    if v2:
        kw["mask"] = rng.random((2, 2 * 9, 4, 4)).astype(np.float32)
        got, want = _call("deform_conv2d", x, off, w, b, **kw)
        _same(got, want)
    else:
        outs, grads = _with_grads("deform_conv2d", arrays, kw, [0, 1, 2, 3])
        _same(*outs)
        _same(*grads)
    assert tops.deformable_conv is tops.deform_conv2d


def test_read_file_and_decode_jpeg(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(19)
    path = str(tmp_path / "img.jpg")
    Image.fromarray(rng.integers(0, 255, (12, 10, 3), np.uint8)).save(path)
    raw = _call("read_file", path)
    _same(*raw, exact=True)
    for mode in ("unchanged", "gray", "rgb"):
        got = tops.decode_jpeg(raw[0], mode=mode)
        want = jops.decode_jpeg(raw[1], mode=mode)
        _same(got, want, exact=True)


def test_the_c_ops_vision_targets_resolve_to_the_port():
    from paddle_tpu_torch import _C_ops

    names = [n for n, t in _C_ops._TARGETS.items()
             if t.startswith("paddle.vision.")]
    assert len(names) == 20
    for n in names:
        assert _C_ops._t(n) is getattr(
            tops, _C_ops._TARGETS[n].rsplit(".", 1)[1]), n
