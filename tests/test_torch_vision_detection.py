"""`vision.ops`' detection heads of the port against the JAX package's on
the CPU: yolo_box, matrix_nms, multiclass_nms3, generate_proposals,
psroi_pool, correlation, yolo_loss, yolo_box_head and yolo_box_post, on
the same numpy inputs: indices and counts exactly, floats to f32 rtol
1e-5 / atol 1e-6; correlation and yolo_loss also by their input gradients
(`torch_vision_ops_parity`)."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from paddle_tpu_torch.framework import device as port_device
from torch_vision_ops_parity import _boxes, _call, _same, _with_grads

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


@pytest.mark.parametrize("iou_aware", [False, True])
def test_yolo_box(iou_aware):
    rng = np.random.default_rng(10)
    A, C = 2, 3
    x = rng.standard_normal((2, A * (5 + C) + (A if iou_aware else 0), 4,
                             5)).astype(np.float32)
    img = np.array([[64, 80], [48, 40]], np.int32)
    _same(*_call("yolo_box", x, img, anchors=[10, 13, 16, 30], class_num=C,
                 conf_thresh=0.3, downsample_ratio=16, scale_x_y=1.05,
                 iou_aware=iou_aware))


@pytest.mark.parametrize("gaussian", [False, True])
def test_matrix_nms(gaussian):
    rng = np.random.default_rng(11)
    boxes = np.stack([_boxes(rng, 12, 1.0) for _ in range(2)])
    scores = rng.random((2, 3, 12)).astype(np.float32)
    got, want = _call("matrix_nms", boxes, scores, 0.3, post_threshold=0.1,
                      nms_top_k=8, keep_top_k=10, use_gaussian=gaussian,
                      return_index=True)
    _same(got, want)


def test_multiclass_nms3():
    rng = np.random.default_rng(12)
    boxes = np.stack([_boxes(rng, 15)])
    scores = rng.random((1, 3, 15)).astype(np.float32)
    got, want = _call("multiclass_nms3", boxes, scores, score_threshold=0.3,
                      nms_top_k=10, keep_top_k=8, nms_threshold=0.4,
                      return_index=True)
    _same(got, want)


def test_generate_proposals():
    rng = np.random.default_rng(13)
    A, H, W = 3, 4, 5
    scores = rng.random((2, A, H, W)).astype(np.float32)
    deltas = rng.standard_normal((2, A * 4, H, W)).astype(np.float32) * 0.3
    anchors = np.concatenate([_boxes(rng, H * W * A, 40.0)]).reshape(
        H, W, A, 4)
    var = np.full((H, W, A, 4), 0.5, np.float32)
    img = np.array([[48, 56], [40, 40]], np.float32)
    got, want = _call("generate_proposals", scores, deltas, img, anchors,
                      var, pre_nms_top_n=30, post_nms_top_n=10,
                      nms_thresh=0.5, min_size=1.0)
    _same(got, want)


def test_psroi_pool():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((2, 2 * 3 * 3, 10, 12)).astype(np.float32)
    boxes = _boxes(rng, 3, 20.0)
    num = np.array([1, 2], np.int32)
    _same(*_call("psroi_pool", x, boxes, num, output_size=3,
                 spatial_scale=0.5))


@pytest.mark.parametrize("kernel_size,stride1", [(1, 1), (3, 2)])
def test_correlation_and_its_gradient(kernel_size, stride1):
    rng = np.random.default_rng(15)
    a = rng.standard_normal((1, 3, 8, 9)).astype(np.float32)
    b = rng.standard_normal((1, 3, 8, 9)).astype(np.float32)
    kw = dict(pad_size=2, kernel_size=kernel_size, max_displacement=2,
              stride1=stride1, stride2=1)
    outs, grads = _with_grads("correlation", [a, b], kw, [0, 1])
    _same(*outs)
    _same(*grads)


def test_yolo_loss_and_its_gradient():
    rng = np.random.default_rng(16)
    A, C = 2, 3
    x = rng.standard_normal((2, A * (5 + C), 4, 4)).astype(np.float32)
    gt = np.concatenate([rng.uniform(0.2, 0.8, (2, 3, 2)),
                         rng.uniform(0.05, 0.4, (2, 3, 2))], -1).astype(
                             np.float32)
    gt[1, 2] = 0.0  # an empty slot
    label = rng.integers(0, C, (2, 3)).astype(np.int32)
    score = rng.uniform(0.5, 1.0, (2, 3)).astype(np.float32)
    kw = dict(anchors=[10, 13, 16, 30, 33, 23], anchor_mask=[1, 2],
              class_num=C, ignore_thresh=0.5, downsample_ratio=8)
    outs, grads = _with_grads("yolo_loss", [x, gt, label, score], kw, [0])
    _same(*outs)
    _same(*grads)


def test_yolo_box_head_and_post():
    rng = np.random.default_rng(18)
    C = 2
    heads = [rng.standard_normal((1, 2 * (5 + C), s, s)).astype(np.float32)
             for s in (1, 2, 2)]
    _same(*_call("yolo_box_head", heads[0], anchors=[10, 13, 16, 30],
                 class_num=C))
    shape = np.array([[64, 64]], np.float32)
    scale = np.array([1.0], np.float32)
    got, want = _call("yolo_box_post", *heads, shape, scale,
                      anchors0=[116, 90, 156, 198],
                      anchors1=[30, 61, 62, 45], anchors2=[10, 13, 16, 30],
                      class_num=C, conf_thresh=0.3, nms_threshold=0.45)
    _same(got, want)
