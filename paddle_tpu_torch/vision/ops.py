"""paddle.vision.ops of the port (`paddle_tpu/vision/ops.py`; reference
`python/paddle/vision/ops.py`): detection and RoI primitives in plain
PyTorch, with the JAX package's semantics.

No Pallas kernel computes any of them in the JAX package, so none has a
hand-written kernel here. `roi_align`, `roi_pool`, `box_clip`,
`correlation`, `deform_conv2d`, `yolo_box_head` and `yolo_loss` run on the
tensors' device through `apply` and are differentiable; the greedy sweeps
(`nms` and what calls it, `bipartite_match`) and the ragged output packing
(`matrix_nms`, `multiclass_nms3`, `generate_proposals`,
`distribute_fpn_proposals`, the batched `collect_fpn_proposals`,
`yolo_box_post`) run on the host, as they do in the JAX package, and
return tensors on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, _torch_data, apply

__all__ = ["nms", "roi_align", "roi_pool", "box_coder", "prior_box",
           "box_area", "box_iou", "distribute_fpn_proposals",
           "box_clip", "bipartite_match", "collect_fpn_proposals"]


def _data(x):
    return x._data if isinstance(x, Tensor) else _torch_data(np.asarray(x))


def _host(x):
    """x's values as a numpy array."""
    return _data(x).detach().cpu().numpy()


def _on(arr, like):
    """A numpy array as a Tensor on `like`'s device."""
    return Tensor(torch.from_numpy(np.ascontiguousarray(arr)).to(
        like.device))


def box_area(boxes):
    b = _data(boxes)
    return Tensor((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))


def _iou_matrix(a, b):
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(area_a[:, None] + area_b[None] - inter,
                               min=1e-10)


def box_iou(boxes1, boxes2):
    return Tensor(_iou_matrix(_data(boxes1), _data(boxes2)))


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS -> kept indices sorted by score. Category-aware when
    category_idxs is given (boxes of different categories never suppress
    each other). The IoU matrix is computed on the boxes' device, the
    sweep on the host."""
    b = _data(boxes)
    n = b.shape[0]
    s = (_data(scores) if scores is not None
         else torch.arange(n, 0, -1, dtype=torch.float32, device=b.device))
    order = torch.argsort(-s, stable=True)
    b_sorted = b[order]
    iou = _iou_matrix(b_sorted, b_sorted)
    if category_idxs is not None:
        c = _data(category_idxs).to(b.device)[order]
        iou = torch.where(c[:, None] == c[None, :], iou,
                          torch.zeros((), dtype=iou.dtype, device=b.device))
    over = (iou > iou_threshold).cpu().numpy()
    keep = np.ones(n, bool)
    for i in range(n):
        # box i (in score order) survives unless a higher-scored SURVIVOR
        # overlaps it beyond the threshold
        keep[i] = not np.any(over[i, :i] & keep[:i])
    out = order.cpu().numpy()[keep]
    if top_k is not None:
        out = out[:top_k]
    return _on(out.astype(np.int64), b)


def _img_of_roi(boxes_num, n_rois, device):
    bn = _host(boxes_num).reshape(-1)
    idx = np.repeat(np.arange(len(bn)), bn)
    if len(idx) != n_rois:
        raise ValueError(f"boxes_num sums to {len(idx)}, boxes hold "
                         f"{n_rois}")
    return torch.from_numpy(idx).to(device)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign: x [N, C, H, W]; boxes [R, 4] (x1, y1, x2, y2 in input
    coords); boxes_num [N] RoIs per image -> [R, C, oh, ow]. With
    sampling_ratio <= 0 each RoI takes ceil(roi / bin) samples a bin, the
    sample grid sized to the largest RoI's (capped at 8 a bin dim) and
    the slots past a RoI's own count masked."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    bx = _data(boxes).float()
    offset = 0.5 if aligned else 0.0
    cap = 8
    if sampling_ratio > 0:
        Ry = Rx = int(sampling_ratio)
    else:
        bhost = bx.detach().cpu().numpy()
        rh_all = np.maximum((bhost[:, 3] - bhost[:, 1]) * spatial_scale, 1e-3)
        rw_all = np.maximum((bhost[:, 2] - bhost[:, 0]) * spatial_scale, 1e-3)
        Ry = max(1, int(np.ceil(rh_all.max() / oh))) if len(bhost) else 1
        Rx = max(1, int(np.ceil(rw_all.max() / ow))) if len(bhost) else 1
        Ry, Rx = min(Ry, cap), min(Rx, cap)

    def fn(xd):
        n, c, h, w = xd.shape
        dev = xd.device
        bxd = bx.to(dev)
        img = _img_of_roi(boxes_num, bxd.shape[0], dev)
        roi = bxd * spatial_scale - offset                     # [R, 4]
        x1, y1, x2, y2 = roi.unbind(-1)
        rw = torch.clamp(x2 - x1, min=1e-3)
        rh = torch.clamp(y2 - y1, min=1e-3)
        bin_w, bin_h = rw / ow, rh / oh
        if sampling_ratio > 0:
            ry = torch.full_like(rh, float(Ry))
            rx = torch.full_like(rw, float(Rx))
        else:
            ry = torch.clamp(torch.ceil(rh / oh), 1, Ry)
            rx = torch.clamp(torch.ceil(rw / ow), 1, Rx)
        ky = torch.arange(Ry, dtype=torch.float32, device=dev)
        kx = torch.arange(Rx, dtype=torch.float32, device=dev)
        my = (ky[None] < ry[:, None]).float()                  # [R, Ry]
        mx = (kx[None] < rx[:, None]).float()
        ar_h = torch.arange(oh, dtype=torch.float32, device=dev)
        ar_w = torch.arange(ow, dtype=torch.float32, device=dev)
        gy = (y1[:, None, None] + (ar_h[None, :, None] + (
            ky[None, None, :] + 0.5) / ry[:, None, None])
            * bin_h[:, None, None]).reshape(-1, oh * Ry)       # [R, oh*Ry]
        gx = (x1[:, None, None] + (ar_w[None, :, None] + (
            kx[None, None, :] + 0.5) / rx[:, None, None])
            * bin_w[:, None, None]).reshape(-1, ow * Rx)
        feat = xd[img].float()                                 # [R, C, H, W]
        # the reference zeroes samples past the half-pixel border instead
        # of clamping them
        vy = ((gy >= -1) & (gy <= h)).float()
        vx = ((gx >= -1) & (gx <= w)).float()
        y0 = torch.clamp(torch.floor(gy), 0, h - 1)
        x0 = torch.clamp(torch.floor(gx), 0, w - 1)
        y1_ = torch.clamp(y0 + 1, 0, h - 1)
        x1_ = torch.clamp(x0 + 1, 0, w - 1)
        wy = torch.clamp(gy - y0, 0, 1)
        wx = torch.clamp(gx - x0, 0, 1)

        def corner(yi, xi):
            # feat[r, :, yi[r, a], xi[r, b]] -> [R, C, len(yi), len(xi)]
            rows = torch.gather(
                feat, 2, yi.long()[:, None, :, None].expand(
                    -1, c, -1, w))                             # [R,C,Y,W]
            return torch.gather(rows, 3, xi.long()[:, None, None, :].expand(
                -1, c, rows.shape[2], -1))

        v = (corner(y0, x0) * ((1 - wy)[:, :, None] * (1 - wx)[:, None, :])
             [:, None]
             + corner(y0, x1_) * ((1 - wy)[:, :, None] * wx[:, None, :])
             [:, None]
             + corner(y1_, x0) * (wy[:, :, None] * (1 - wx)[:, None, :])
             [:, None]
             + corner(y1_, x1_) * (wy[:, :, None] * wx[:, None, :])[:, None])
        v = v * (vy[:, :, None] * vx[:, None, :])[:, None]
        v = v.reshape(-1, c, oh, Ry, ow, Rx)
        v = v * my[:, None, None, :, None, None] * mx[:, None, None, None,
                                                        None, :]
        out = v.sum(dim=(3, 5)) / (ry * rx)[:, None, None, None]
        return out.to(xd.dtype)

    return apply(fn, x, _name="roi_align")


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """Max-pool RoI: the true max over every pixel whose coordinates fall
    in a bin (floor/ceil of the fractional bin edges); an empty bin is 0."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    bx = _data(boxes).float()

    def fn(xd):
        n, c, h, w = xd.shape
        dev = xd.device
        bxd = bx.to(dev)
        img = _img_of_roi(boxes_num, bxd.shape[0], dev)
        ygrid = torch.arange(h, dtype=torch.float32, device=dev)
        xgrid = torch.arange(w, dtype=torch.float32, device=dev)
        outs = []
        for r in range(bxd.shape[0]):
            x1, y1, x2, y2 = torch.round(bxd[r] * spatial_scale).unbind()
            rw = torch.clamp(x2 - x1 + 1, min=1.0)
            rh = torch.clamp(y2 - y1 + 1, min=1.0)
            a_h = torch.arange(oh, dtype=torch.float32, device=dev)
            a_w = torch.arange(ow, dtype=torch.float32, device=dev)
            ys0 = y1 + torch.floor(a_h * rh / oh)
            ys1 = y1 + torch.ceil((a_h + 1) * rh / oh)
            xs0 = x1 + torch.floor(a_w * rw / ow)
            xs1 = x1 + torch.ceil((a_w + 1) * rw / ow)
            my = (ygrid[None, :] >= ys0[:, None]) & \
                (ygrid[None, :] < ys1[:, None])                  # [oh, H]
            mx = (xgrid[None, :] >= xs0[:, None]) & \
                (xgrid[None, :] < xs1[:, None])                  # [ow, W]
            mask = my[:, None, :, None] & mx[None, :, None, :]  # [oh,ow,H,W]
            feat = xd[img[r]][None, None].float()               # [1,1,C,H,W]
            vals = torch.where(mask[:, :, None], feat,
                               torch.tensor(float("-inf"), device=dev))
            out = vals.amax(dim=(-2, -1))                       # [oh, ow, C]
            out = torch.where(torch.isfinite(out), out,
                              torch.zeros((), device=dev))
            outs.append(out.permute(2, 0, 1))
        if not outs:
            return xd.new_zeros((0, c, oh, ow))
        return torch.stack(outs).to(xd.dtype)

    return apply(fn, x, _name="roi_pool")


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Encode/decode boxes against priors.

    encode: targets [N, 4] x priors [M, 4] -> [N, M, 4] (every target
    against every prior). decode: target_box [N, M, 4] deltas; priors
    broadcast along dim `axis` (0: priors indexed by M, 1: by N), output
    [N, M, 4]."""
    pb = _data(prior_box).float()
    tb = _data(target_box).float().to(pb.device)
    pv = (_data(prior_box_var).float().to(pb.device)
          if prior_box_var is not None else torch.ones_like(pb))
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw / 2
        tcy = tb[:, 1] + th / 2
        out = torch.stack([
            (tcx[:, None] - pcx[None, :]) / pw[None, :] / pv[None, :, 0],
            (tcy[:, None] - pcy[None, :]) / ph[None, :] / pv[None, :, 1],
            torch.log(tw[:, None] / pw[None, :]) / pv[None, :, 2],
            torch.log(th[:, None] / ph[None, :]) / pv[None, :, 3],
        ], dim=-1)
    else:  # decode_center_size: tb is [N, M, 4] deltas
        if tb.dim() == 2:
            tb = tb[:, None, :]

        def expand(a):
            return a[None, :] if axis == 0 else a[:, None]

        dcx = expand(pv[:, 0]) * tb[..., 0] * expand(pw) + expand(pcx)
        dcy = expand(pv[:, 1]) * tb[..., 1] * expand(ph) + expand(pcy)
        dw = torch.exp(expand(pv[:, 2]) * tb[..., 2]) * expand(pw)
        dh = torch.exp(expand(pv[:, 3]) * tb[..., 3]) * expand(ph)
        out = torch.stack([dcx - dw / 2, dcy - dh / 2,
                           dcx + dw / 2 - norm, dcy + dh / 2 - norm], dim=-1)
    return Tensor(out)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False, name=None):
    """SSD prior boxes: (boxes [H, W, P, 4], variances [H, W, P, 4])
    normalized to [0, 1], on the input's device."""
    ref = _data(input)
    fh, fw = ref.shape[2:]
    ih, iw = _data(image).shape[2:]
    step_h = steps[1] or ih / fh
    step_w = steps[0] or iw / fw
    ars = list(aspect_ratios)
    if flip:
        ars += [1.0 / a for a in aspect_ratios if a != 1.0]
    sizes = []
    for ms in min_sizes:
        mx = max_sizes[min_sizes.index(ms)] if max_sizes else None
        if min_max_aspect_ratios_order:
            # Caffe layout: [min box, max box, other-ar boxes]
            sizes.append((float(ms), float(ms)))
            if mx is not None:
                sizes.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
            for a in ars:
                if abs(a - 1.0) < 1e-6:
                    continue
                sizes.append((ms * np.sqrt(a), ms / np.sqrt(a)))
        else:
            for a in ars:
                sizes.append((ms * np.sqrt(a), ms / np.sqrt(a)))
            if mx is not None:
                sizes.append((np.sqrt(ms * mx), np.sqrt(ms * mx)))
    sizes = np.asarray(sizes, np.float32)  # [P, 2] (w, h)
    cy = (np.arange(fh) + offset) * step_h
    cx = (np.arange(fw) + offset) * step_w
    cxg, cyg = np.meshgrid(cx, cy)
    boxes = np.stack([
        (cxg[..., None] - sizes[None, None, :, 0] / 2) / iw,
        (cyg[..., None] - sizes[None, None, :, 1] / 2) / ih,
        (cxg[..., None] + sizes[None, None, :, 0] / 2) / iw,
        (cyg[..., None] + sizes[None, None, :, 1] / 2) / ih,
    ], axis=-1).astype(np.float32)
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    var = np.broadcast_to(np.asarray(variance, np.float32), boxes.shape)
    return _on(boxes, ref), _on(var.copy(), ref)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    """Assign RoIs to FPN levels by scale: (per-level RoIs, the restore
    index[, per-level per-image counts])."""
    rois = _data(fpn_rois)
    scale = torch.sqrt((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]))
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-8)) + refer_level
    lvl = torch.clamp(lvl, min_level, max_level).to(torch.int32)
    lvl_np = lvl.cpu().numpy()
    rois_np = rois.detach().cpu().numpy()
    outs, idxs = [], []
    per_level_counts = []
    rn = _host(rois_num).reshape(-1) if rois_num is not None else None
    img_of = np.repeat(np.arange(len(rn)), rn) if rn is not None else None
    for level in range(min_level, max_level + 1):
        sel = np.nonzero(lvl_np == level)[0]
        outs.append(_on(rois_np[sel], rois))
        idxs.append(sel)
        if rn is not None:
            per_level_counts.append(_on(np.bincount(
                img_of[sel], minlength=len(rn)).astype(np.int32), rois))
    restore = np.argsort(np.concatenate(idxs)) if idxs else np.zeros(0)
    restore_t = _on(restore.astype(np.int32), rois)
    if rn is not None:
        return outs, restore_t, per_level_counts
    return outs, restore_t


def box_clip(input, im_info, name=None):
    """Clip boxes to the image: im_info rows are (height, width, scale);
    the limits are (dim / scale) - 1. Differentiable (min/max)."""
    def fn(b, info):
        info = info.float().to(b.device)
        if b.dim() != 3:
            info = info.reshape(-1)[:3]
            lim_h = info[0] / info[2] - 1.0
            lim_w = info[1] / info[2] - 1.0
        else:
            lim_h = (info[:, 0] / info[:, 2] - 1.0)[:, None, None]
            lim_w = (info[:, 1] / info[:, 2] - 1.0)[:, None, None]
        zero = torch.zeros((), dtype=b.dtype, device=b.device)

        def cl(v, lim):
            return torch.maximum(torch.minimum(v, lim.to(b.dtype)), zero)

        return torch.cat([cl(b[..., 0:1], lim_w), cl(b[..., 1:2], lim_h),
                          cl(b[..., 2:3], lim_w), cl(b[..., 3:4], lim_h)],
                         dim=-1)

    return apply(fn, input, im_info, _name="box_clip")


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    """Greedy bipartite matching on a similarity matrix [n, m] (or
    [B, n, m]), rows = candidates, cols = predictions: min(n, m) rounds of
    a global argmax with the matched row and column masked out. Returns
    (col_to_row_match_indices, col_to_row_match_dist), each [B?, m].
    match_type='per_prediction' also matches every unmatched column to its
    argmax row when the similarity reaches dist_threshold."""
    if match_type not in ("bipartite", "per_prediction"):
        raise ValueError("match_type must be 'bipartite' or "
                         "'per_prediction'")
    ref = _data(dist_matrix)
    d = ref.detach().float().cpu().numpy()
    batched = d.ndim == 3
    if not batched:
        d = d[None]
    B, n, m = d.shape
    neg = np.float32(-1e30)
    idx = np.full((B, m), -1, np.int32)
    dist = np.zeros((B, m), np.float32)
    for bi in range(B):
        work = d[bi].copy()
        for _ in range(min(n, m)):
            flat = int(np.argmax(work))
            i, j = flat // m, flat % m
            best = work[i, j]
            if not best > neg / 2:  # nothing left to match
                continue
            idx[bi, j] = i
            dist[bi, j] = best
            work[i, :] = neg
            work[:, j] = neg
        if match_type == "per_prediction":
            cand = np.argmax(d[bi], axis=0)
            cand_d = np.max(d[bi], axis=0)
            take = (idx[bi] < 0) & (cand_d >= dist_threshold)
            idx[bi] = np.where(take, cand.astype(np.int32), idx[bi])
            dist[bi] = np.where(take, cand_d, dist[bi])
    if not batched:
        idx, dist = idx[0], dist[0]
    return _on(idx, ref), _on(dist, ref)


def collect_fpn_proposals(multi_rois, multi_scores, min_level=None,
                          max_level=None, post_nms_top_n=-1,
                          rois_num_per_level=None, name=None):
    """Collect proposals across FPN levels and keep the post_nms_top_n
    highest-scoring: one top-k on the device, or per image when
    rois_num_per_level splits each level by image."""
    rois = torch.cat([_data(r) for r in multi_rois], dim=0)
    scores = torch.cat([_data(s).reshape(-1) for s in multi_scores], dim=0)
    if rois_num_per_level is None:
        k = scores.shape[0] if post_nms_top_n in (-1, None) \
            else min(int(post_nms_top_n), scores.shape[0])
        _, sel = torch.topk(scores, k)
        return Tensor(rois[sel]), _on(np.asarray([k], np.int32), rois)
    per_level = [_host(n).ravel() for n in rois_num_per_level]
    B = len(per_level[0])
    rois_h = rois.detach().float().cpu().numpy()
    sc_h = scores.detach().float().cpu().numpy()
    level_off = np.cumsum([0] + [int(p.sum()) for p in per_level])
    outs, counts = [], []
    for bi in range(B):
        idxs = []
        for li, p in enumerate(per_level):
            s = level_off[li] + int(p[:bi].sum())
            idxs.extend(range(s, s + int(p[bi])))
        idxs = np.asarray(idxs, np.int64)
        order = idxs[np.argsort(-sc_h[idxs], kind="stable")]
        if post_nms_top_n not in (-1, None):
            order = order[:int(post_nms_top_n)]
        outs.append(rois_h[order])
        counts.append(len(order))
    out = (np.concatenate(outs, axis=0) if outs
           else np.zeros((0, 4), np.float32))
    return _on(out, rois), _on(np.asarray(counts, np.int32), rois)


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, scale_x_y=1.0,
             iou_aware=False, iou_aware_factor=0.5, name=None):
    """Decode a YOLOv3 head into boxes and class scores: x [B, A*(5+C), H,
    W] with A = len(anchors) // 2 -> (boxes [B, H*W*A, 4] in xyxy image
    coords, scores [B, H*W*A, C]); scores under conf_thresh are zeroed."""
    xd = _data(x).float()
    im = _data(img_size).float().to(xd.device)
    B, _, H, W = xd.shape
    A = len(anchors) // 2
    C = int(class_num)
    an = torch.tensor(np.asarray(anchors, np.float32).reshape(A, 2),
                      device=xd.device)
    if iou_aware:
        # the A iou channels come first, then the A*(5+C) conv channels
        iou_pred = torch.sigmoid(xd[:, :A])
        feat = xd[:, A:].reshape(B, A, 5 + C, H, W)
    else:
        feat = xd.reshape(B, A, 5 + C, H, W)
    tx, ty, tw, th, tobj = (feat[:, :, 0], feat[:, :, 1], feat[:, :, 2],
                            feat[:, :, 3], feat[:, :, 4])
    gx = torch.arange(W, dtype=torch.float32,
                      device=xd.device)[None, None, None, :]
    gy = torch.arange(H, dtype=torch.float32,
                      device=xd.device)[None, None, :, None]
    bx = (torch.sigmoid(tx) * scale_x_y - (scale_x_y - 1) / 2 + gx) / W
    by = (torch.sigmoid(ty) * scale_x_y - (scale_x_y - 1) / 2 + gy) / H
    input_w = W * downsample_ratio
    input_h = H * downsample_ratio
    bw = torch.exp(tw) * an[None, :, None, None, 0] / input_w
    bh = torch.exp(th) * an[None, :, None, None, 1] / input_h
    imh = im[:, 0][:, None, None, None]
    imw = im[:, 1][:, None, None, None]
    x1 = (bx - bw / 2) * imw
    y1 = (by - bh / 2) * imh
    x2 = (bx + bw / 2) * imw
    y2 = (by + bh / 2) * imh
    if clip_bbox:
        zero = torch.zeros((), device=xd.device)
        x1 = torch.minimum(torch.maximum(x1, zero), imw - 1)
        y1 = torch.minimum(torch.maximum(y1, zero), imh - 1)
        x2 = torch.minimum(torch.maximum(x2, zero), imw - 1)
        y2 = torch.minimum(torch.maximum(y2, zero), imh - 1)
    obj = torch.sigmoid(tobj)
    if iou_aware:
        obj = obj ** (1 - iou_aware_factor) * iou_pred ** iou_aware_factor
    cls = torch.sigmoid(feat[:, :, 5:5 + C])
    scores = obj[:, :, None] * cls
    conf_mask = (obj >= conf_thresh)[:, :, None]
    scores = torch.where(conf_mask, scores, torch.zeros((), device=xd.device))

    def flat(v):  # [B, A, H, W] -> [B, A*H*W]
        return v.reshape(B, A * H * W)

    boxes = torch.stack([flat(x1), flat(y1), flat(x2), flat(y2)], dim=-1)
    sc = scores.permute(0, 1, 3, 4, 2).reshape(B, A * H * W, C)
    return Tensor(boxes), Tensor(sc)


def matrix_nms(bboxes, scores, score_threshold, post_threshold=0.0,
               nms_top_k=400, keep_top_k=200, use_gaussian=False,
               gaussian_sigma=2.0, background_label=0, normalized=True,
               return_index=False, return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2's parallel soft-NMS): every detection's score is
    decayed by its IoU with all higher-scored detections of its class;
    output rows (label, score, x1, y1, x2, y2) packed on the host."""
    ref = _data(bboxes)
    b = _host(bboxes).astype(np.float32)
    s = _host(scores).astype(np.float32)
    B, C, N = s.shape
    outs, indices, counts = [], [], []
    for bi in range(B):
        dets = []
        for c in range(C):
            if c == background_label:
                continue
            sc = s[bi, c]
            keep = np.where(sc > score_threshold)[0]
            if keep.size == 0:
                continue
            order = keep[np.argsort(-sc[keep])][:nms_top_k]
            bb = b[bi, order]
            ss = sc[order]
            x1, y1, x2, y2 = bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3]
            off = 0.0 if normalized else 1.0
            area = (x2 - x1 + off) * (y2 - y1 + off)
            ix1 = np.maximum(x1[:, None], x1[None, :])
            iy1 = np.maximum(y1[:, None], y1[None, :])
            ix2 = np.minimum(x2[:, None], x2[None, :])
            iy2 = np.minimum(y2[:, None], y2[None, :])
            iw = np.maximum(ix2 - ix1 + off, 0)
            ih = np.maximum(iy2 - iy1 + off, 0)
            iou = iw * ih / np.maximum(
                area[:, None] + area[None, :] - iw * ih, 1e-10)
            iou = np.triu(iou, k=1)  # iou[i, j]: higher-scored i vs j
            comp = iou.max(axis=0)   # det i's own max overlap upstream
            if use_gaussian:
                decay = np.exp(-(iou ** 2 - comp[:, None] ** 2)
                               / gaussian_sigma)
            else:
                decay = (1 - iou) / np.maximum(1 - comp[:, None], 1e-10)
            decay = np.where(np.triu(np.ones_like(iou), k=1) > 0,
                             decay, 1.0).min(axis=0)
            new_s = ss * decay
            ok = np.where(new_s >= post_threshold)[0]
            for j in ok:
                dets.append((c, new_s[j], *bb[j], bi * C * N + c * N
                             + order[j]))
        dets.sort(key=lambda d: -d[1])
        dets = dets[:keep_top_k]
        counts.append(len(dets))
        for d in dets:
            outs.append(d[:6])
            indices.append(d[6])
    out = (np.asarray(outs, np.float32).reshape(-1, 6) if outs
           else np.zeros((0, 6), np.float32))
    res = [_on(out, ref)]
    if return_index:
        res.append(_on(np.asarray(indices, np.int64), ref))
    if return_rois_num:
        res.append(_on(np.asarray(counts, np.int32), ref))
    return tuple(res) if len(res) > 1 else res[0]


def multiclass_nms3(bboxes, scores, rois_num=None, score_threshold=0.05,
                    nms_top_k=1000, keep_top_k=100, nms_threshold=0.3,
                    normalized=True, nms_eta=1.0, background_label=0,
                    return_index=False, name=None):
    """Per-class greedy NMS + cross-class top-k: bboxes [B, N, 4], scores
    [B, C, N] -> (out [M, 6] rows (label, score, x1, y1, x2, y2),
    [index], rois_num [B])."""
    ref = _data(bboxes)
    b = _host(bboxes).astype(np.float32)
    s = _host(scores).astype(np.float32)
    B, C, N = s.shape
    outs, idxs, counts = [], [], []
    for bi in range(B):
        dets = []
        for c in range(C):
            if c == background_label:
                continue
            sc = s[bi, c]
            cand = np.where(sc > score_threshold)[0]
            if cand.size == 0:
                continue
            cand = cand[np.argsort(-sc[cand])][:nms_top_k]
            kept = nms(_on(b[bi, cand], ref),
                       iou_threshold=nms_threshold).numpy()
            for j in kept:
                gi = cand[int(j)]
                dets.append((c, sc[gi], *b[bi, gi], bi * N + gi))
        dets.sort(key=lambda d: -d[1])
        dets = dets[:keep_top_k]
        counts.append(len(dets))
        for d in dets:
            outs.append(d[:6])
            idxs.append(d[6])
    out = (np.asarray(outs, np.float32).reshape(-1, 6) if outs
           else np.zeros((0, 6), np.float32))
    res = [_on(out, ref)]
    if return_index:
        res.append(_on(np.asarray(idxs, np.int64), ref))
    res.append(_on(np.asarray(counts, np.int32), ref))
    return tuple(res)


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=True, name=None):
    """RPN proposals, per image: decode the anchor deltas, clip to the
    image, drop tiny boxes, top pre_nms_top_n by score, greedy NMS, top
    post_nms_top_n."""
    ref = _data(scores)
    sc = _host(scores).astype(np.float32)          # [B, A, H, W]
    bd = _host(bbox_deltas).astype(np.float32)     # [B, A*4, H, W]
    ims = _host(img_size).astype(np.float32)       # [B, 2] (h, w)
    an = _host(anchors).astype(np.float32).reshape(-1, 4)
    var = _host(variances).astype(np.float32).reshape(-1, 4)
    B, A, H, W = sc.shape
    off = 1.0 if pixel_offset else 0.0
    all_rois, counts = [], []
    for bi in range(B):
        score = sc[bi].transpose(1, 2, 0).reshape(-1)       # H*W*A
        delta = bd[bi].reshape(A, 4, H, W).transpose(
            2, 3, 0, 1).reshape(-1, 4)
        aw = an[:, 2] - an[:, 0] + off
        ah = an[:, 3] - an[:, 1] + off
        acx = an[:, 0] + aw / 2
        acy = an[:, 1] + ah / 2
        cx = var[:, 0] * delta[:, 0] * aw + acx
        cy = var[:, 1] * delta[:, 1] * ah + acy
        w = np.exp(np.minimum(var[:, 2] * delta[:, 2], 10.0)) * aw
        h = np.exp(np.minimum(var[:, 3] * delta[:, 3], 10.0)) * ah
        boxes = np.stack([cx - w / 2, cy - h / 2,
                          cx + w / 2 - off, cy + h / 2 - off], axis=1)
        imh, imw = ims[bi]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, imw - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, imh - off)
        ws = boxes[:, 2] - boxes[:, 0] + off
        hs = boxes[:, 3] - boxes[:, 1] + off
        valid = np.where((ws >= min_size) & (hs >= min_size))[0]
        order = valid[np.argsort(-score[valid])][:pre_nms_top_n]
        if order.size == 0:
            counts.append(0)
            continue
        kept = nms(_on(boxes[order], ref), iou_threshold=nms_thresh).numpy()
        kept = order[kept[:post_nms_top_n]]
        all_rois.append(boxes[kept])
        counts.append(len(kept))
    rois = (np.concatenate(all_rois, axis=0) if all_rois
            else np.zeros((0, 4), np.float32))
    out = (_on(rois, ref),)
    if return_rois_num:
        out = out + (_on(np.asarray(counts, np.int32), ref),)
    return out


def psroi_pool(x, boxes, boxes_num, output_size=None, spatial_scale=1.0,
               pooled_height=1, pooled_width=1, output_channels=None,
               name=None):
    """Position-sensitive RoI pooling (R-FCN): x [B, C, H, W] with C = out_c
    * ph * pw, output channel group (i, j) pooled from its own channel
    group, by bilinear sampling at each bin's centre (the JAX package's
    PSROIAlign formulation)."""
    xd = _data(x).float()
    bx = _data(boxes).float().to(xd.device)
    bn = _host(boxes_num).ravel()
    if output_size is None:
        ph, pw = int(pooled_height), int(pooled_width)
    else:
        ph, pw = ((output_size, output_size)
                  if isinstance(output_size, int) else output_size)
    B, C, H, W = xd.shape
    out_c = C // (ph * pw)
    batch_of = np.repeat(np.arange(len(bn)), bn)
    dev = xd.device
    js, is_ = torch.meshgrid(torch.arange(pw, dtype=torch.float32,
                                          device=dev),
                             torch.arange(ph, dtype=torch.float32,
                                          device=dev), indexing="xy")
    ii, jj = is_.long(), js.long()

    def one(box, bidx):
        x1, y1, x2, y2 = (box * spatial_scale).unbind()
        rw = torch.clamp(x2 - x1, min=0.1) / pw
        rh = torch.clamp(y2 - y1, min=0.1) / ph
        cx = x1 + (js + 0.5) * rw   # [ph, pw] bin centres
        cy = y1 + (is_ + 0.5) * rh
        x0 = torch.clamp(torch.floor(cx), 0, W - 1).long()
        y0 = torch.clamp(torch.floor(cy), 0, H - 1).long()
        x1i = torch.clamp(x0 + 1, max=W - 1)
        y1i = torch.clamp(y0 + 1, max=H - 1)
        fx = torch.clamp(cx, 0, W - 1) - x0
        fy = torch.clamp(cy, 0, H - 1) - y0
        grp = xd[bidx].reshape(out_c, ph, pw, H, W)

        def g(yy, xx):
            return grp[:, ii, jj, yy, xx]

        return (g(y0, x0) * (1 - fx) * (1 - fy) + g(y0, x1i) * fx * (1 - fy)
                + g(y1i, x0) * (1 - fx) * fy + g(y1i, x1i) * fx * fy)

    outs = [one(bx[i], int(batch_of[i])) for i in range(bx.shape[0])]
    out = (torch.stack(outs) if outs
           else torch.zeros((0, out_c, ph, pw), device=dev))
    return Tensor(out)


def correlation(input1, input2, pad_size=4, kernel_size=1,
                max_displacement=4, stride1=1, stride2=1,
                corr_type_multiply=1, name=None):
    """Correlation cost volume (FlowNet's matching layer): corr[b, d, y, x]
    = mean_c x1[b, c, y, x] * x2[b, c, y+dy, x+dx] over the
    (2 * max_displacement / stride2 + 1)^2 displacement grid, as shifted
    elementwise products."""
    if corr_type_multiply != 1:
        raise NotImplementedError(
            "correlation: only corr_type_multiply=1 (multiplicative) is "
            "implemented — the same restriction as the reference kernel")

    def fn(a, b):
        B, C, H, W = a.shape
        pad = (pad_size, pad_size, pad_size, pad_size)
        ap = torch.nn.functional.pad(a, pad)
        bp = torch.nn.functional.pad(b, pad)
        r = max_displacement // stride2
        disps = [(dy * stride2, dx * stride2)
                 for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
        k = int(kernel_size)
        outs = []
        for dy, dx in disps:
            shifted = torch.roll(bp, shifts=(-dy, -dx), dims=(2, 3))
            prod = (ap * shifted).mean(dim=1)  # [B, H+2p, W+2p]
            if k > 1:
                # the mean over the k x k window centred on each pixel
                # (a "SAME" window: the extra row/column at the end)
                lo = (k - 1) // 2
                padded = torch.nn.functional.pad(
                    prod[:, None], (lo, k - 1 - lo, lo, k - 1 - lo))
                prod = torch.nn.functional.avg_pool2d(
                    padded, k, stride=1, divisor_override=k * k)[:, 0]
            outs.append(prod[:, pad_size:pad_size + H,
                             pad_size:pad_size + W])
        out = torch.stack(outs, dim=1)  # [B, D^2, H, W]
        if stride1 > 1:
            out = out[:, :, ::stride1, ::stride1]
        return out

    return apply(fn, input1, input2, _name="correlation")


def yolo_loss(x, gt_box, gt_label, gt_score=None, anchors=(),
              anchor_mask=(), class_num=1, ignore_thresh=0.7,
              downsample_ratio=32, use_label_smooth=True, scale_x_y=1.0,
              name=None):
    """YOLOv3 training loss: per ground-truth box the best-wh-IoU anchor
    (over all anchors) owns it; if that anchor is in this head's
    anchor_mask its grid cell gets the coordinate loss (BCE xy + L2 wh,
    weighted 2 - w*h), objectness = gt_score and label-smoothed class BCE
    targets (smooth weight min(1/C, 1/40)); predictions overlapping any gt
    beyond ignore_thresh leave the no-object term. Vectorized over the gt
    axis.

    x [B, A*(5+C), H, W]; gt_box [B, G, 4] (cx, cy, w, h normalized);
    gt_label [B, G] int; gt_score [B, G] (None = 1s). Returns loss [B]."""
    def _bce(p, t):
        p = torch.clamp(torch.sigmoid(p), 1e-7, 1 - 1e-7)
        return -(t * torch.log(p) + (1 - t) * torch.log(1 - p))

    if gt_score is None:
        gt_score = Tensor(torch.ones(_data(gt_label).shape,
                                     dtype=torch.float32,
                                     device=_data(gt_label).device))

    def _loss(xd, gb, gl, gs):
        dev = xd.device
        xd = xd.float()
        gb = gb.float().to(dev)
        gl = gl.long().to(dev)
        gs = gs.float().to(dev)
        B, _, H, W = xd.shape
        A = len(anchor_mask)
        C = int(class_num)
        G = gb.shape[1]
        an_all = torch.tensor(np.asarray(anchors, np.float32).reshape(-1, 2),
                              device=dev)
        mask_arr = np.asarray(anchor_mask, np.int64)
        an = an_all[torch.from_numpy(mask_arr).to(dev)]
        input_w = W * downsample_ratio
        input_h = H * downsample_ratio
        feat = xd.reshape(B, A, 5 + C, H, W)
        tx, ty, tw, th, tobj = (feat[:, :, 0], feat[:, :, 1],
                                feat[:, :, 2], feat[:, :, 3], feat[:, :, 4])
        tcls = feat[:, :, 5:]

        # decoded pred boxes (normalized) for the ignore mask
        cgx = torch.arange(W, dtype=torch.float32,
                           device=dev)[None, None, None, :]
        cgy = torch.arange(H, dtype=torch.float32,
                           device=dev)[None, None, :, None]
        px = (torch.sigmoid(tx) + cgx) / W
        py = (torch.sigmoid(ty) + cgy) / H
        pw = torch.exp(tw) * an[None, :, 0, None, None] / input_w
        ph = torch.exp(th) * an[None, :, 1, None, None] / input_h

        def iou_xywh(x1, y1, w1, h1, x2, y2, w2, h2):
            l = torch.maximum(x1 - w1 / 2, x2 - w2 / 2)
            r = torch.minimum(x1 + w1 / 2, x2 + w2 / 2)
            t = torch.maximum(y1 - h1 / 2, y2 - h2 / 2)
            bt = torch.minimum(y1 + h1 / 2, y2 + h2 / 2)
            inter = torch.clamp(r - l, min=0) * torch.clamp(bt - t, min=0)
            return inter / torch.clamp(w1 * h1 + w2 * h2 - inter, min=1e-10)

        iou_all = iou_xywh(
            px[:, None], py[:, None], pw[:, None], ph[:, None],
            gb[:, :, 0, None, None, None], gb[:, :, 1, None, None, None],
            gb[:, :, 2, None, None, None], gb[:, :, 3, None, None, None])
        noobj_mask = (iou_all.amax(dim=1) < ignore_thresh).float()

        # per-gt anchor assignment, vectorized over [B, G]
        cx, cy, w, h = gb[..., 0], gb[..., 1], gb[..., 2], gb[..., 3]
        has = (w > 0) & (h > 0)
        gw = w[..., None] * input_w
        gh = h[..., None] * input_h
        iw = torch.minimum(gw, an_all[None, None, :, 0])
        ih = torch.minimum(gh, an_all[None, None, :, 1])
        inter = iw * ih
        wh_iou = inter / torch.clamp(
            gw * gh + an_all[None, None, :, 0] * an_all[None, None, :, 1]
            - inter, min=1e-10)
        best_a = torch.argmax(wh_iou, dim=-1)          # [B, G] global idx
        lut_local = np.full(len(an_all), 0, np.int64)
        lut_in = np.zeros(len(an_all), bool)
        for k, m in enumerate(mask_arr):
            lut_local[m] = k
            lut_in[m] = True
        local_a = torch.from_numpy(lut_local).to(dev)[best_a]   # [B, G]
        own = has & torch.from_numpy(lut_in).to(dev)[best_a]
        m = own.float()

        gi = torch.clamp((cx * W).to(torch.int32), 0, W - 1).long()
        gj = torch.clamp((cy * H).to(torch.int32), 0, H - 1).long()
        bidx = torch.arange(B, device=dev)[:, None].repeat(1, G)
        sel = (bidx, local_a, gj, gi)

        t_x = cx * W - gi
        t_y = cy * H - gj
        aw = an[torch.clamp(local_a, 0, A - 1)]        # [B, G, 2]
        t_w = torch.log(torch.clamp(w * input_w / aw[..., 0], min=1e-9))
        t_h = torch.log(torch.clamp(h * input_h / aw[..., 1], min=1e-9))
        scale = (2.0 - w * h) * gs

        loss = (m * scale * (_bce(tx[sel], t_x) + _bce(ty[sel], t_y))
                ).sum(-1)
        loss = loss + (m * scale * 0.5 * ((tw[sel] - t_w) ** 2
                                          + (th[sel] - t_h) ** 2)).sum(-1)

        sw = min(1.0 / C, 1.0 / 40.0) if (use_label_smooth and C > 1) \
            else 0.0
        cls_t = torch.nn.functional.one_hot(gl, C).float() * \
            (1.0 - 2.0 * sw) + sw
        cls_pred = tcls[bidx, local_a, :, gj, gi]      # [B, G, C]
        loss = loss + (m * gs * _bce(cls_pred, cls_t).sum(-1)).sum(-1)

        # objectness: the positive target is the mixup score, not 1.0
        obj_target = torch.zeros((B, A, H, W), dtype=torch.float32,
                                 device=dev)
        obj_target = _scatter_max(obj_target, sel, m * gs)
        pos = (obj_target > 0).float()
        loss = loss + (pos * _bce(tobj, obj_target)).sum((1, 2, 3))
        loss = loss + ((1 - pos) * noobj_mask
                       * _bce(tobj, torch.zeros((), device=dev))
                       ).sum((1, 2, 3))
        return loss

    return apply(_loss, x, gt_box, gt_label, gt_score, _name="yolo_loss")


def _scatter_max(target, index, values):
    """target.at[index].max(values): the max of the target and every value
    scattered onto the same cell."""
    flat = target.reshape(-1)
    lin = sum(i.reshape(-1) * s for i, s in zip(index, target.stride()))
    return flat.scatter_reduce(0, lin, values.reshape(-1), reduce="amax",
                               include_self=True).reshape(target.shape)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1/v2: each kernel tap samples the input at a
    learned offset from its integer position (bilinear, zero outside),
    optionally modulated by `mask` (v2); a bilinear gather per tap, then
    one contraction with the weight."""
    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    sh, sw = pair(stride)
    ph, pw = pair(padding)
    dh, dw = pair(dilation)

    def fn(xd, off, wd, *rest):
        i = 0
        bd = md = None
        if bias is not None:
            bd = rest[i]
            i += 1
        if mask is not None:
            md = rest[i]
        B, Cin, H, W = xd.shape
        Cout, Cin_g, KH, KW = wd.shape
        K = KH * KW
        Ho = (H + 2 * ph - (dh * (KH - 1) + 1)) // sh + 1
        Wo = (W + 2 * pw - (dw * (KW - 1) + 1)) // sw + 1
        dg = deformable_groups
        off = off.reshape(B, dg, K, 2, Ho, Wo)
        dev = xd.device
        base_y = (torch.arange(Ho, device=dev) * sh - ph)[None, :, None]
        base_x = (torch.arange(Wo, device=dev) * sw - pw)[None, None, :]
        xg = xd.reshape(B, dg, Cin // dg, H * W)

        def gat(yy, xx):
            # a flat gather over H*W per (b, dg) -> [B, dg, C/dg, Ho, Wo]
            lin = (yy * W + xx).reshape(B, dg, 1, Ho * Wo).expand(
                -1, -1, Cin // dg, -1)
            return torch.gather(xg, 3, lin).reshape(B, dg, Cin // dg, Ho, Wo)

        cols = []
        for k in range(K):
            kh, kw = k // KW, k % KW
            # offset layout: (dy, dx) per tap
            py = (base_y + kh * dh) + off[:, :, k, 0]  # [B, dg, Ho, Wo]
            px = (base_x + kw * dw) + off[:, :, k, 1]
            valid = ((py > -1) & (py < H) & (px > -1) & (px < W)).to(
                xd.dtype)
            y0 = torch.floor(py)
            x0 = torch.floor(px)
            wy = py - y0
            wx = px - x0
            y0i = torch.clamp(y0, 0, H - 1).long()
            x0i = torch.clamp(x0, 0, W - 1).long()
            y1i = torch.clamp(y0 + 1, 0, H - 1).long()
            x1i = torch.clamp(x0 + 1, 0, W - 1).long()
            v = (gat(y0i, x0i) * ((1 - wy) * (1 - wx))[:, :, None]
                 + gat(y0i, x1i) * ((1 - wy) * wx)[:, :, None]
                 + gat(y1i, x0i) * (wy * (1 - wx))[:, :, None]
                 + gat(y1i, x1i) * (wy * wx)[:, :, None])
            v = v * valid[:, :, None]
            if md is not None:
                mk = md.reshape(B, dg, K, Ho, Wo)[:, :, k]
                v = v * mk[:, :, None]
            cols.append(v.reshape(B, Cin, Ho, Wo))
        col = torch.stack(cols, dim=2)  # [B, Cin, K, Ho, Wo]
        wg = wd.reshape(groups, Cout // groups, Cin_g, KH * KW)
        cg = col.reshape(B, groups, Cin // groups, K, Ho, Wo)
        out = torch.einsum("goik,bgikhw->bgohw", wg, cg)
        out = out.reshape(B, Cout, Ho, Wo)
        if bd is not None:
            out = out + bd.reshape(1, -1, 1, 1)
        return out

    args = [x, offset, weight]
    if bias is not None:
        args.append(bias)
    if mask is not None:
        args.append(mask)
    return apply(fn, *args, _name="deform_conv2d")


# the yaml op name (ops.yaml deformable_conv); deform_conv2d is the API
deformable_conv = deform_conv2d


def read_file(filename, dtype="uint8", place=None, name=None):
    """Read raw bytes into a uint8 tensor (on `place`, default the
    creation place)."""
    data = np.fromfile(filename, dtype=np.uint8)
    return Tensor(_torch_data(data, place=place))


def decode_jpeg(x, mode="unchanged", name=None):
    """Decode a JPEG byte tensor to [C, H, W] uint8 on the host (PIL,
    imported here), returned on x's device."""
    import io

    from PIL import Image

    ref = _data(x)
    buf = bytes(_host(x).astype(np.uint8).tobytes())
    img = Image.open(io.BytesIO(buf))
    if mode == "gray":
        img = img.convert("L")
    elif mode in ("rgb", "RGB"):
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return _on(arr, ref)


def yolo_box_head(x, anchors=(), class_num=1, name=None):
    """The PP-YOLO inference head transform: per anchor slot, sigmoid on x,
    y, objectness and the class channels; w/h raw."""
    def fn(xd):
        B, _, H, W = xd.shape
        A = len(anchors) // 2
        f = xd.reshape(B, A, 5 + class_num, H, W)
        sig = torch.sigmoid(f)
        out = torch.cat([sig[:, :, 0:2], f[:, :, 2:4], sig[:, :, 4:]], dim=2)
        return out.reshape(B, A * (5 + class_num), H, W)

    return apply(fn, x, _name="yolo_box_head")


def yolo_box_post(boxes0, boxes1, boxes2, image_shape, image_scale,
                  anchors0=(), anchors1=(), anchors2=(), class_num=1,
                  conf_thresh=0.01, downsample_ratio0=32,
                  downsample_ratio1=16, downsample_ratio2=8,
                  clip_bbox=True, scale_x_y=1.0, nms_threshold=0.45,
                  name=None):
    """Multi-level YOLO postprocess: decode the three heads with yolo_box,
    concatenate, threshold, class-aware greedy NMS, emit (label, score, x1,
    y1, x2, y2) rows and per-image counts."""
    ref = _data(boxes0)
    ims = Tensor(_data(image_shape).float().reshape(-1, 2))
    scale = _host(image_scale).astype(np.float32).reshape(-1)
    levels = ((boxes0, anchors0, downsample_ratio0),
              (boxes1, anchors1, downsample_ratio1),
              (boxes2, anchors2, downsample_ratio2))
    all_boxes, all_scores = [], []
    for feat, an, ds in levels:
        b, s = yolo_box(feat, ims, anchors=list(an), class_num=class_num,
                        conf_thresh=conf_thresh, downsample_ratio=ds,
                        clip_bbox=clip_bbox, scale_x_y=scale_x_y)
        all_boxes.append(b.numpy())
        all_scores.append(s.numpy())
    bx = np.concatenate(all_boxes, axis=1)    # [B, N, 4]
    sc = np.concatenate(all_scores, axis=1)   # [B, N, C]
    outs, counts = [], []
    for bi in range(bx.shape[0]):
        dets = []
        for c in range(class_num):
            s = sc[bi, :, c]
            cand = np.where(s > conf_thresh)[0]
            if cand.size == 0:
                continue
            cand = cand[np.argsort(-s[cand])]
            kept = nms(_on(bx[bi, cand], ref),
                       iou_threshold=nms_threshold).numpy()
            for j in kept:
                gi = cand[int(j)]
                box = bx[bi, gi] / max(scale[bi % len(scale)], 1e-9)
                dets.append((c, s[gi], *box))
        dets.sort(key=lambda d: -d[1])
        counts.append(len(dets))
        outs.extend(dets)
    out = (np.asarray(outs, np.float32).reshape(-1, 6) if outs
           else np.zeros((0, 6), np.float32))
    return _on(out, ref), _on(np.asarray(counts, np.int32), ref)
