"""paddle.vision.ops counterpart: detection ops (nms, box IoU, YOLO box
decoding and loss, RoI pooling and alignment, deformable convolution) and
the image file ops.

Counterpart of `paddle_tpu/vision/ops.py` (:14-558), on torch tensors on
the tensors' device; `nms` keeps its keep-list on the host (numpy), as the
reference does, and `read_file` / `decode_jpeg` run on the host (PIL),
placing their result on the current place. The functions are the Tensor
API's boundary (`core.tensor.api`). The reference's behaviour is
kept where it departs from paddle's documentation: `roi_align` samples
`x[0]` for every box and reads neither `boxes_num` nor `sampling_ratio`
(:87-110), and `yolo_box` reads no `conf_thresh` (ROADMAP Queue 3 item 10).
"""
from __future__ import annotations

import io as _io
import math

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError
from ..core.place import resolve_device
from ..core.tensor import api
from ..nn import initializer
from ..nn.layer.layers import Layer

__all__ = ["nms", "box_iou", "yolo_box", "roi_align", "deform_conv2d",
           "roi_pool", "psroi_pool", "yolo_loss", "read_file", "decode_jpeg",
           "DeformConv2D", "RoIPool", "PSRoIPool", "RoIAlign"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@api
def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy non-maximum suppression on the host (reference :14-36): the
    kept indices, highest score first, at most `top_k`."""
    b = torch.as_tensor(boxes).detach().float().cpu().numpy()
    s = torch.as_tensor(scores).detach().float().cpu().numpy() \
        if scores is not None else np.ones(len(b), "float32")
    order = np.argsort(-s)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(b[i, 0], b[rest, 0])
        yy1 = np.maximum(b[i, 1], b[rest, 1])
        xx2 = np.minimum(b[i, 2], b[rest, 2])
        yy2 = np.minimum(b[i, 3], b[rest, 3])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        a_i = (b[i, 2] - b[i, 0]) * (b[i, 3] - b[i, 1])
        a_r = (b[rest, 2] - b[rest, 0]) * (b[rest, 3] - b[rest, 1])
        iou = inter / np.maximum(a_i + a_r - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    keep = np.asarray(keep[:top_k] if top_k else keep, dtype="int64")
    return torch.from_numpy(keep).to(torch.as_tensor(boxes).device)


@api
def box_iou(boxes1, boxes2):
    """[N, 4] x [M, 4] (x1, y1, x2, y2) -> [N, M] IoU (reference :39)."""
    a, b = boxes1, boxes2
    area1 = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area2 = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None] - inter).clamp(min=1e-9)


@api
def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             clip_bbox=True, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5):
    """Decode a YOLO head [N, A*(5+C), H, W] -> (boxes [N, A*H*W, 4],
    scores [N, A*H*W, C]) in image-relative units (reference :54-84)."""
    na = len(anchors) // 2
    anc = torch.tensor(anchors, dtype=torch.float32,
                       device=x.device).reshape(na, 2)
    n, _, h, w = x.shape
    a = x.reshape(n, na, 5 + class_num, h, w)
    gx = torch.arange(w, dtype=a.dtype, device=a.device)
    gy = torch.arange(h, dtype=a.dtype, device=a.device)
    cx = (torch.sigmoid(a[:, :, 0]) * scale_x_y - (scale_x_y - 1) / 2
          + gx[None, None, None, :]) / w
    cy = (torch.sigmoid(a[:, :, 1]) * scale_x_y - (scale_x_y - 1) / 2
          + gy[None, None, :, None]) / h
    bw = torch.exp(a[:, :, 2]) * anc[None, :, 0, None, None] / \
        (w * downsample_ratio)
    bh = torch.exp(a[:, :, 3]) * anc[None, :, 1, None, None] / \
        (h * downsample_ratio)
    obj = torch.sigmoid(a[:, :, 4])
    cls = torch.sigmoid(a[:, :, 5:])
    scores = obj[:, :, None] * cls
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        -1).reshape(n, -1, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    if clip_bbox:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes, scores


def _bilinear(img, yy, xx):
    """img [C, H, W] sampled at (yy, xx) [P] -> [C, P]: order-1
    interpolation with corners outside the image reading 0, corner by
    corner in `jax.scipy.ndimage.map_coordinates`' order."""
    C, H, W = img.shape
    flat = img.reshape(C, H * W)

    def nodes(c):
        lower = torch.floor(c)
        upper_w = c - lower
        i = lower.to(torch.int64)
        return [(i, 1 - upper_w), (i + 1, upper_w)]

    out = None
    for iy, wy in nodes(yy):
        for ix, wx in nodes(xx):
            ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            v = flat[:, iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)]
            term = (wy * wx) * torch.where(ok, v, 0.0)
            out = term if out is None else out + term
    return out


@api
def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoIAlign by one bilinear sample per bin centre (reference :87-110):
    every box samples `x[0]`, and neither `boxes_num` nor
    `sampling_ratio` is read, as in the reference."""
    oh, ow = _pair(output_size)
    b = torch.as_tensor(boxes).detach().to(x.device)
    off = 0.5 if aligned else 0.0
    c = x.shape[1]
    outs = []
    for i in range(b.shape[0]):
        x1, y1, x2, y2 = b[i] * spatial_scale - off
        ys = y1 + (torch.arange(oh, device=x.device) + 0.5) * (y2 - y1) / oh
        xs = x1 + (torch.arange(ow, device=x.device) + 0.5) * (x2 - x1) / ow
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        outs.append(_bilinear(x[0], gy.reshape(-1), gx.reshape(-1))
                    .reshape(c, oh, ow))
    return torch.stack(outs)


@api
def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 / v2 (reference :113-199). x [N, Cin, H,
    W]; offset [N, 2*dg*kh*kw, Ho, Wo], (dy, dx) per kernel tap; mask
    [N, dg*kh*kw, Ho, Wo] gives the modulated form. Per tap one bilinear
    four-corner gather (zero outside the image) over N x dg x Ho x Wo, then
    one grouped product with the weights."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    N, Cin, H, W = x.shape
    Cout, Cg, kh, kw = weight.shape
    dg = deformable_groups
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    want_off = (N, 2 * dg * kh * kw, Ho, Wo)
    if tuple(offset.shape) != want_off:
        raise InvalidArgumentError(
            f"deform_conv2d: offset shape {tuple(offset.shape)} != "
            f"expected {want_off} (2*deformable_groups*kh*kw offsets "
            "per output position)")
    off = offset.reshape(N, dg, kh * kw, 2, Ho, Wo)
    dev = x.device
    base_y = (torch.arange(Ho, device=dev) * sh - ph)[:, None]
    base_x = (torch.arange(Wo, device=dev) * sw - pw)[None, :]
    cpg = Cin // dg
    xf = x.reshape(N, dg, cpg, H * W)
    P = Ho * Wo
    cols = []
    for t in range(kh * kw):
        i, j = t // kw, t % kw
        yy = (base_y + i * dh + off[:, :, t, 0]).reshape(N, dg, P)
        xx = (base_x + j * dw + off[:, :, t, 1]).reshape(N, dg, P)
        y0, x0 = torch.floor(yy), torch.floor(xx)
        wy, wx = yy - y0, xx - x0
        y0i, x0i = y0.to(torch.int64), x0.to(torch.int64)
        s = torch.zeros((N, dg, cpg, P), dtype=x.dtype, device=dev)
        for ddy in (0, 1):
            for ddx in (0, 1):
                iy, ix = y0i + ddy, x0i + ddx
                wgt = (wy if ddy else 1 - wy) * (wx if ddx else 1 - wx)
                ok = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
                idx = iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)
                v = torch.gather(xf, 3, idx[:, :, None, :].expand(
                    N, dg, cpg, P))
                s = s + v * torch.where(ok, wgt, 0.0)[:, :, None, :]
        if mask is not None:
            s = s * mask.reshape(N, dg, kh * kw, P)[:, :, t][:, :, None, :]
        cols.append(s)
    cols = torch.stack(cols, 3).reshape(N, groups, Cin // groups, kh * kw, P)
    wt = weight.reshape(groups, Cout // groups, Cg, kh * kw)
    out = torch.einsum("ngckp,gock->ngop", cols, wt).reshape(N, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias.reshape(1, Cout, 1, 1)
    return out


def _image_of_roi(boxes_num, K, device):
    if boxes_num is None:
        return torch.zeros(K, dtype=torch.int64, device=device)
    bn = torch.as_tensor(boxes_num).cpu().numpy().astype(np.int64)
    return torch.from_numpy(np.repeat(np.arange(len(bn)), bn)).to(device)


def _bin_edges(start, size, n, limit, offset_rounding):
    """[K, n] starts and ends of n bins over [start, start + size)."""
    ps = torch.arange(n, device=size.device)[None, :]
    if offset_rounding:     # roi_pool: floor/ceil of p * bin, then + start
        lo = torch.floor(ps * size[:, None]).to(torch.int64) + start[:, None]
        hi = torch.ceil((ps + 1) * size[:, None]).to(torch.int64) + \
            start[:, None]
    else:                   # psroi_pool: floor/ceil of p * bin + start
        lo = torch.floor(ps * size[:, None] + start[:, None]).to(torch.int64)
        hi = torch.ceil((ps + 1) * size[:, None] + start[:, None]).to(
            torch.int64)
    return lo.clamp(0, limit), hi.clamp(0, limit)


@api
def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
             name=None):
    """Quantized max RoI pooling (reference :202-259): rounded box corners,
    floor / ceil bin edges, an empty bin gives 0; one masked max per bin
    (ties share the gradient, as jax's max does)."""
    oh, ow = _pair(output_size)
    N, C, H, W = x.shape
    bx = boxes
    K = bx.shape[0]
    img = _image_of_roi(boxes_num, K, x.device)
    rs_w = torch.round(bx[:, 0] * spatial_scale).to(torch.int64)
    rs_h = torch.round(bx[:, 1] * spatial_scale).to(torch.int64)
    re_w = torch.round(bx[:, 2] * spatial_scale).to(torch.int64)
    re_h = torch.round(bx[:, 3] * spatial_scale).to(torch.int64)
    roi_w = (re_w - rs_w + 1).clamp(min=1)
    roi_h = (re_h - rs_h + 1).clamp(min=1)
    hs, he = _bin_edges(rs_h, roi_h.float() / oh, oh, H, True)
    ws, we = _bin_edges(rs_w, roi_w.float() / ow, ow, W, True)
    rows = torch.arange(H, device=x.device)
    cols = torch.arange(W, device=x.device)
    fk = x[img]                                          # [K, C, H, W]
    bins = []
    for p in range(oh):
        rmask = (rows[None] >= hs[:, p, None]) & (rows[None] < he[:, p, None])
        for q in range(ow):
            cmask = (cols[None] >= ws[:, q, None]) & \
                (cols[None] < we[:, q, None])
            m = rmask[:, :, None] & cmask[:, None, :]    # [K, H, W]
            v = torch.where(m[:, None], fk, float("-inf")).amax((-2, -1))
            bins.append(torch.where(m.any((-2, -1))[:, None], v, 0.0))
    return torch.stack(bins, -1).reshape(K, C, oh, ow)


@api
def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI average pooling (reference :262-328): input
    channels C = out_c * oh * ow; output bin (c, ph, pw) averages input
    channel c*oh*ow + ph*ow + pw over the bin; an empty bin gives 0."""
    oh, ow = _pair(output_size)
    N, C, H, W = x.shape
    out_c = C // (oh * ow)
    bx = boxes
    K = bx.shape[0]
    img = _image_of_roi(boxes_num, K, x.device)
    rs_w = torch.round(bx[:, 0]) * spatial_scale
    rs_h = torch.round(bx[:, 1]) * spatial_scale
    re_w = torch.round(bx[:, 2] + 1.0) * spatial_scale
    re_h = torch.round(bx[:, 3] + 1.0) * spatial_scale
    roi_h = (re_h - rs_h).clamp(min=0.1)
    roi_w = (re_w - rs_w).clamp(min=0.1)
    hs, he = _bin_edges(rs_h, roi_h / oh, oh, H, False)
    ws, we = _bin_edges(rs_w, roi_w / ow, ow, W, False)
    rows = torch.arange(H, device=x.device)
    cols = torch.arange(W, device=x.device)
    fk = x[img].reshape(K, out_c, oh, ow, H, W)
    bins = []
    for p in range(oh):
        rmask = (rows[None] >= hs[:, p, None]) & (rows[None] < he[:, p, None])
        for q in range(ow):
            cmask = (cols[None] >= ws[:, q, None]) & \
                (cols[None] < we[:, q, None])
            m = (rmask[:, :, None] & cmask[:, None, :]).to(x.dtype)
            ssum = (fk[:, :, p, q] * m[:, None]).sum((-2, -1))
            cnt = m.sum((-2, -1))[:, None]
            bins.append(torch.where(cnt > 0, ssum / cnt.clamp(min=1.0), 0.0))
    return torch.stack(bins, -1).reshape(K, out_c, oh, ow)


def _sce(x, z):
    """Numerically stable sigmoid cross-entropy; max(x, 0) shares its
    gradient at 0, as jnp.maximum does."""
    return torch.maximum(x, torch.zeros_like(x)) - x * z + \
        torch.log1p(torch.exp(-x.abs()))


@api
def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3 training loss (reference :331-460). x [N, M*(5+C), H, W];
    gt_box [N, B, 4] normalized (cx, cy, w, h); gt_label [N, B]; returns the
    per-image loss [N]: location (sigmoid CE on x / y, L1 on w / h, scaled
    by (2 - w*h) * score), objectness (ignored where a cell's best IoU
    passes ignore_thresh) and per-class sigmoid CE, optionally
    label-smoothed, as dense masked algebra."""
    N, _, H, W = x.shape
    B = gt_box.shape[1]
    M = len(anchor_mask)
    an_num = len(anchors) // 2
    C = class_num
    dev, dt = x.device, x.dtype
    gb, gl = gt_box, gt_label
    gs = gt_score if gt_score is not None else \
        torch.ones((N, B), dtype=dt, device=dev)
    xa5 = x.reshape(N, M, 5 + C, H, W)
    input_size = downsample_ratio * H
    bias = -0.5 * (scale_x_y - 1.0)
    sig = torch.sigmoid

    # predicted boxes (the reference divides both axes by the grid's h)
    ii = torch.arange(W, dtype=dt, device=dev)
    jj = torch.arange(H, dtype=dt, device=dev)
    px = (ii[None, None, None, :] + sig(xa5[:, :, 0]) * scale_x_y + bias) / H
    py = (jj[None, None, :, None] + sig(xa5[:, :, 1]) * scale_x_y + bias) / H
    anc = torch.tensor(anchors, dtype=dt, device=dev).reshape(an_num, 2)
    anc_m = anc[torch.tensor(anchor_mask, device=dev)]
    pw = torch.exp(xa5[:, :, 2]) * anc_m[:, 0][None, :, None, None] / \
        input_size
    ph = torch.exp(xa5[:, :, 3]) * anc_m[:, 1][None, :, None, None] / \
        input_size
    valid = (gb[:, :, 2] > 1e-6) & (gb[:, :, 3] > 1e-6)   # [N, B]

    def overlap(c1, w1, c2, w2):
        return torch.minimum(c1 + w1 / 2, c2 + w2 / 2) - \
            torch.maximum(c1 - w1 / 2, c2 - w2 / 2)

    # per-cell best IoU against the gts -> ignore mask
    P = H * W
    pxf, pyf = px.reshape(N, M, P, 1), py.reshape(N, M, P, 1)
    pwf, phf = pw.reshape(N, M, P, 1), ph.reshape(N, M, P, 1)
    gx, gy = gb[:, None, None, :, 0], gb[:, None, None, :, 1]
    gw, gh = gb[:, None, None, :, 2], gb[:, None, None, :, 3]
    ow_ = overlap(pxf, pwf, gx, gw)
    oh_ = overlap(pyf, phf, gy, gh)
    inter = torch.where((ow_ > 0) & (oh_ > 0), ow_ * oh_, 0.0)
    union = pwf * phf + gw * gh - inter
    iou = torch.where(valid[:, None, None, :],
                      inter / union.clamp(min=1e-10), 0.0)
    ignore = iou.amax(-1) > ignore_thresh                 # [N, M, P]

    # per-gt best anchor by (w, h) IoU over all anchors
    aw, ah = anc[:, 0] / input_size, anc[:, 1] / input_size
    gwb, ghb = gb[:, :, 2][:, :, None], gb[:, :, 3][:, :, None]
    inter_a = torch.minimum(gwb, aw[None, None]) * \
        torch.minimum(ghb, ah[None, None])
    union_a = gwb * ghb + aw[None, None] * ah[None, None] - inter_a
    best_n = torch.argmax(inter_a / union_a.clamp(min=1e-10), -1)  # [N, B]
    mask_lut = -np.ones(an_num, np.int64)
    for mi, a in enumerate(anchor_mask):
        mask_lut[a] = mi
    mask_idx = torch.from_numpy(mask_lut).to(dev)[best_n]
    matched = valid & (mask_idx >= 0)
    gi = (gb[:, :, 0] * W).to(torch.int64).clamp(0, W - 1)
    gj = (gb[:, :, 1] * H).to(torch.int64).clamp(0, H - 1)

    # predictions at the positive cells
    mi_safe = mask_idx.clamp(min=0)
    nb = torch.arange(N, device=dev)[:, None].expand(N, B)
    sel = xa5[nb, mi_safe, :, gj, gi]                     # [N, B, 5+C]
    ttx = gb[:, :, 0] * W - gi
    tty = gb[:, :, 1] * H - gj
    ttw = torch.log((gb[:, :, 2] * input_size / anc[:, 0][best_n])
                    .clamp(min=1e-9))
    tth = torch.log((gb[:, :, 3] * input_size / anc[:, 1][best_n])
                    .clamp(min=1e-9))
    loc_scale = (2.0 - gb[:, :, 2] * gb[:, :, 3]) * gs
    loc = (_sce(sel[:, :, 0], ttx) + _sce(sel[:, :, 1], tty)
           + (sel[:, :, 2] - ttw).abs() + (sel[:, :, 3] - tth).abs()) * \
        loc_scale
    loc = torch.where(matched, loc, 0.0)

    if use_label_smooth:
        sw = min(1.0 / max(C, 1), 1.0 / 40)
        pos_l, neg_l = 1.0 - sw, sw
    else:
        pos_l, neg_l = 1.0, 0.0
    cls_ids = torch.arange(C, device=dev)
    tgt = torch.where(cls_ids[None, None, :] == gl[:, :, None].long(),
                      pos_l, neg_l).to(dt)
    cls = _sce(sel[:, :, 5:], tgt).sum(-1) * gs
    cls = torch.where(matched, cls, 0.0)

    # objectness target: 0 negative, -1 ignored, the score at positives
    obj = torch.where(ignore, -1.0, 0.0).to(dt)
    pidx = gj * W + gi
    obj = obj.index_put((nb[matched], mi_safe[matched], pidx[matched]),
                        gs[matched].to(dt))
    tobj = xa5[:, :, 4].reshape(N, M, P)
    obj_loss = torch.where(
        obj > 1e-5, _sce(tobj, 1.0) * obj,
        torch.where(obj > -0.5, _sce(tobj, 0.0), 0.0))
    return loc.sum(-1) + cls.sum(-1) + obj_loss.sum((1, 2))


@api
def read_file(filename, name=None):
    """The raw bytes of a file as a uint8 tensor on the current place."""
    with open(filename, "rb") as fh:
        data = np.frombuffer(fh.read(), dtype=np.uint8).copy()
    return torch.from_numpy(data).to(resolve_device())


@api
def decode_jpeg(x, mode="unchanged", name=None):
    """Decode a JPEG byte tensor to [C, H, W] uint8 on the host (PIL), the
    result on x's device."""
    from PIL import Image
    data = bytes(torch.as_tensor(x).cpu().numpy().astype(np.uint8))
    img = Image.open(_io.BytesIO(data))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        torch.as_tensor(x).device)


class DeformConv2D(Layer):
    """paddle.vision.ops.DeformConv2D (reference :500-528)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self._stride, self._padding, self._dilation = stride, padding, \
            dilation
        self._dg, self._groups = deformable_groups, groups
        k = 1.0 / math.sqrt(in_channels * kh * kw)
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups, kh, kw),
            default_initializer=initializer.Uniform(-k, k))
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_channels,), default_initializer=initializer.Constant(0.0))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             self._stride, self._padding, self._dilation,
                             self._dg, self._groups, mask)


class RoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._os, self._ss = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self._os, self._ss)


class PSRoIPool(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._os, self._ss = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self._os, self._ss)


class RoIAlign(Layer):
    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._os, self._ss = output_size, spatial_scale

    def forward(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self._os, self._ss)
