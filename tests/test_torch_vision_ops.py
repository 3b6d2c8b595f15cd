"""The port's `vision.ops` against the JAX package on the CPU: every
function, forward, and the gradients of `sum(out * g)` with respect to
the differentiable inputs (the features; for `deform_conv2d` also the
offsets, weights, mask and bias): `nms`, `box_iou`, `yolo_box`,
`roi_align`, `deform_conv2d` (v1 and v2, groups and deformable groups),
`roi_pool`, `psroi_pool`, `yolo_loss` (with and without scores and label
smoothing), `read_file` and `decode_jpeg` (PIL), and the four layers.
Within 1e-5 (1 + |ref|) in fp32; `nms` keeps the same indices. The
reference's kept defects are pinned: `roi_align` samples `x[0]` for every
box and reads neither `boxes_num` nor `sampling_ratio`; `yolo_box` reads
no `conf_thresh` (ROADMAP Queue 3 item 10).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.vision import ops as jops
import paddle_tpu_torch as pt
from paddle_tpu_torch.vision import ops as tops
from torch_parity import dev, n_, state_of
from paddle_tpu_torch.utils import load_numpy_state

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


def _leaves(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def both(jfn, tfn, arrays, consts=(), grads=(0,), seed=1):
    """Call jfn / tfn on the numpy `arrays` (as tensors; those at `grads`
    differentiable) and `consts` (numpy, turned into each package's
    tensors); compare outputs and gradients."""
    def jt(a):
        return paddle.to_tensor(a) if isinstance(a, np.ndarray) else a

    def tt(a):
        return torch.from_numpy(a) if isinstance(a, np.ndarray) else a

    jin = [paddle.to_tensor(a, stop_gradient=i not in grads)
           for i, a in enumerate(arrays)]
    tin = [torch.tensor(a, requires_grad=i in grads)
           for i, a in enumerate(arrays)]
    jout = _leaves(jfn(*jin, *[jt(c) for c in consts]))
    tout = _leaves(tfn(*tin, *[tt(c) for c in consts]))
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        assert dev(b.detach().numpy(), np.asarray(a.numpy())) <= TOL
    if not grads:
        return
    rng = np.random.default_rng(seed)
    gs = [rng.standard_normal(tuple(a.shape)).astype(np.float32)
          for a in jout]
    sum(paddle.sum(a * paddle.to_tensor(g))
        for a, g in zip(jout, gs)).backward()
    sum((b * torch.from_numpy(g)).sum() for b, g in zip(tout, gs)).backward()
    for i in grads:
        assert dev(tin[i].grad.numpy(), np.asarray(jin[i].gradient())) \
            <= TOL, i


def _boxes(n, size=16.0, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, size * 0.6, (n, 2))
    wh = rng.uniform(2, size * 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("top_k", [None, 3])
def test_nms(top_k):
    b = _boxes(12, seed=1)
    s = np.random.default_rng(2).uniform(size=12).astype(np.float32)
    for thr in (0.1, 0.3, 0.6):
        got = tops.nms(torch.from_numpy(b), thr, torch.from_numpy(s),
                       top_k=top_k)
        want = jops.nms(paddle.to_tensor(b), thr, paddle.to_tensor(s),
                        top_k=top_k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
        assert got.dtype == torch.int64
    got = tops.nms(torch.from_numpy(b), 0.3)
    want = jops.nms(paddle.to_tensor(b), 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_box_iou():
    both(jops.box_iou, tops.box_iou, [_boxes(5), _boxes(7, seed=3)],
         grads=(0, 1))


@pytest.mark.parametrize("clip,scale", [(True, 1.0), (False, 1.05)])
def test_yolo_box(clip, scale):
    x = n_(2, 2 * (5 + 3), 4, 5)
    anchors = [10, 13, 16, 30]

    def call(ops):
        return lambda a: ops.yolo_box(a, None, anchors, 3, 0.5, 8,
                                      clip_bbox=clip, scale_x_y=scale)

    both(call(jops), call(tops), [x])


def test_yolo_box_reads_no_conf_thresh():
    x = torch.from_numpy(n_(1, 8, 3, 3))
    a = tops.yolo_box(x, None, [10, 13], 3, 0.0, 8)
    b = tops.yolo_box(x, None, [10, 13], 3, 0.99, 8)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


@pytest.mark.parametrize("aligned", [True, False])
def test_roi_align(aligned):
    x = n_(2, 3, 10, 12)
    boxes = _boxes(4, size=10.0, seed=4)

    def call(ops):
        return lambda a, b: ops.roi_align(a, b, np.array([2, 2]), (3, 2),
                                          spatial_scale=0.8, aligned=aligned)

    both(call(jops), call(tops), [x], consts=[boxes])


def test_roi_align_kept_defects():
    """Every box samples image 0, whatever boxes_num says, and
    sampling_ratio changes nothing: the reference's behaviour."""
    x = torch.from_numpy(n_(2, 3, 10, 12))
    boxes = torch.from_numpy(_boxes(4, size=10.0, seed=4))
    a = tops.roi_align(x, boxes, torch.tensor([2, 2]), 3)
    b = tops.roi_align(x[:1], boxes, torch.tensor([4]), 3, sampling_ratio=4)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = jops.roi_align(paddle.to_tensor(x.numpy()),
                          paddle.to_tensor(boxes.numpy()),
                          paddle.to_tensor(np.array([2, 2])), 3)
    assert dev(a.numpy(), np.asarray(want.numpy())) <= TOL


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("groups,dg,stride,padding,dilation", [
    (1, 1, 1, 1, 1), (2, 2, 2, 0, 1), (1, 2, 1, 2, 2)])
def test_deform_conv2d(modulated, groups, dg, stride, padding, dilation):
    N, Cin, H, W, Cout, k = 2, 4, 7, 6, 6, 3
    Ho = (H + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1
    Wo = (W + 2 * padding - (dilation * (k - 1) + 1)) // stride + 1
    arrays = [n_(N, Cin, H, W), n_(N, 2 * dg * k * k, Ho, Wo, seed=2) * 1.5,
              n_(Cout, Cin // groups, k, k, seed=3), n_(Cout, seed=4)]
    if modulated:
        arrays.append(np.random.default_rng(5).uniform(
            size=(N, dg * k * k, Ho, Wo)).astype(np.float32))

    def call(ops):
        def f(x, off, w, b, m=None):
            return ops.deform_conv2d(x, off, w, b, stride, padding,
                                     dilation, dg, groups, m)
        return f

    both(call(jops), call(tops), arrays, grads=tuple(range(len(arrays))))


def test_deform_conv2d_offset_shape_error():
    from paddle_tpu_torch.core.enforce import InvalidArgumentError
    with pytest.raises(InvalidArgumentError):
        tops.deform_conv2d(torch.zeros(1, 2, 5, 5), torch.zeros(1, 9, 3, 3),
                           torch.zeros(2, 2, 3, 3))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_pool(scale):
    x = n_(2, 3, 12, 11)
    boxes = _boxes(5, size=11.0 / scale, seed=6)
    boxes[2] = [4.0, 4.0, 4.0, 4.0]                 # a one-cell box

    def call(ops):
        return lambda a, b: ops.roi_pool(a, b, np.array([2, 3]), (3, 2),
                                         spatial_scale=scale)

    both(call(jops), call(tops), [x], consts=[boxes])


def test_roi_pool_ties_share_the_gradient():
    """A constant feature map: every bin's max ties over its cells, and
    the gradient is shared among them, as jax's max shares it."""
    x = np.ones((1, 1, 6, 6), np.float32)
    boxes = np.array([[0, 0, 5, 5]], np.float32)
    both(lambda a, b: jops.roi_pool(a, b, None, 2),
         lambda a, b: tops.roi_pool(a, b, None, 2), [x], consts=[boxes])


def test_psroi_pool():
    oh = ow = 2
    x = n_(2, 3 * oh * ow, 9, 10)
    boxes = _boxes(4, size=9.0, seed=7)

    def call(ops):
        return lambda a, b: ops.psroi_pool(a, b, np.array([1, 3]), (oh, ow),
                                           spatial_scale=1.0)

    both(call(jops), call(tops), [x], consts=[boxes])


@pytest.mark.parametrize("scores,smooth,scale", [
    (False, True, 1.0), (True, False, 1.0), (True, True, 1.1)])
def test_yolo_loss(scores, smooth, scale):
    N, B, C, H, W = 2, 4, 3, 5, 6
    anchors = [10, 13, 16, 30, 33, 23, 30, 61]
    mask = [1, 2]
    x = n_(N, len(mask) * (5 + C), H, W) * 0.5
    rng = np.random.default_rng(8)
    gt = np.concatenate([rng.uniform(0.1, 0.9, (N, B, 2)),
                         rng.uniform(0.05, 0.5, (N, B, 2))], -1) \
        .astype(np.float32)
    gt[1, 3, 2:] = 0.0                              # an empty gt slot
    labels = rng.integers(0, C, (N, B)).astype(np.int32)
    consts = [gt, labels]
    arrays = [x]
    if scores:
        arrays.append(rng.uniform(0.5, 1.0, (N, B)).astype(np.float32))

    def call(ops):
        def f(a, *rest):
            s = rest[0] if scores else None
            gb, gl = rest[-2], rest[-1]
            return ops.yolo_loss(a, gb, gl, anchors, mask, C, 0.5, 32,
                                 gt_score=s, use_label_smooth=smooth,
                                 scale_x_y=scale)
        return f

    both(call(jops), call(tops), arrays, consts=consts,
         grads=tuple(range(len(arrays))))


def test_read_file_and_decode_jpeg(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(9)
    img = (rng.uniform(size=(12, 10, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(path, quality=90)
    raw = tops.read_file(path)
    jraw = jops.read_file(path)
    assert raw.dtype == torch.uint8
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jraw.numpy()))
    for mode in ("unchanged", "gray", "rgb"):
        got = tops.decode_jpeg(raw, mode=mode)
        want = jops.decode_jpeg(jraw, mode=mode)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


def test_layers():
    jl = jops.DeformConv2D(4, 6, 3, padding=1)
    tl = tops.DeformConv2D(4, 6, 3, padding=1)
    assert list(tl.state_dict()) == list(jl.state_dict())
    load_numpy_state(tl, state_of(jl))
    x, off = n_(1, 4, 5, 5), n_(1, 18, 5, 5, seed=2)
    got = tl(torch.from_numpy(x), torch.from_numpy(off))
    want = jl(paddle.to_tensor(x), paddle.to_tensor(off))
    assert dev(got.detach().numpy(), np.asarray(want.numpy())) <= TOL
    feat, boxes, bn = n_(2, 8, 9, 9), _boxes(3, size=9.0), np.array([1, 2])
    for name, args in (("RoIPool", (2, 1.0)), ("PSRoIPool", (2, 1.0)),
                       ("RoIAlign", (2, 1.0))):
        got = getattr(tops, name)(*args)(torch.from_numpy(feat),
                                         torch.from_numpy(boxes),
                                         torch.from_numpy(bn))
        want = getattr(jops, name)(*args)(paddle.to_tensor(feat),
                                          paddle.to_tensor(boxes),
                                          paddle.to_tensor(bn))
        assert dev(got.numpy(), np.asarray(want.numpy())) <= TOL, name


def test_tensor_boundary():
    b = pt.to_tensor(_boxes(3))
    out = tops.box_iou(b, b)
    assert isinstance(out, pt.Tensor)
    keep = tops.nms(b, 0.5)
    assert isinstance(keep, pt.Tensor)
