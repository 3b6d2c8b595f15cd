"""Spatial sampling functionals: grid_sample, affine_grid, temporal_shift.

Counterpart of `paddle_tpu/nn/functional/vision.py`. The samplers are
gathers: each output pixel's corner taps become flat indices into the
[N, C, H*W] image, with the reference's coordinate rules (unnormalise,
reflect, clip) and its zero weights outside the image.
"""
from __future__ import annotations

import torch


def _unnormalize(coord, size, align_corners):
    if align_corners:
        return (coord + 1.0) * (size - 1) / 2.0
    return ((coord + 1.0) * size - 1.0) / 2.0


def _reflect(coord, size, align_corners):
    """Triangle-wave reflection onto [0, size - 1] (align_corners) or
    [-0.5, size - 0.5]."""
    if size == 1:
        return torch.zeros_like(coord)
    lo, span = (0.0, float(size - 1)) if align_corners \
        else (-0.5, float(size))
    t = torch.abs(coord - lo)
    extra = torch.remainder(t, span)
    even = torch.remainder(torch.floor(t / span), 2.0) == 0
    return torch.where(even, extra + lo, span - extra + lo)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """x [N, C, H, W], grid [N, Hg, Wg, 2] of (x, y) in [-1, 1] ->
    [N, C, Hg, Wg]."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"grid_sample mode must be bilinear|nearest, "
                         f"got {mode}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"bad padding_mode {padding_mode}")
    n, c, h, w = x.shape
    hg, wg = grid.shape[1], grid.shape[2]
    gx = _unnormalize(grid[..., 0].float(), w, align_corners).reshape(n, -1)
    gy = _unnormalize(grid[..., 1].float(), h, align_corners).reshape(n, -1)
    if padding_mode == "reflection":
        gx, gy = _reflect(gx, w, align_corners), _reflect(gy, h, align_corners)
    if padding_mode in ("border", "reflection"):
        gx, gy = torch.clamp(gx, 0.0, w - 1), torch.clamp(gy, 0.0, h - 1)
    flat = x.reshape(n, c, h * w)

    def tap(ix, iy):
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = torch.clamp(iy, 0, h - 1) * w + torch.clamp(ix, 0, w - 1)
        v = torch.gather(flat, 2, idx[:, None, :].expand(n, c, idx.shape[1]))
        return v, valid

    if mode == "nearest":
        v, valid = tap(torch.round(gx).long(), torch.round(gy).long())
        if padding_mode == "zeros":
            v = torch.where(valid[:, None], v, torch.zeros_like(v))
        return v.reshape(n, c, hg, wg)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx1, wy1 = (gx - x0).to(x.dtype), (gy - y0).to(x.dtype)
    x0i, y0i = x0.long(), y0.long()
    out = torch.zeros((n, c, gx.shape[1]), dtype=x.dtype, device=x.device)
    for dy in (0, 1):
        for dx in (0, 1):
            v, valid = tap(x0i + dx, y0i + dy)
            wt = (wx1 if dx else 1 - wx1) * (wy1 if dy else 1 - wy1)
            if padding_mode == "zeros":
                wt = torch.where(valid, wt, torch.zeros_like(wt))
            out = out + v * wt[:, None, :]
    return out.reshape(n, c, hg, wg)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """theta [N, 2, 3] -> the sampling grid [N, H, W, 2] of grid_sample."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.reshape(-1).tolist()
    _, _, h, w = [int(v) for v in out_shape]
    dev = theta.device
    if align_corners:
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
    else:
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1.0
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(
        1, h * w, 3).to(theta.dtype)
    grid = torch.einsum("nhk,nck->nhc",
                        base.expand(theta.shape[0], h * w, 3), theta)
    return grid.reshape(theta.shape[0], h, w, 2)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None,
                   data_format="NCHW"):
    """TSM shift on [N*T, C, H, W]: the first shift_ratio * C channels
    take frame t + 1, the next block frame t - 1, the rest stay; zeros at
    the clip's edges."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"bad data_format {data_format}")
    a = x.permute(0, 3, 1, 2) if data_format == "NHWC" else x
    nt, c, h, w = a.shape
    a = a.reshape(nt // seg_num, seg_num, c, h, w)
    c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
    fwd = torch.cat([a[:, 1:, :c1], torch.zeros_like(a[:, :1, :c1])], 1)
    bwd = torch.cat([torch.zeros_like(a[:, :1, c1:c2]), a[:, :-1, c1:c2]], 1)
    out = torch.cat([fwd, bwd, a[:, :, c2:]], 2).reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


__all__ = ["grid_sample", "affine_grid", "temporal_shift"]
