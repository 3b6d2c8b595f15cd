"""Convolution functionals over torch's convolutions (cuDNN on the card).

Counterpart of `paddle_tpu/nn/functional/conv.py`, where the reference
calls `lax.conv_general_dilated`. Weights are paddle's layout: OIHW for
conv, [in, out / groups, *k] for the transposes.

Padding takes every form the reference reads (`_padding_arg`, :24-35): an
int, n ints, 2n ints (read as a pair per dimension), n pairs, "SAME" and
"VALID". "SAME" follows lax's rule at any stride: total = max((ceil(in /
s) - 1) * s + (k - 1) * d + 1 - in, 0), low = total // 2, the odd pixel on
the high side. Torch's convolution pads symmetrically only, so an
asymmetric or negative padding becomes an explicit `F.pad` first.

`data_format="NHWC"` (any channel-last form) means the input and output
are channel-last while the weights stay OIHW (the reference transposes
them at use, :57-60): the input is permuted to an NCHW view of its
channel-last memory, the convolution runs on that view (no copy when the
input is contiguous) and its output is permuted back.

conv is an AMP white-list op (the input, the weight and the bias are cast
to the autocast dtype); the transposes are not, as in the reference.

The transposes (:92-148) take `output_padding`; the reference never reads
`output_size` (a kept difference from paddle, ROADMAP Queue 3), nor does
the port. Their padding is lax's on the stride-dilated input with the
flipped kernel, so the port runs torch's transpose unpadded and then
crops (or zero-pads) each side to the reference's extent.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...amp.state import maybe_cast

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuplize(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(int(x) for x in v)


def _padding_arg(padding, n):
    """paddle padding: int, list[int], 2n ints, n pairs, 'SAME'/'VALID'."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n:
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    return [tuple(int(v) for v in p) for p in padding]


def same_pads(spatial, kernel, strides, dilations):
    """lax.padtype_to_pads(..., "SAME"): (low, high) per dimension."""
    pads = []
    for n, k, s, d in zip(spatial, kernel, strides, dilations):
        k_eff = (k - 1) * d + 1
        total = max((math.ceil(n / s) - 1) * s + k_eff - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def channel_last(data_format) -> bool:
    df = data_format.upper()
    return df.endswith("C") and not df.startswith("NC")


def _flat(pads):
    """(low, high) per dimension, first to last -> F.pad's order."""
    return [w for lo_hi in reversed(pads) for w in lo_hi]


def _conv(x, weight, bias, stride, padding, dilation, groups, nd,
          data_format):
    cl = channel_last(data_format)
    strides, dilations = _tuplize(stride, nd), _tuplize(dilation, nd)
    if bias is None:
        x, weight = maybe_cast(x, weight)
    else:
        x, weight, bias = maybe_cast(x, weight, bias)
    if cl:
        x = x.movedim(-1, 1)
    pads = _padding_arg(padding, nd)
    if pads == "VALID":
        pads = [(0, 0)] * nd
    elif pads == "SAME":
        pads = same_pads(x.shape[2:], weight.shape[2:], strides, dilations)
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        sym = [lo for lo, _ in pads]
    else:
        x = TF.pad(x, _flat(pads))
        sym = [0] * nd
    out = _CONV[nd](x, weight, bias, strides, sym, dilations, groups)
    return out.movedim(1, -1) if cl else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, nd, data_format):
    cl = channel_last(data_format)
    strides, dilations = _tuplize(stride, nd), _tuplize(dilation, nd)
    opad = _tuplize(output_padding, nd) if output_padding is not None \
        else (0,) * nd
    if cl:
        x = x.movedim(-1, 1)
    k_eff = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilations)]
    pads = _padding_arg(padding, nd)
    if isinstance(pads, str):
        # lax pads the input's own extent (not the dilated one) at stride 1
        lax_pads = same_pads(x.shape[2:], weight.shape[2:], (1,) * nd,
                             dilations) if pads == "SAME" else [(0, 0)] * nd
    else:
        lax_pads = [(ke - 1 - lo, ke - 1 - hi + op)
                    for ke, (lo, hi), op in zip(k_eff, pads, opad)]
    # torch's unpadded transpose is lax's with (k_eff - 1) on both sides
    out = _CONV_T[nd](x, weight, None, strides, 0, 0, groups, dilations)
    trim = [(lo - (ke - 1), hi - (ke - 1))
            for (lo, hi), ke in zip(lax_pads, k_eff)]
    if any(w for lo_hi in trim for w in lo_hi):
        out = TF.pad(out, _flat(trim))
    if bias is not None:
        out = out + bias.reshape([1, -1] + [1] * nd)
    return out.movedim(1, -1) if cl else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1, output_size=None,
                     data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format)


__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]
