"""The served R(2+1)D trunk laid out for cuDNN's tensor cores: channel
counts that are multiples of 8, ``channels_last_3d`` throughout, the
temporal convs as 2-D convs and the stem as a space-to-depth conv.

On an H100 (cuDNN 9.2, bf16 under autocast) the NCDHW trunk ran five of its
convs as fp32 FMAs on the CUDA cores: the (3,1,1) temporal convs at 32
frames of 56x56 (the stem's and layer1's), at any batch and whatever their
channel counts, with ``cudnn.benchmark`` too; cuDNN put a layout and a dtype
conversion around each of those and an NCDHW <-> NDHWC pair around every
other conv (``PERF.md`` §5). ``aligned_serving_model(model)`` returns a
serving copy of an ``XProtoNet`` whose trunk is an ``R2Plus1D18`` (and
holds no ``QuantConv``), with the trunk rebuilt, exactly:

* every weight and activation is ``channels_last_3d``: the wire's (N, T, H,
  W, C) batch enters permuted as a view and the trunk's output permutes
  back to (N, T', H', W', C) for free;
* a temporal (k,1,1) conv runs as a 2-D (k,1) conv over the (N, C, T, H·W)
  view of its input (``_TemporalConv``), the same products, which cuDNN
  runs on the tensor cores;
* the stem's (1,7,7)/stride-(1,2,2) conv over 3 channels runs as a
  (1,4,4)/stride-1 conv over the input's 2x2 pixel blocks, 12 channels
  padded to 16 (``aligned_input`` builds that input; the JAX package's
  ``SpaceToDepthStemConv`` rewrite): the same products, in half the time of
  the 3-channel conv padded to 8 channels on an H100 (``PERF.md`` §6);
* each other channel count rounds up to a multiple of 8 (the mid-planes
  45, 230 and 460 to 48, 232 and 464): the conv that produces a padded
  channel gets a zero weight row for it, the conv that consumes it a zero
  weight column, and the BatchNorm between them mean 0, variance 1, weight
  1 and bias 0 there, so the channel is exactly 0 after BN and ReLU and
  adds exactly 0 downstream.

The copy is eval-only and takes no gradient. It shares the model's head
modules; the model keeps the upstream shapes, so training (which writes the
running statistics of the real channels), the int8 path (which swaps the
trunk's convs) and the bundle, checkpoint and weight importers never see
it. ``serve.py::_device_forward`` builds it once per device.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from protoasnet_tpu_torch.models.backbones.r2plus1d import (Conv2Plus1D,
                                                            R2Plus1D18)
from protoasnet_tpu_torch.quant import QuantConv

__all__ = ["aligned_trunk", "aligned_serving_model", "aligned_input"]

ALIGN = 8
# the space-to-depth stem: (1,7,7)/2 over C channels == (1,4,4)/1 over the
# 2x2 blocks of the input padded by 4 before and 2 (3 at an odd size) after
_S2D_BEFORE, _S2D_AFTER = 4, 2


def _up(c: int) -> int:
    return -(-c // ALIGN) * ALIGN


class _TemporalConv(nn.Conv3d):
    """A (k,1,1) conv of a channels-last input, run as a 2-D (k,1) conv of
    its (N, C, T, H·W) view."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.flatten(3), self.weight.flatten(3), None,
                     (self.stride[0], 1), (self.padding[0], 0))
        return y.unflatten(3, x.shape[3:])


def _padded_conv(w: torch.Tensor, cin: int, cout: int, stride,
                 padding) -> nn.Conv3d:
    """A conv (a ``_TemporalConv`` for a (k,1,1) kernel) holding ``w`` in
    its first rows and columns, zeros elsewhere."""
    kind = _TemporalConv if tuple(w.shape[3:]) == (1, 1) else nn.Conv3d
    out = kind(cin, cout, tuple(w.shape[2:]), stride=stride,
               padding=padding, bias=False, device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.zero_()
        out.weight[:w.shape[0], :w.shape[1]].copy_(w)
    return out


def _padded_bn(bn: nn.BatchNorm3d, c: int) -> nn.BatchNorm3d:
    # a fresh BatchNorm holds mean 0, variance 1, weight 1 and bias 0
    out = nn.BatchNorm3d(c, eps=bn.eps, momentum=bn.momentum,
                         device=bn.weight.device)
    n = bn.num_features
    with torch.no_grad():
        for name in ("running_mean", "running_var", "weight", "bias"):
            getattr(out, name)[:n].copy_(getattr(bn, name))
    return out


def _s2d_weight(w: torch.Tensor) -> torch.Tensor:
    """(O, C, 1, 7, 7) -> (O, 4C, 1, 4, 4): tap i of a row reads padded row
    2h' + i + 1, block (i + 1) // 2 at phase (i + 1) % 2; channels are
    (row phase, column phase, C)."""
    o, c = w.shape[:2]
    w = F.pad(w.detach(), (1, 0, 1, 0)).reshape(o, c, 1, 4, 2, 4, 2)
    return w.permute(0, 4, 6, 1, 2, 3, 5).reshape(o, 4 * c, 1, 4, 4)


def aligned_trunk(trunk: R2Plus1D18) -> R2Plus1D18:
    """An eval-only copy of ``trunk`` that takes ``aligned_input``'s
    batches (permuted to (N, C, T, H, W)), laid out as the module says."""
    t = copy.deepcopy(trunk)
    stem = t.stem_spatial
    s2d = _padded_conv(_s2d_weight(stem.weight), _up(4 * stem.in_channels),
                       _up(stem.out_channels), 1, 0)
    pairs = [(t, "stem_spatial", "stem_bn1", "stem_temporal", s2d)]
    pairs += [(m, "spatial", "bn_mid", "temporal", None) for m in t.modules()
              if isinstance(m, Conv2Plus1D)]
    for owner, first, bn, second, new in pairs:
        a, b = getattr(owner, first), getattr(owner, second)
        mid = _up(a.out_channels)
        setattr(owner, first, new or _padded_conv(
            a.weight.detach(), a.in_channels, mid, a.stride, a.padding))
        setattr(owner, bn, _padded_bn(getattr(owner, bn), mid))
        setattr(owner, second, _padded_conv(
            b.weight.detach(), mid, b.out_channels, b.stride, b.padding))
    return t.to(memory_format=torch.channels_last_3d).eval(
    ).requires_grad_(False)


def aligned_serving_model(model: nn.Module) -> Optional[nn.Module]:
    """A copy of the eval-mode ``model`` that serves through
    ``aligned_trunk`` and takes ``aligned_input``'s batches, or None where
    the model's trunk is not an ``R2Plus1D18`` or the model holds a
    ``QuantConv``. Only the trunk is new; the other modules are the
    model's own. The copy takes the model's attributes as they are when it
    is built: one set on the model later (``head_impl``) does not reach
    it."""
    trunk = getattr(model, "cnn_backbone", None)
    if not isinstance(trunk, R2Plus1D18) or any(
            isinstance(m, QuantConv) for m in model.modules()):
        return None
    served = copy.copy(model)
    served._modules = dict(model._modules,
                           cnn_backbone=aligned_trunk(trunk))
    return served


def aligned_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Clips (N, T, H, W, C) -> the space-to-depth stem's input (N, T,
    (H + 7) // 2, (W + 7) // 2, 4C rounded up to ``ALIGN``) in ``dtype``:
    the clip padded as the stem conv pads it, its 2x2 pixel blocks as
    channels, the extra channels zero. ``x`` may be a broadcast view (gray
    expanded to 3 channels)."""
    n, t, h, w, c = x.shape
    xp = F.pad(x, (0, 0, _S2D_BEFORE, _S2D_AFTER + w % 2,
                   _S2D_BEFORE, _S2D_AFTER + h % 2))
    hh, ww = xp.shape[2] // 2, xp.shape[3] // 2
    out = x.new_zeros((n, t, hh, ww, _up(4 * c)), dtype=dtype)
    out[..., :4 * c].unflatten(-1, (2, 2, c)).copy_(
        xp.reshape(n, t, hh, 2, ww, 2, c).permute(0, 1, 2, 4, 3, 5, 6))
    return out
