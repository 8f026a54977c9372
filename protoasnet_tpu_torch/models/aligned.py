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
holds no ``QuantConv``), with the trunk rebuilt:

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
  channel gets a zero weight row and a zero bias for it, the conv that
  consumes it a zero weight column, so the channel is exactly 0 after the
  epilogue and adds exactly 0 downstream;
* each eval BatchNorm is folded, once, into the conv before it: with s =
  γ / sqrt(var + eps), the conv's weight becomes w·s per output channel
  and the shift β − μ·s a per-channel bias held beside it (in fp32, from
  the model's fp32 weights and running statistics), the downsample
  BatchNorm's shift added to the block's second one. The convs stay
  bias-free, so cuDNN runs the same conv shapes; what is left after each
  conv is one pass, ``relu(y + bias (+ residual))``
  (``ops/conv_epilogue_cuda.py``: a hand-written CUDA kernel in place on
  the card, else the plain route), 26 a forward: 2 in the stem and 2 in
  each (2+1)D conv. The copy holds no BatchNorm. The same mathematics,
  rounded elsewhere: in fp32 the logits move by ~1e-7.

The copy is eval-only and takes no gradient. It shares the model's head
modules; the model keeps the upstream shapes and its BatchNorms, so
training (which writes the running statistics of the real channels), the
int8 path (which swaps the trunk's convs) and the bundle, checkpoint and
weight importers never see it. ``serve.py::_device_forward`` builds it
once per device.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from protoasnet_tpu_torch.models.backbones.r2plus1d import (
    BasicBlock2Plus1D, Conv2Plus1D, R2Plus1D18)
from protoasnet_tpu_torch.ops.conv_epilogue_cuda import conv_epilogue
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


class _Epilogue(nn.Module):
    """``relu(y + bias (+ residual))`` after a conv whose BatchNorm was
    folded into it: ``bias`` is the BatchNorm's shift (fp32)."""

    def __init__(self, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("bias", bias)

    def forward(self, y: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return conv_epilogue(y, self.bias, residual)


class _ServedConv2Plus1D(nn.Module):
    """conv -> epilogue -> conv -> epilogue: a (2+1)D conv with the
    BatchNorm after each of its convs folded in (the stem too)."""

    def __init__(self, spatial: nn.Conv3d, mid: _Epilogue,
                 temporal: nn.Conv3d, out: _Epilogue):
        super().__init__()
        self.spatial, self.mid = spatial, mid
        self.temporal, self.out = temporal, out

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.out(self.temporal(self.mid(self.spatial(x))), residual)


class _ServedBlock(nn.Module):
    """A basic block whose second (2+1)D conv ends in the residual sum."""

    def __init__(self, conv1: _ServedConv2Plus1D, conv2: _ServedConv2Plus1D,
                 downsample_conv: Optional[nn.Conv3d]):
        super().__init__()
        self.conv1, self.conv2 = conv1, conv2
        self.downsample_conv = downsample_conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample_conv is None \
            else self.downsample_conv(x)
        return self.conv2(self.conv1(x), residual)


class _ServedTrunk(nn.Module):
    """The served R(2+1)D trunk: (N, C, T, H, W) channels-last ->
    (N, C', T', H', W') channels-last."""

    def __init__(self, stem: _ServedConv2Plus1D, blocks, out_channels: int):
        super().__init__()
        self.stem = stem
        self.layer_names = [name for name, _ in blocks]
        for name, block in blocks:
            self.add_module(name, block)
        self.out_channels = out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(x)
        for name in self.layer_names:
            x = getattr(self, name)(x)
        return x


def _fold(conv: nn.Conv3d, bn: nn.BatchNorm3d
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval ``bn`` after ``conv`` folded into it: (w·s, β − μ·s), s = γ
    / sqrt(var + eps) per output channel, in fp32 (or the weight's wider
    dtype)."""
    dt = torch.promote_types(conv.weight.dtype, torch.float32)
    s = bn.weight.detach().to(dt) / torch.sqrt(
        bn.running_var.to(dt) + bn.eps)
    w = conv.weight.detach().to(dt) * s.view(-1, 1, 1, 1, 1)
    return w, bn.bias.detach().to(dt) - bn.running_mean.to(dt) * s


def _padded_conv(w: torch.Tensor, cin: int, cout: int, stride,
                 padding) -> nn.Conv3d:
    """A conv (a ``_TemporalConv`` for a (k,1,1) kernel, k > 1) holding
    ``w`` in its first rows and columns, zeros elsewhere."""
    temporal = tuple(w.shape[3:]) == (1, 1) and w.shape[2] > 1
    out = (_TemporalConv if temporal else nn.Conv3d)(
        cin, cout, tuple(w.shape[2:]), stride=stride, padding=padding,
        bias=False, device=w.device, dtype=w.dtype)
    with torch.no_grad():
        out.weight.zero_()
        out.weight[:w.shape[0], :w.shape[1]].copy_(w)
    return out


def _epilogue(shift: torch.Tensor, c: int) -> _Epilogue:
    """The shift in the first of ``c`` channels, zeros after."""
    bias = shift.new_zeros(c)
    bias[:len(shift)] = shift
    return _Epilogue(bias)


def _s2d_weight(w: torch.Tensor) -> torch.Tensor:
    """(O, C, 1, 7, 7) -> (O, 4C, 1, 4, 4): tap i of a row reads padded row
    2h' + i + 1, block (i + 1) // 2 at phase (i + 1) % 2; channels are
    (row phase, column phase, C)."""
    o, c = w.shape[:2]
    w = F.pad(w.detach(), (1, 0, 1, 0)).reshape(o, c, 1, 4, 2, 4, 2)
    return w.permute(0, 4, 6, 1, 2, 3, 5).reshape(o, 4 * c, 1, 4, 4)


def _served_conv(spatial: nn.Conv3d, bn_mid: nn.BatchNorm3d,
                 temporal: nn.Conv3d, bn_out: nn.BatchNorm3d,
                 s2d: bool = False,
                 extra_shift: Optional[torch.Tensor] = None
                 ) -> _ServedConv2Plus1D:
    """spatial -> bn_mid -> ReLU -> temporal -> bn_out folded, the
    mid-planes padded to ``ALIGN``; ``s2d``: the spatial conv is the stem's
    and runs space-to-depth; ``extra_shift`` joins bn_out's shift."""
    w1, b1 = _fold(spatial, bn_mid)
    w2, b2 = _fold(temporal, bn_out)
    mid = _up(spatial.out_channels)
    if s2d:
        first = _padded_conv(_s2d_weight(w1), _up(4 * spatial.in_channels),
                             mid, 1, 0)
    else:
        first = _padded_conv(w1, spatial.in_channels, mid, spatial.stride,
                             spatial.padding)
    second = _padded_conv(w2, mid, temporal.out_channels, temporal.stride,
                          temporal.padding)
    if extra_shift is not None:
        b2 = b2 + extra_shift
    return _ServedConv2Plus1D(first, _epilogue(b1, mid), second,
                              _epilogue(b2, temporal.out_channels))


def _served_block(block: BasicBlock2Plus1D) -> _ServedBlock:
    def conv(c: Conv2Plus1D, bn, extra=None):
        return _served_conv(c.spatial, c.bn_mid, c.temporal, bn,
                            extra_shift=extra)

    down, shift = None, None
    if block.has_downsample:
        d = block.downsample_conv
        w, shift = _fold(d, block.downsample_bn)
        down = _padded_conv(w, d.in_channels, d.out_channels, d.stride,
                            d.padding)
    return _ServedBlock(conv(block.conv1, block.bn1),
                        conv(block.conv2, block.bn2, shift), down)


def aligned_trunk(trunk: R2Plus1D18) -> nn.Module:
    """An eval-only served copy of ``trunk`` that takes
    ``aligned_input``'s batches (permuted to (N, C, T, H, W)), laid out
    and folded as the module says."""
    stem = _served_conv(trunk.stem_spatial, trunk.stem_bn1,
                        trunk.stem_temporal, trunk.stem_bn2, s2d=True)
    blocks = [(name, _served_block(getattr(trunk, name)))
              for name in trunk.layer_names]
    t = _ServedTrunk(stem, blocks, trunk.out_channels)
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
