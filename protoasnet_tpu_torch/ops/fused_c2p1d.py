"""Eval-mode Conv2Plus1D block (stride 1), channels-last, as one function.

    mid = relu(conv_(1,3,3),SAME(x; ks) * scale + shift)   rounded to x's dtype
    out = conv_(3,1,1)(mid; kt), zero mid frames at t = -1 and t = T

with x (B, T, H, W, C), ks (3, 3, C, Cm), scale/shift (Cm,) (the eval
BatchNorm folded to an affine), kt (3, Cm, Co) -> out (B, T, H, W, Co) in
x's dtype. The temporal conv pads the *mid* with zeros, so mid[-1] is 0,
not relu(shift). ``fused_c2p1d_torch`` is the plain PyTorch version (fp32
sums, float64 stays float64); ``fold_conv2plus1d`` turns a port
``Conv2Plus1D`` into those arguments. ``ops/fused_c2p1d_cuda.py`` launches
the hand-written kernel, which keeps mid in shared memory, on CUDA tensors
and runs the plain version on CPU ones.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from protoasnet_tpu_torch.ops.temporal_conv import temporal_conv_torch

__all__ = ["fused_c2p1d_torch", "fold_conv2plus1d"]


def fused_c2p1d_torch(x: torch.Tensor, ks: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, T, H, W, C) -> (B, T, H, W, Co) in x's dtype."""
    acc = torch.float32
    for a in (x, ks, scale, shift, kt):
        acc = torch.promote_types(acc, a.dtype)
    h, w = x.shape[2], x.shape[3]
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))  # SAME: zeros around H and W
    ksf = ks.to(acc)
    mid = None
    for dh in range(3):
        for dw in range(3):
            part = torch.einsum("bthwc,cm->bthwm",
                                xp[:, :, dh:dh + h, dw:dw + w], ksf[dh, dw])
            mid = part if mid is None else mid.add_(part)
    mid = torch.relu(mid * scale.to(acc) + shift.to(acc)).to(x.dtype)
    return temporal_conv_torch(mid, kt)


def fold_conv2plus1d(module: torch.nn.Module
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """A port ``Conv2Plus1D`` with stride 1 in eval mode -> (ks (3, 3, C,
    Cm), scale (Cm,) fp32, shift (Cm,) fp32, kt (3, Cm, Co)); the taps keep
    the module's weight dtype."""
    if module.training:
        raise ValueError("fold_conv2plus1d: the module is in training mode; "
                         "only eval BatchNorm folds to an affine")
    if tuple(module.spatial.stride) != (1, 1, 1) \
            or tuple(module.temporal.stride) != (1, 1, 1):
        raise ValueError(f"fold_conv2plus1d: strides "
                         f"{tuple(module.spatial.stride)} / "
                         f"{tuple(module.temporal.stride)}; the fused block "
                         f"computes stride 1 only")
    bn = module.bn_mid
    with torch.no_grad():
        ks = module.spatial.weight.detach()[:, :, 0].permute(2, 3, 1, 0)
        scale = bn.weight.detach().float() / torch.sqrt(
            bn.running_var.detach().float() + bn.eps)
        shift = bn.bias.detach().float() \
            - bn.running_mean.detach().float() * scale
        kt = module.temporal.weight.detach()[:, :, :, 0, 0].permute(2, 1, 0)
    return ks.contiguous(), scale, shift, kt.contiguous()
