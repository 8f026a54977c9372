"""(3,1,1) temporal convolution, channels-last, SAME zero padding in T.

    y[b, t, s, :] = sum_{dt in 0,1,2} x[b, t + dt - 1, s, :] @ k[dt]

with x (B, T, S, C) (or (B, T, *spatial, C)), k (3, C, O) and x[b, -1] =
x[b, T] = 0: the temporal half of the R(2+1)D trunk's ``Conv2Plus1D`` with
stride 1. ``temporal_conv_torch`` is the plain PyTorch version (fp32 sums,
float64 stays float64, output in x's dtype); ``ops/temporal_conv_cuda.py``
launches the hand-written kernel on CUDA tensors and runs this version on
CPU ones. ``split_bf16`` and ``split_tf32`` are how that wrapper hands the
taps to the kernel's bf16 and 3xTF32 products.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["temporal_conv_torch", "split_bf16", "split_tf32"]


def temporal_conv_torch(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (B, T, ..., C), k (3, C, O) -> (B, T, ..., O) in x's dtype."""
    acc = torch.promote_types(torch.promote_types(torch.float32, x.dtype),
                              k.dtype)
    xf, kf = x.to(acc), k.to(acc)
    y = torch.einsum("bt...c,co->bt...o", xf, kf[1])
    if x.shape[1] > 1:
        y[:, 1:] += torch.einsum("bt...c,co->bt...o", xf[:, :-1], kf[0])
        y[:, :-1] += torch.einsum("bt...c,co->bt...o", xf[:, 1:], kf[2])
    return y.to(x.dtype)


def split_bf16(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """k (fp32 or bf16) as two bf16 tensors, k_hi = bf16(k) and k_lo =
    bf16(k - k_hi), so that k_hi + k_lo equals k to ~2^-18 of |k|; k_lo is
    all zero when every value of k is a bf16 (a bf16 k)."""
    kf = k.to(torch.float32)
    hi = kf.to(torch.bfloat16)
    return hi, (kf - hi.to(torch.float32)).to(torch.bfloat16)


def _round_tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 (10 mantissa bits, ties away from zero),
    as ``cvt.rna.tf32.f32`` rounds; kept in fp32 with the low 13 bits 0."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """k as two TF32 values in fp32 tensors, hi = tf32(k) and lo = tf32(k -
    hi): the taps' halves of the kernel's 3xTF32 products."""
    kf = k.to(torch.float32)
    hi = _round_tf32(kf)
    return hi, _round_tf32(kf - hi)
