"""(3,1,1) temporal convolution, channels-last, SAME zero padding in T.

    y[b, t, s, :] = sum_{dt in 0,1,2} x[b, t + dt - 1, s, :] @ k[dt]

with x (B, T, S, C) (or (B, T, *spatial, C)), k (3, C, O) and x[b, -1] =
x[b, T] = 0: the temporal half of the R(2+1)D trunk's ``Conv2Plus1D`` with
stride 1. ``temporal_conv_torch`` is the plain PyTorch version (fp32 sums,
float64 stays float64, output in x's dtype); ``ops/temporal_conv_cuda.py``
launches the hand-written kernel on CUDA tensors and runs this version on
CPU ones.
"""

from __future__ import annotations

import torch

__all__ = ["temporal_conv_torch"]


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
