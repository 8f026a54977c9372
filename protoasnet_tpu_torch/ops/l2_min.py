"""Fused squared-L2 distance map + global min pool (ProtoPNet's 1x1 head).

    dist[n, s, p] = relu(|x[n, s]|^2 - 2 <x[n, s], w[p]> + |w[p]|^2)
    min_d[n, p]   = min_s dist[n, s, p]

over the positions s of each sample's channels-last map. ``l2_min_torch``
is the plain PyTorch version (the arithmetic of ``ops/l2conv.py``);
``l2_min_head`` sends CUDA tensors to the hand-written kernel
(``ops/l2_min_cuda.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from protoasnet_tpu_torch.ops.l2conv import l2_patch_distances

__all__ = ["l2_min_torch", "l2_min_head"]


def l2_min_torch(x: torch.Tensor, prototypes: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, ..., D), prototypes (P, 1, 1, D) or (P, D) -> (dist (N, ...,
    P), min_d (N, P)), in at least fp32 (float64 stays float64)."""
    n, d = x.shape[0], x.shape[-1]
    p = prototypes.shape[0]
    s = math.prod(x.shape[1:-1])  # positions (explicit: N may be 0)
    dist = l2_patch_distances(x.reshape(n, s, 1, d),
                              prototypes.reshape(p, 1, 1, d))
    dist = dist.reshape(n, s, p)
    return dist.reshape(*x.shape[:-1], p), dist.amin(1)


def l2_min_head(x: torch.Tensor, prototypes: torch.Tensor,
                impl: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dist (N, ..., P), min_d (N, P)).

    impl=None: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. impl="torch": the plain version on any device (tests and the
    chip smoke compare the kernel with it).
    """
    if impl is None:
        from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda

        return l2_min_cuda(x, prototypes)
    if impl == "torch":
        return l2_min_torch(x, prototypes)
    raise ValueError(f"unknown head impl {impl!r}; use None or 'torch'")
