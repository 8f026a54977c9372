"""Fused squared-L2 distance map + global min pool (ProtoPNet's 1x1 head).

    dist[n, s, p] = relu(|x[n, s]|^2 - 2 <x[n, s], w[p]> + |w[p]|^2)
    min_d[n, p]   = min_s dist[n, s, p]

over the positions s of each sample's channels-last map. ``l2_min_torch``
is the plain PyTorch version (the arithmetic of ``ops/l2conv.py``), whose
gradient is torch's autograd (``amin`` splits a tied minimum's cotangent
evenly, as JAX's ``jnp.min`` does on the JAX package's default head);
``l2_min_head`` sends CUDA tensors to the hand-written kernel
(``ops/l2_min_cuda.py``). ``l2_min_backward`` is the closed-form gradient
of the JAX package's Pallas head (``pallas_l2.py::_bwd``), which the
kernel's autograd Function uses: a tied minimum's cotangent goes to its
first position.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from protoasnet_tpu_torch.ops.l2conv import l2_patch_distances

__all__ = ["l2_min_torch", "l2_min_head", "l2_min_backward"]


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


def l2_min_backward(x2d: torch.Tensor, w: torch.Tensor, dist: torch.Tensor,
                    g_dist: Optional[torch.Tensor],
                    g_min: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The head's cotangents (g_x (N,S,D), g_w (P,D)) from the forward's
    residuals x2d (N,S,D), w (P,D), dist (N,S,P) (the distances the forward
    returned) and the output cotangents g_dist (N,S,P), g_min (N,P) (None:
    zero), as ``pallas_l2.py::_bwd`` computes them:

        g = g_dist + g_min routed to the FIRST s where dist == min_s dist
        g = g * (dist > 0)                       (the relu gate)
        g_x = 2 (x * rowsum_p(g) - g @ w)
        g_w = 2 (w * sum_{n,s}(g) - g^T x)

    in fp32 (float64 when an input is float64); each cotangent comes back
    in its primal's dtype."""
    wide = torch.float64 if torch.float64 in (x2d.dtype, w.dtype) \
        else torch.float32
    n, s, d = x2d.shape
    p = w.shape[0]
    xa, wa = x2d.to(wide), w.to(wide)
    g = (torch.zeros((n, s, p), dtype=wide, device=x2d.device)
         if g_dist is None else g_dist.to(wide))
    if g_min is not None:
        # the first minimal position, by the cumsum of _bwd (a NaN column
        # has no minimal position and routes nothing)
        is_min = dist == dist.amin(1, keepdim=True)
        first = is_min & (torch.cumsum(is_min, 1) == 1)
        g = g + first * g_min.to(wide)[:, None, :]
    g = g * (dist > 0)
    g_x = 2.0 * (xa * g.sum(2, keepdim=True) - torch.matmul(g, wa))
    g2 = g.reshape(n * s, p)
    g_w = 2.0 * (wa * g2.sum(0)[:, None]
                 - torch.matmul(g2.T, xa.reshape(n * s, d)))
    return g_x.to(x2d.dtype), g_w.to(w.dtype)


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
