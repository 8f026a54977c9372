"""Patch-to-prototype squared L2 distances (classic ProtoPNet prototype layer).

    dist[n, h, w, p] = relu(sum_patch x^2 - 2 <x_patch, proto_p> + |proto_p|^2)

The cancellation formula is kept as the JAX package writes it (not
``(x - w)^2`` and not ``torch.cdist``): the results agree only if the
arithmetic does. 1x1 prototypes (every shipped config) are one
(N*H*W, D) @ (D, P) product; other kernel sizes use ``F.conv2d`` with the
prototypes as filters and a ones kernel for the patch sums of x^2 (cuDNN
takes fp32 convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32``
is off). Computes in at least fp32 and never downcasts float64.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["l2_patch_distances"]


def l2_patch_distances(x: torch.Tensor, prototypes: torch.Tensor
                       ) -> torch.Tensor:
    """x (N, H, W, D) conv features, prototypes (P, kh, kw, D), both
    channels-last -> (N, H', W', P) squared distances per patch (VALID)."""
    p, kh, kw, d = prototypes.shape
    dt = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dt)
    if (kh, kw) == (1, 1):
        w = prototypes.reshape(p, d).to(dt)
        x2 = (x * x).sum(-1, keepdim=True)  # (N, H, W, 1)
        p2 = (w * w).sum(-1)  # (P,)
        xp = torch.einsum("nhwd,pd->nhwp", x, w)
        return torch.relu(x2 - 2.0 * xp + p2)
    kernel = prototypes.permute(0, 3, 1, 2).to(dt)  # (P, D, kh, kw)
    xc = x.permute(0, 3, 1, 2)  # NCHW
    x2_patch = F.conv2d(xc * xc, torch.ones_like(kernel))
    xp = F.conv2d(xc, kernel)
    p2 = (prototypes.reshape(p, -1) ** 2).sum(-1).to(dt)
    dist = torch.relu(x2_patch - 2.0 * xp + p2[None, :, None, None])
    return dist.permute(0, 2, 3, 1)
