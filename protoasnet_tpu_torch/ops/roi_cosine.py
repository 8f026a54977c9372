"""Occurrence-weighted ROI pooling + prototype cosine similarity.

ProtoASNet's prototype head:

    roi[n, p, :] = sum_{t,h,w} occ[n, t, h, w, p] * feat[n, t, h, w, :]
    sim[n, p]    = (cos(roi[n, p, :], proto[p, :]) + 1) / 2

with torch.nn.CosineSimilarity's eps=1e-8 clamp on each norm. The functions
here are the plain PyTorch version; ``roi_cosine_head`` sends CUDA tensors
to the hand-written kernel (``ops/roi_cosine_cuda.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["roi_pool", "cosine_similarity_to_prototypes", "roi_cosine_torch",
           "roi_cosine_head"]

_EPS = 1e-8


def _acc_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """At least fp32; float64 inputs keep float64."""
    dt = torch.float32
    for t in tensors:
        dt = torch.promote_types(dt, t.dtype)
    return dt


def roi_pool(occ: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """occ (N, ..., P) non-negative, feat (N, ..., D) -> (N, P, D), >= fp32."""
    n, p, d = occ.shape[0], occ.shape[-1], feat.shape[-1]
    acc = _acc_dtype(occ, feat)
    occ2 = occ.reshape(n, -1, p).to(acc)
    feat2 = feat.reshape(n, -1, d).to(acc)
    return torch.einsum("nsp,nsd->npd", occ2, feat2)


def cosine_similarity_to_prototypes(roi: torch.Tensor,
                                    prototypes: torch.Tensor) -> torch.Tensor:
    """(N, P, D) x (P, D) -> (N, P) cosine in [-1, 1]."""
    acc = _acc_dtype(roi, prototypes)
    roi = roi.to(acc)
    prototypes = prototypes.to(acc)
    dot = (roi * prototypes[None]).sum(-1)
    n1 = torch.linalg.vector_norm(roi, dim=-1).clamp_min(_EPS)
    n2 = torch.linalg.vector_norm(prototypes, dim=-1).clamp_min(_EPS)
    return dot / (n1 * n2[None])


def roi_cosine_torch(occ: torch.Tensor, feat: torch.Tensor,
                     prototypes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the head: (roi (N, P, D), sim01 (N, P))."""
    roi = roi_pool(occ, feat)
    sim = (cosine_similarity_to_prototypes(roi, prototypes) + 1.0) / 2.0
    return roi, sim


def roi_cosine_head(occ: torch.Tensor, feat: torch.Tensor,
                    prototypes: torch.Tensor, impl: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full head: (roi_features (N, P, D), similarity01 (N, P)).

    impl=None: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. impl="torch": the plain version on any device (tests and the
    chip smoke compare the kernel with it).
    """
    if impl is None:
        from protoasnet_tpu_torch.ops.roi_cosine_cuda import roi_cosine_cuda

        return roi_cosine_cuda(occ, feat, prototypes)
    if impl == "torch":
        return roi_cosine_torch(occ, feat, prototypes)
    raise ValueError(f"unknown head impl {impl!r}; use None or 'torch'")
