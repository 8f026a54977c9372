"""Occurrence-weighted ROI pooling + prototype cosine similarity.

ProtoASNet's prototype head:

    roi[n, p, :] = sum_{t,h,w} occ[n, t, h, w, p] * feat[n, t, h, w, :]
    sim[n, p]    = (cos(roi[n, p, :], proto[p, :]) + 1) / 2

with torch.nn.CosineSimilarity's eps=1e-8 clamp on each norm. The functions
here are the plain PyTorch version; ``roi_cosine_head`` sends CUDA tensors
to the hand-written kernel (``ops/roi_cosine_cuda.py``).
``roi_cosine_backward`` is the head's gradient in closed form, the formula
of the JAX package's custom VJP (``pallas_roi.py::_bwd``); the kernel's
``torch.autograd.Function`` calls it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["roi_pool", "cosine_similarity_to_prototypes", "roi_cosine_torch",
           "roi_cosine_backward", "roi_cosine_head"]

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
    s = math.prod(occ.shape[1:-1])  # positions (explicit: N may be 0)
    acc = _acc_dtype(occ, feat)
    occ2 = occ.reshape(n, s, p).to(acc)
    feat2 = feat.reshape(n, s, d).to(acc)
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


def roi_cosine_backward(occ2: torch.Tensor, feat2: torch.Tensor,
                        protos: torch.Tensor, roi: torch.Tensor,
                        g_roi: Optional[torch.Tensor],
                        g_sim: Optional[torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The head's cotangents (g_occ (N,S,P), g_feat (N,S,D), g_protos
    (P,D)) from the forward's residuals occ2 (N,S,P), feat2 (N,S,D),
    protos (P,D), roi (N,P,D) and the output cotangents g_roi (N,P,D), g_sim
    (N,P) (None: zero), as ``pallas_roi.py::_bwd`` computes them:

        g_roi_total = g_roi + d cos/d roi * g_sim / 2   (both norms clamped)
        g_feat = occ @ g_roi_total,  g_occ = feat @ g_roi_total^T   (fp32)
        g_protos = sum over the batch of d cos/d proto * g_sim / 2

    Each cotangent comes back in its primal's dtype (bf16 occ and feat in
    the bf16 flagship, fp32 prototypes)."""
    acc = _acc_dtype(occ2, feat2, protos, roi)
    roi_a = roi.to(acc)
    p_a = protos.to(acc)
    rnorm = torch.linalg.vector_norm(roi_a, dim=-1, keepdim=True
                                     ).clamp_min(_EPS)  # (N, P, 1)
    pnorm = torch.linalg.vector_norm(p_a, dim=-1, keepdim=True
                                     ).clamp_min(_EPS)[None]  # (1, P, 1)
    cos = (roi_a * p_a[None]).sum(-1, keepdim=True) / (rnorm * pnorm)
    g_roi_total = (torch.zeros_like(roi_a) if g_roi is None
                   else g_roi.to(acc))
    if g_sim is not None:
        g_cos = (0.5 * g_sim.to(acc))[..., None]  # sim01 = (cos + 1) / 2
        # d cos/d roi = p/(|r||p|) - cos * r/|r|^2
        g_roi_total = g_roi_total + g_cos * (
            p_a[None] / (rnorm * pnorm) - cos * roi_a / rnorm ** 2)
        # d cos/d p = r/(|r||p|) - cos * p/|p|^2, summed over the batch
        g_protos = (g_cos * (roi_a / (rnorm * pnorm)
                             - cos * p_a[None] / pnorm ** 2)).sum(0)
    else:
        g_protos = torch.zeros_like(p_a)
    g_feat = torch.bmm(occ2.to(acc), g_roi_total)  # (N, S, D)
    g_occ = torch.bmm(feat2.to(acc), g_roi_total.transpose(1, 2))  # (N,S,P)
    return (g_occ.to(occ2.dtype), g_feat.to(feat2.dtype),
            g_protos.to(protos.dtype))


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
