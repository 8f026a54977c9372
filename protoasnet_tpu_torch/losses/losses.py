"""The loss library of ProtoASNet and ProtoPNet, in torch.

The JAX package's ``losses/losses.py`` term by term:

  mse_loss, ce_loss, ce_loss_abstain     classification
  cluster_patch, separation_patch        ProtoPNet (min L2 distances)
  cluster_roi, separation_roi            XProtoNet (cosine similarities;
                                         the abstain prototypes exempt)
  orthogonality_loss, l_norm,
  l_norm_occurrence, l_norm_fc           regularisers
  affine_batch, transform_loss_from_pair,
  transform_loss                         TransformLoss (equivariance)

Layout: similarities are (N, P) with P grouped per class in order;
occurrence maps are channels-last (N, [T,] H, W, P). The readout kernel is
given as (P, K), the JAX layout (the port's ``Linear.weight`` transposed).
``valid`` masks padding rows; ``count``, where given, replaces their
count as the denominator of a masked mean (under data parallelism, the
global batch's count: ``losses/bundle.py``). The affine draw comes from an explicit
``torch.Generator``; the JAX and torch RNGs give different numbers, so
callers that compare with the JAX package pass the draw in.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from protoasnet_tpu_torch.ops.affine_fast import rotate_scale_video

__all__ = ["mse_loss", "ce_loss", "cluster_patch", "separation_patch",
           "cluster_roi", "separation_roi", "orthogonality_loss", "l_norm",
           "l_norm_occurrence", "l_norm_fc", "sample_affine_params",
           "affine_batch", "transform_loss", "transform_loss_from_pair",
           "ce_loss_abstain"]

_EPS = 1e-8


def _count(valid: torch.Tensor, count: Optional[torch.Tensor]
           ) -> torch.Tensor:
    """A masked mean's denominator: ``count``, else the valid rows'."""
    return valid.sum().clamp_min(1) if count is None else count


def _reduce_rows(per_row: torch.Tensor, reduction: str,
                 valid: Optional[torch.Tensor] = None,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """On (N, K): 'mean' -> mean over the batch then sum over classes;
    'sum' -> sum of all. ``valid`` masks rows (mean divides by their
    count, or by ``count``)."""
    if reduction not in ("mean", "sum"):
        raise ValueError(f"Unknown reduction {reduction!r}")
    if valid is not None:
        per_row = per_row * valid[:, None].to(per_row.dtype)
        if reduction == "mean":
            return per_row.sum(0).sum() / _count(valid, count)
        return per_row.sum()
    if reduction == "mean":
        return per_row.mean(0).sum()
    return per_row.sum()


def mse_loss(pred, target, reduction: str = "mean"):
    se = (pred - target) ** 2
    return se.mean() if reduction == "mean" else se.sum()


def ce_loss(logits, target, reduction: str = "mean",
            valid: Optional[torch.Tensor] = None,
            count: Optional[torch.Tensor] = None):
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, target.long()[:, None])[:, 0]
    if valid is not None:
        nll = nll * valid.to(nll.dtype)
        if reduction == "mean":
            return nll.sum() / _count(valid, count)
        return nll.sum()
    return nll.mean() if reduction == "mean" else nll.sum()


def _grouped(per_proto: torch.Tensor, num_classes: int) -> torch.Tensor:
    n, p = per_proto.shape
    return per_proto.reshape(n, num_classes, p // num_classes)


def _one_hot(target: torch.Tensor, num_classes: int, like: torch.Tensor
             ) -> torch.Tensor:
    return F.one_hot(target.long(), num_classes).to(like.dtype)


def cluster_patch(min_distances, target, num_classes: int,
                  reduction: str = "mean",
                  valid: Optional[torch.Tensor] = None,
                  count: Optional[torch.Tensor] = None):
    """Pull down the min own-class patch distance."""
    one_hot = _one_hot(target, num_classes, min_distances)
    class_min = _grouped(min_distances, num_classes).amin(2)
    return _reduce_rows(class_min * one_hot, reduction, valid, count)


def separation_patch(min_distances, target, num_classes: int,
                     reduction: str = "mean",
                     valid: Optional[torch.Tensor] = None,
                     count: Optional[torch.Tensor] = None):
    """Push up the min other-class patch distance (the leading minus)."""
    one_hot = _one_hot(target, num_classes, min_distances)
    class_min = _grouped(min_distances, num_classes).amin(2)
    return -_reduce_rows(class_min * (1.0 - one_hot), reduction, valid,
                         count)


def cluster_roi(similarities, target, num_classes: int,
                reduction: str = "mean",
                valid: Optional[torch.Tensor] = None,
                count: Optional[torch.Tensor] = None):
    """-max own-class cosine similarity."""
    one_hot = _one_hot(target, num_classes, similarities)
    class_max = _grouped(similarities, num_classes).amax(2)
    return _reduce_rows(-class_max * one_hot, reduction, valid, count)


def separation_roi(similarities, target, num_classes: int,
                   reduction: str = "mean", abstain_class: bool = False,
                   valid: Optional[torch.Tensor] = None,
                   count: Optional[torch.Tensor] = None):
    """+max other-class similarity; the abstain prototypes are exempt (the
    last class's one-hot is forced to 1)."""
    one_hot = _one_hot(target, num_classes, similarities)
    if abstain_class:
        one_hot = one_hot.clone()
        one_hot[:, -1] = 1.0
    class_max = _grouped(similarities, num_classes).amax(2)
    return _reduce_rows(class_max * (1.0 - one_hot), reduction, valid,
                        count)


def orthogonality_loss(prototype_vectors, num_classes: int,
                       mode: str = "per_class"):
    """Sum of the strictly-upper-triangle pairwise cosines between
    prototype vectors, per class group or across all."""
    pv = prototype_vectors.reshape(prototype_vectors.shape[0], -1)
    unit = pv / torch.linalg.vector_norm(pv, dim=-1,
                                         keepdim=True).clamp_min(_EPS)
    if mode == "per_class":
        p, d = unit.shape
        grouped = unit.reshape(num_classes, p // num_classes, d)
        sim = torch.einsum("kmd,knd->kmn", grouped, grouped)
        m = sim.shape[-1]
        triu = torch.triu(torch.ones((m, m), dtype=sim.dtype,
                                     device=sim.device), diagonal=1)
        return (sim * triu[None]).sum()
    if mode == "all":
        sim = unit @ unit.T
        m = sim.shape[-1]
        triu = torch.triu(torch.ones((m, m), dtype=sim.dtype,
                                     device=sim.device), diagonal=1)
        return (sim * triu).sum()
    raise ValueError(f"Unknown orthogonality mode {mode!r}")


def l_norm(tensor, p: int = 1, axis=None, mask=None,
           reduction: str = "sum"):
    """Lp norm over ``axis`` (None = all), an optional elementwise mask,
    then mean-over-batch-sum ('mean') or sum."""
    t = tensor if mask is None else tensor * mask
    dims = tuple(range(t.dim())) if axis is None else axis
    if p == 1:
        norms = t.abs().sum(dim=dims)
    elif p == 2:
        norms = torch.sqrt((t * t).sum(dim=dims))
    else:
        norms = (t.abs() ** p).sum(dim=dims) ** (1.0 / p)
    norms = torch.atleast_1d(norms)
    if reduction == "mean":
        return norms.mean(0).sum()
    return norms.sum()


def l_norm_occurrence(occ, p: int = 2, reduction: str = "mean"):
    """Occurrence-map norm over its spatial/temporal axes -> (N, P), then
    the reduction."""
    return l_norm(occ, p=p, axis=tuple(range(1, occ.dim() - 1)),
                  reduction=reduction)


def l_norm_fc(kernel, class_identity, p: int = 1, reduction: str = "sum"):
    """L1 on the (P, K) readout kernel masked to incorrect-class entries."""
    return l_norm(kernel, p=p, axis=None, mask=1.0 - class_identity,
                  reduction=reduction)


def sample_affine_params(generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (angle_deg, scale) draw: U(-20, 20) degrees, U(0.6, 1.5), from
    ``generator`` (a CPU generator; one draw per batch)."""
    u = torch.rand(2, generator=generator, dtype=torch.float32)
    return u[0] * 40.0 - 20.0, u[1] * 0.9 + 0.6


def affine_batch(batch: torch.Tensor, angle, scale) -> torch.Tensor:
    """Rotate and scale every (N, [T,] H, W, C) sample by the same (angle,
    scale)."""
    if batch.dim() == 5:
        n, t = batch.shape[:2]
        out = rotate_scale_video(batch.reshape(n * t, *batch.shape[2:]),
                                 angle, scale)
        return out.reshape(n, t, *out.shape[1:])
    return rotate_scale_video(batch, angle, scale)  # images: N acts as T


def transform_loss_from_pair(occ_of_transformed: torch.Tensor,
                             occurrence_map: torch.Tensor, angle, scale,
                             reduction: str = "mean"):
    """L1( occ(affine(x)), affine(occ(x)) ) given occ(affine(x))."""
    transformed_occ = affine_batch(occurrence_map, angle, scale)
    loss = (occ_of_transformed - transformed_occ).abs().sum()
    if reduction == "mean":
        loss = loss / (occurrence_map.shape[0] * occurrence_map.shape[-1])
    return loss


def transform_loss(x: torch.Tensor, occurrence_map: torch.Tensor,
                   occ_fn: Callable[[torch.Tensor], torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   reduction: str = "mean", affine_params=None):
    """Equivariance regulariser: L1( occ(affine(x)), affine(occ(x)) ), with
    ``occ_fn`` the second forward through the trunk and the occurrence
    module. ``affine_params`` = (angle, scale) replaces the draw."""
    angle, scale = (affine_params if affine_params is not None
                    else sample_affine_params(generator))
    occ_t = occ_fn(affine_batch(x, angle, scale))
    return transform_loss_from_pair(occ_t, occurrence_map, angle, scale,
                                    reduction)


def ce_loss_abstain(logits, target, ab_weight: float = 0.3,
                    ab_logitpath: str = "joined", reduction: str = "mean",
                    valid: Optional[torch.Tensor] = None,
                    count: Optional[torch.Tensor] = None):
    """Abstention loss: virtual_pred = (1-a) * softmax(class logits) +
    a * onehot(target), with a = softmax (joined) or sigmoid (separate) of
    the K+1-th logit; NLL of virtual_pred plus ab_weight * -log(1 - a)."""
    k = logits.shape[-1] - 1
    if k < 2:
        raise ValueError("ce_loss_abstain needs >= 2 classes excluding "
                         "abstention")
    if ab_logitpath == "joined":
        abs_pred = torch.softmax(logits, dim=-1)[:, k]
    elif ab_logitpath == "separate":
        abs_pred = torch.sigmoid(logits[:, k])
    else:
        raise ValueError(f"Unknown ab_logitpath {ab_logitpath!r}")
    class_pred = torch.softmax(logits[:, :k], dim=-1)
    one_hot = _one_hot(target, k, logits)
    virtual = (1.0 - abs_pred[:, None]) * class_pred \
        + abs_pred[:, None] * one_hot
    picked = virtual.gather(-1, target.long()[:, None])[:, 0]
    per_sample_pred = -torch.log(picked.clamp_min(_EPS))
    per_sample_abs = -torch.log((1.0 - abs_pred).clamp_min(_EPS))
    if valid is not None:
        v = valid.to(logits.dtype)
        per_sample_pred = per_sample_pred * v
        per_sample_abs = per_sample_abs * v
        if reduction == "mean":
            denom = _count(valid, count)
            return per_sample_pred.sum() / denom \
                + ab_weight * per_sample_abs.sum() / denom
        return per_sample_pred.sum() + ab_weight * per_sample_abs.sum()
    if reduction == "mean":
        return per_sample_pred.mean() + ab_weight * per_sample_abs.mean()
    return per_sample_pred.sum() + ab_weight * per_sample_abs.sum()
