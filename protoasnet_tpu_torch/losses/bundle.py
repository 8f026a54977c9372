"""Config-driven loss bundle for the train and eval steps.

Wires the criterion section of a config into the 7-term XProtoNet
objective (or the 4-term ProtoPNet one), as the JAX package's
``losses/bundle.py`` does. A term whose weight is 0 is not computed: it is
reported as 0, so a disabled TransformLoss never pays its second trunk
forward.

Under data parallelism (``parallel/mesh.py``, more than one rank on the
``data`` axis) each rank's terms are its share of the global batch's: the
masked means divide by the global valid count (one all-reduce over the
``data`` group a call), the unmasked means over the rank's rows and the
batch-free terms (orthogonality, L1 on the readout) by the number of data
ranks, and the sums stay local, so that the ranks' shares add up to the
single-process terms of the global batch, and so do their gradients
(``sync_grads`` sums them). ``global_terms`` gives the sums that are
reported.

Under prototype tensor parallelism (``shard``, the model's
``PrototypeShard``) every model rank computes the whole objective alike:
the similarities and distances come in whole (the models gather them);
the orthogonality and L1 terms read the prototypes and the readout
gathered over ``model`` (differentiable: each rank's gradient is its
block's); the occurrence terms are summed over the rank's own maps and
added up over ``model``, the TransformLoss's mean over the global P. The
(N, S, P) occurrence maps are never gathered.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from protoasnet_tpu_torch.losses import losses as L
from protoasnet_tpu_torch.parallel.mesh import (PrototypeShard,
                                                all_reduce_sum, data_group,
                                                data_size, gather_from_model,
                                                reduce_from_model)

__all__ = ["LossBundle", "global_terms"]


def _shares(valid: Optional[torch.Tensor], like: torch.Tensor):
    """(valid, global valid count or None, number of data ranks) of a
    call."""
    w = data_size()
    if w == 1:
        return valid, None, 1
    if valid is None:
        valid = torch.ones(like.shape[0], dtype=torch.bool,
                           device=like.device)
    count = all_reduce_sum(valid.sum().to(torch.float32),
                           data_group()).clamp_min(1)
    return valid, count, w


def global_terms(total: torch.Tensor, terms: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The data ranks' shares summed (one all-reduce over the ``data``
    group; detached): the global batch's total and terms. The shares
    themselves with one data rank."""
    if data_size() == 1:
        return total.detach(), {k: v.detach() for k, v in terms.items()}
    names = list(terms)
    summed = all_reduce_sum(torch.stack(
        [total.detach()] + [terms[k].detach().to(total.dtype)
                            for k in names]), data_group())
    return summed[0], dict(zip(names, summed[1:]))


class LossBundle:
    """Stateless; holds only the config's weights and options."""

    def __init__(self, criterion_cfg: Dict[str, Any], num_classes: int,
                 abstain_class: bool):
        self.cfg = criterion_cfg
        self.num_classes = num_classes
        self.abstain_class = abstain_class

    def _w(self, name: str, key: str = "loss_weight") -> float:
        return float(self.cfg.get(name, {}).get(key, 0.0))

    def _red(self, name: str, default: str = "mean") -> str:
        return self.cfg.get(name, {}).get("reduction", default)

    @property
    def transform_enabled(self) -> bool:
        """True when the TransformLoss term has a nonzero weight: the train
        step then runs the second forward, occ(affine(x))."""
        return self._w("trans_occurrence") != 0.0

    def _ce(self, logits, target, valid, count, zero) -> torch.Tensor:
        if self.abstain_class:
            c = self.cfg.get("CeLossAbstain", {})
            w = float(c.get("loss_weight", 1.0))
            return w * L.ce_loss_abstain(
                logits, target, ab_weight=float(c.get("ab_weight", 0.3)),
                ab_logitpath=c.get("ab_logitpath", "joined"),
                reduction=c.get("reduction", "mean"), valid=valid,
                count=count) if w else zero
        c = self.cfg.get("CeLoss", {})
        w = float(c.get("loss_weight", 1.0))
        return w * L.ce_loss(logits, target,
                             reduction=c.get("reduction", "mean"),
                             valid=valid, count=count) if w else zero

    def _fc(self, fc_kernel, class_identity, ranks, zero,
            shard) -> torch.Tensor:
        w = self._w("Lnorm_FC")
        c = self.cfg.get("Lnorm_FC", {})
        return w * L.l_norm_fc(gather_from_model(fc_kernel, 0, shard),
                               class_identity,
                               p=int(c.get("p", 1)),
                               reduction=c.get("reduction", "sum")) \
            / ranks if w else zero

    def xprotonet_terms(
        self, logits: torch.Tensor, similarities: torch.Tensor,
        occurrence_map: torch.Tensor, target: torch.Tensor,
        prototype_vectors: torch.Tensor, fc_kernel: torch.Tensor,
        class_identity: torch.Tensor, x: Optional[torch.Tensor] = None,
        occ_fn: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
        valid: Optional[torch.Tensor] = None,
        occ_transformed: Optional[torch.Tensor] = None,
        affine_params: Optional[Tuple[Any, Any]] = None,
        shard: Optional[PrototypeShard] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The 7-term ProtoASNet objective: (total, {log name: term}).

        TransformLoss takes either ``occ_transformed`` = occ(affine(x))
        with its ``affine_params``, or ``x`` and ``occ_fn`` (then the draw
        is ``affine_params`` if given, else from ``generator``). Under
        prototype tensor parallelism (``shard``) ``prototype_vectors``,
        ``fc_kernel`` and the occurrence maps are the rank's blocks; the
        similarities and ``class_identity`` are whole."""
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        valid, count, ranks = _shares(valid, logits)
        raw: Dict[str, torch.Tensor] = {}
        raw["loss_CE"] = self._ce(logits, target, valid, count, zero)

        w = self._w("ClusterRoiFeat")
        raw["loss_Clst"] = w * L.cluster_roi(
            similarities, target, self.num_classes,
            self._red("ClusterRoiFeat"), valid=valid, count=count) if w \
            else zero

        w = self._w("SeparationRoiFeat")
        raw["loss_Sep"] = w * L.separation_roi(
            similarities, target, self.num_classes,
            self._red("SeparationRoiFeat"), abstain_class=self.abstain_class,
            valid=valid, count=count) if w else zero

        w = self._w("OrthogonalityLoss")
        raw["loss_Ortho"] = w * L.orthogonality_loss(
            gather_from_model(prototype_vectors, 0, shard), self.num_classes,
            mode=self.cfg.get("OrthogonalityLoss", {}).get(
                "mode", "per_class")) / ranks if w else zero

        # a mean over the rank's rows (valid or not, as in the JAX package)
        # is its share times the number of ranks: the blocks are equal
        w = self._w("Lnorm_occurrence")
        red = self._red("Lnorm_occurrence")
        raw["loss_RoiNorm"] = w * reduce_from_model(L.l_norm_occurrence(
            occurrence_map,
            p=int(self.cfg.get("Lnorm_occurrence", {}).get("p", 2)),
            reduction=red), shard) / (ranks if red == "mean" else 1) \
            if w else zero

        # each model rank's mean is over its P / n_model maps
        w = self._w("trans_occurrence")
        red = self._red("trans_occurrence")
        per_rank = ranks if red == "mean" else 1
        if red == "mean" and shard is not None:
            per_rank *= shard.size
        if w and occ_transformed is not None and affine_params is not None:
            raw["loss_RoiTrans"] = w * reduce_from_model(
                L.transform_loss_from_pair(
                    occ_transformed, occurrence_map, *affine_params,
                    reduction=red), shard) / per_rank
        elif w and occ_fn is not None and x is not None:
            raw["loss_RoiTrans"] = w * reduce_from_model(L.transform_loss(
                x, occurrence_map, occ_fn, generator, reduction=red,
                affine_params=affine_params), shard) / per_rank
        else:
            raw["loss_RoiTrans"] = zero

        raw["loss_fcL1Norm"] = self._fc(fc_kernel, class_identity, ranks,
                                        zero, shard)
        return sum(raw.values()), raw

    def protopnet_terms(
        self, logits: torch.Tensor, min_distances: torch.Tensor,
        target: torch.Tensor, fc_kernel: torch.Tensor,
        class_identity: torch.Tensor, valid: Optional[torch.Tensor] = None,
        shard: Optional[PrototypeShard] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CE + ClusterPatch + SeparationPatch + L1(FC) (ProtoPNet); under
        ``shard`` the distances come whole and ``fc_kernel`` is the rank's
        block."""
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        valid, count, ranks = _shares(valid, logits)
        c = self.cfg.get("CeLoss", {})
        w = float(c.get("loss_weight", 1.0))
        raw = {"loss_CE": w * L.ce_loss(
            logits, target, reduction=c.get("reduction", "mean"),
            valid=valid, count=count) if w else zero}
        w = self._w("ClusterPatch")
        raw["loss_Clst"] = w * L.cluster_patch(
            min_distances, target, self.num_classes,
            self._red("ClusterPatch"), valid=valid, count=count) if w \
            else zero
        w = self._w("SeparationPatch")
        raw["loss_Sep"] = w * L.separation_patch(
            min_distances, target, self.num_classes,
            self._red("SeparationPatch"), valid=valid, count=count) if w \
            else zero
        raw["loss_fcL1Norm"] = self._fc(fc_kernel, class_identity, ranks,
                                        zero, shard)
        return sum(raw.values()), raw
