"""Config-driven loss bundle for the train and eval steps.

Wires the criterion section of a config into the 7-term XProtoNet
objective (or the 4-term ProtoPNet one), as the JAX package's
``losses/bundle.py`` does. A term whose weight is 0 is not computed: it is
reported as 0, so a disabled TransformLoss never pays its second trunk
forward.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from protoasnet_tpu_torch.losses import losses as L

__all__ = ["LossBundle"]


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

    def _ce(self, logits, target, valid, zero) -> torch.Tensor:
        if self.abstain_class:
            c = self.cfg.get("CeLossAbstain", {})
            w = float(c.get("loss_weight", 1.0))
            return w * L.ce_loss_abstain(
                logits, target, ab_weight=float(c.get("ab_weight", 0.3)),
                ab_logitpath=c.get("ab_logitpath", "joined"),
                reduction=c.get("reduction", "mean"), valid=valid) if w \
                else zero
        c = self.cfg.get("CeLoss", {})
        w = float(c.get("loss_weight", 1.0))
        return w * L.ce_loss(logits, target,
                             reduction=c.get("reduction", "mean"),
                             valid=valid) if w else zero

    def _fc(self, fc_kernel, class_identity, zero) -> torch.Tensor:
        w = self._w("Lnorm_FC")
        c = self.cfg.get("Lnorm_FC", {})
        return w * L.l_norm_fc(fc_kernel, class_identity,
                               p=int(c.get("p", 1)),
                               reduction=c.get("reduction", "sum")) if w \
            else zero

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
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The 7-term ProtoASNet objective: (total, {log name: term}).

        TransformLoss takes either ``occ_transformed`` = occ(affine(x))
        with its ``affine_params``, or ``x`` and ``occ_fn`` (then the draw
        is ``affine_params`` if given, else from ``generator``)."""
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        raw: Dict[str, torch.Tensor] = {}
        raw["loss_CE"] = self._ce(logits, target, valid, zero)

        w = self._w("ClusterRoiFeat")
        raw["loss_Clst"] = w * L.cluster_roi(
            similarities, target, self.num_classes,
            self._red("ClusterRoiFeat"), valid=valid) if w else zero

        w = self._w("SeparationRoiFeat")
        raw["loss_Sep"] = w * L.separation_roi(
            similarities, target, self.num_classes,
            self._red("SeparationRoiFeat"), abstain_class=self.abstain_class,
            valid=valid) if w else zero

        w = self._w("OrthogonalityLoss")
        raw["loss_Ortho"] = w * L.orthogonality_loss(
            prototype_vectors, self.num_classes,
            mode=self.cfg.get("OrthogonalityLoss", {}).get(
                "mode", "per_class")) if w else zero

        w = self._w("Lnorm_occurrence")
        raw["loss_RoiNorm"] = w * L.l_norm_occurrence(
            occurrence_map,
            p=int(self.cfg.get("Lnorm_occurrence", {}).get("p", 2)),
            reduction=self._red("Lnorm_occurrence")) if w else zero

        w = self._w("trans_occurrence")
        red = self._red("trans_occurrence")
        if w and occ_transformed is not None and affine_params is not None:
            raw["loss_RoiTrans"] = w * L.transform_loss_from_pair(
                occ_transformed, occurrence_map, *affine_params,
                reduction=red)
        elif w and occ_fn is not None and x is not None:
            raw["loss_RoiTrans"] = w * L.transform_loss(
                x, occurrence_map, occ_fn, generator, reduction=red,
                affine_params=affine_params)
        else:
            raw["loss_RoiTrans"] = zero

        raw["loss_fcL1Norm"] = self._fc(fc_kernel, class_identity, zero)
        return sum(raw.values()), raw

    def protopnet_terms(
        self, logits: torch.Tensor, min_distances: torch.Tensor,
        target: torch.Tensor, fc_kernel: torch.Tensor,
        class_identity: torch.Tensor, valid: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """CE + ClusterPatch + SeparationPatch + L1(FC) (ProtoPNet)."""
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        c = self.cfg.get("CeLoss", {})
        w = float(c.get("loss_weight", 1.0))
        raw = {"loss_CE": w * L.ce_loss(
            logits, target, reduction=c.get("reduction", "mean"),
            valid=valid) if w else zero}
        w = self._w("ClusterPatch")
        raw["loss_Clst"] = w * L.cluster_patch(
            min_distances, target, self.num_classes,
            self._red("ClusterPatch"), valid=valid) if w else zero
        w = self._w("SeparationPatch")
        raw["loss_Sep"] = w * L.separation_patch(
            min_distances, target, self.num_classes,
            self._red("SeparationPatch"), valid=valid) if w else zero
        raw["loss_fcL1Norm"] = self._fc(fc_kernel, class_identity, zero)
        return sum(raw.values()), raw
