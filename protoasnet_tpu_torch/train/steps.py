"""Train, eval and push steps of XProtoNet / Video-XProtoNet and of the
ProtoPNet baseline.

The JAX package's ``train/steps.py::make_xprotonet_steps`` in torch. One
train step: the forward of x in train mode (BN statistics of the batch,
running stats updated), the TransformLoss forward of affine(x) in train
mode too, with its own batch statistics and its running-stat updates
undone (the BN buffers are restored after it), all loss terms, backward
into the summed ``.grad``, and on every k-th micro-step the masked Adam
update. Gradients flow through both forwards. This is the reference's
separate-pass semantics, the ``combined=False`` path of
``make_xprotonet_loss_fn``.

The eval step uses the running statistics for both forwards; the push step
is ``push_forward`` in eval mode. The affine draw of a step is ``affine``
= (angle, scale) when given, else it comes from ``generator``.

``make_protopnet_steps`` is the JAX package's ``make_protopnet_steps``:
one train-mode forward, CE + ClusterPatch + SeparationPatch + L1(FC), the
same summed accumulation and masked Adam step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from protoasnet_tpu_torch.losses.bundle import LossBundle
from protoasnet_tpu_torch.losses.losses import (affine_batch,
                                                sample_affine_params)
from protoasnet_tpu_torch.models.layers import prototype_class_identity
from protoasnet_tpu_torch.train.optim import GradAccumulator, GroupAdam

__all__ = ["make_xprotonet_steps", "make_protopnet_steps", "own_bn_stats"]


class own_bn_stats:
    """Within the block, each BatchNorm of ``model`` updates copies of its
    running statistics; on exit the originals are put back, untouched. The
    tensors are swapped, not copied into: autograd may hold the originals
    for the backward of an earlier forward."""

    def __init__(self, model: nn.Module):
        self.bns = [m for m in model.modules()
                    if isinstance(m, nn.modules.batchnorm._BatchNorm)]
        self.saved = []

    def __enter__(self):
        self.saved = [(m.running_mean, m.running_var, m.num_batches_tracked)
                      for m in self.bns]
        for m, bufs in zip(self.bns, self.saved):
            (m.running_mean, m.running_var,
             m.num_batches_tracked) = (b.clone() for b in bufs)
        return self

    def __exit__(self, *exc):
        for m, bufs in zip(self.bns, self.saved):
            m.running_mean, m.running_var, m.num_batches_tracked = bufs
        return False


def _wide(t: torch.Tensor) -> torch.Tensor:
    """At least fp32 (the losses' precision); float64 stays float64."""
    return t if t.dtype == torch.float64 else t.float()


def _class_identity(model: nn.Module, device) -> torch.Tensor:
    p, k = model.prototype_vectors.shape[0], model.num_classes
    return torch.from_numpy(prototype_class_identity(p, k)).to(device)


def _apply(optimizer: GroupAdam, accumulator: GradAccumulator,
           lrs: Dict[str, float], stage: str) -> bool:
    """Count one micro-step; on every k-th, the masked Adam step on the
    summed gradients. Returns whether the optimiser stepped."""
    applied = accumulator.micro_step()
    if applied:
        optimizer.step(lrs, stage)
        optimizer.zero_grad()
    return applied


def make_xprotonet_steps(
    model: nn.Module, bundle: LossBundle, optimizer: GroupAdam,
    accumulator: GradAccumulator, stage: str = "all",
) -> Tuple[Callable, Callable, Callable]:
    """(train_step, eval_step, push_step) over ``model``.

    train_step(cine, target, valid, lrs, affine=None, generator=None) ->
        metrics: loss_all and the terms (0-d tensors), logits,
        similarities, applied (whether the optimiser stepped)
    eval_step(cine, target, valid, affine=None, generator=None) -> metrics
    push_step(cine) -> (roi, 1 - sim01, occurrence, logits)

    ``lrs`` is a {group: learning rate} dict; target (N,) int and valid
    (N,) bool tensors on the model's device.
    """
    dev = model.prototype_vectors.device
    class_identity = _class_identity(model, dev)

    def _draw(affine, generator):
        if not bundle.transform_enabled:
            return None
        return affine if affine is not None else \
            sample_affine_params(generator)

    def _terms(logits, sim, occ, target, valid, occ_t, aff):
        return bundle.xprotonet_terms(
            _wide(logits), sim, _wide(occ), target,
            prototype_vectors=model.prototype_vectors,
            fc_kernel=model.last_layer.Dense_0.weight.T,
            class_identity=class_identity, valid=valid,
            occ_transformed=None if occ_t is None else _wide(occ_t),
            affine_params=aff)

    def train_step(cine, target, valid, lrs: Dict[str, float],
                   affine=None, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        model.train()
        aff = _draw(affine, generator)
        logits, sim, occ = model(cine)
        occ_t = None
        if aff is not None:
            # affine(x) in train mode: its own batch statistics; the running
            # stats keep only the main forward's update
            with own_bn_stats(model):
                occ_t = model.compute_occurrence_map(
                    affine_batch(cine, *aff))
        total, terms = _terms(logits, sim, occ, target, valid, occ_t, aff)
        total.backward()
        applied = _apply(optimizer, accumulator, lrs, stage)
        return {"loss_all": total.detach(),
                **{k: v.detach() for k, v in terms.items()},
                "logits": logits.detach(), "similarities": sim.detach(),
                "applied": applied}

    @torch.no_grad()
    def eval_step(cine, target, valid, affine=None,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, Any]:
        model.eval()
        aff = _draw(affine, generator)
        logits, sim, occ = model(cine)
        occ_t = None if aff is None else model.compute_occurrence_map(
            affine_batch(cine, *aff))
        total, terms = _terms(logits, sim, occ, target, valid, occ_t, aff)
        return {"loss_all": total, **terms, "logits": logits,
                "similarities": sim}

    @torch.no_grad()
    def push_step(cine):
        model.eval()
        return model.push_forward(cine)

    return train_step, eval_step, push_step


def make_protopnet_steps(
    model: nn.Module, bundle: LossBundle, optimizer: GroupAdam,
    accumulator: GradAccumulator, stage: str = "all",
) -> Tuple[Callable, Callable, Callable]:
    """(train_step, eval_step, push_step) over a ``PPNet``.

    train_step(cine, target, valid, lrs) -> metrics: loss_all and the
        terms (0-d tensors), logits, min_distances, applied
    eval_step(cine, target, valid) -> metrics
    push_step(cine) -> (conv_features, distances)

    """
    class_identity = _class_identity(model, model.prototype_vectors.device)

    def _terms(logits, min_d, target, valid):
        return bundle.protopnet_terms(
            _wide(logits), min_d, target,
            fc_kernel=model.last_layer.Dense_0.weight.T,
            class_identity=class_identity, valid=valid)

    def train_step(cine, target, valid, lrs: Dict[str, float]
                   ) -> Dict[str, Any]:
        model.train()
        logits, min_d = model(cine)
        total, terms = _terms(logits, min_d, target, valid)
        total.backward()
        applied = _apply(optimizer, accumulator, lrs, stage)
        return {"loss_all": total.detach(),
                **{k: v.detach() for k, v in terms.items()},
                "logits": logits.detach(), "min_distances": min_d.detach(),
                "applied": applied}

    @torch.no_grad()
    def eval_step(cine, target, valid) -> Dict[str, Any]:
        model.eval()
        logits, min_d = model(cine)
        total, terms = _terms(logits, min_d, target, valid)
        return {"loss_all": total, **terms, "logits": logits,
                "min_distances": min_d}

    @torch.no_grad()
    def push_step(cine):
        model.eval()
        return model.push_forward(cine)

    return train_step, eval_step, push_step
