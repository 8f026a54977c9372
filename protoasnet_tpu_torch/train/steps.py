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

Under data parallelism (``parallel/mesh.py``) each rank steps on its rows
of the global batch: its loss is its share of the global loss
(``losses/bundle.py``), the gradients are summed across ranks only on the
micro-step that applies the update (``sync_grads``; under FSDP2 the
reduce-scatter is switched off on the others), and the reported loss
terms are the global batch's (``global_terms``). The logits and
similarities returned are the rank's rows. The affine draw is one (angle,
scale) per step from a generator every rank seeds alike.

Under prototype tensor parallelism (the model's ``prototype_shard``) the
steps are the same: the split head and the bundle make every model rank's
loss the whole objective, the replicated parameters' gradients come out
whole over ``model`` from the backward, and ``sync_grads`` sums every
gradient, a prototype shard's too, over the ``data`` group only.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from protoasnet_tpu_torch.losses.bundle import LossBundle, global_terms
from protoasnet_tpu_torch.losses.losses import (affine_batch,
                                                sample_affine_params)
from protoasnet_tpu_torch.models.layers import prototype_class_identity
from protoasnet_tpu_torch.models.norm import own_bn_stats
from protoasnet_tpu_torch.parallel.mesh import sync_grads
from protoasnet_tpu_torch.train.optim import GradAccumulator, GroupAdam
from protoasnet_tpu_torch.utils.profiling import counting_syncs, span

__all__ = ["make_xprotonet_steps", "make_protopnet_steps"]


def _wide(t: torch.Tensor) -> torch.Tensor:
    """At least fp32 (the losses' precision); float64 stays float64."""
    return t if t.dtype == torch.float64 else t.float()


def _class_identity(model: nn.Module, device) -> torch.Tensor:
    """The whole (P, K) class identity (over every model rank's
    prototypes)."""
    shard = getattr(model, "prototype_shard", None)
    p = model.prototype_vectors.shape[0] if shard is None else shard.total
    return torch.from_numpy(prototype_class_identity(
        p, model.num_classes)).to(device)


def _backward(model: nn.Module, total: torch.Tensor,
              accumulator: GradAccumulator) -> None:
    """``total.backward()``; an FSDP2 model reduce-scatters its gradients
    only on the micro-step that applies the update."""
    if hasattr(model, "set_requires_gradient_sync"):
        model.set_requires_gradient_sync(accumulator.will_apply())
    total.backward()


def _apply(optimizer: GroupAdam, accumulator: GradAccumulator,
           lrs: Dict[str, float], stage: str) -> bool:
    """Count one micro-step; on every k-th, the gradients summed across
    ranks and the masked Adam step on them. Returns whether the optimiser
    stepped."""
    applied = accumulator.micro_step()
    if applied:
        sync_grads(optimizer.params)
        optimizer.step(lrs, stage)
        optimizer.zero_grad()
    return applied


def _reported(total, terms, **outputs) -> Dict[str, Any]:
    """The global batch's loss and terms beside the rank's outputs."""
    total, terms = global_terms(total, terms)
    return {"loss_all": total, **terms,
            **{k: v.detach() for k, v in outputs.items()}}


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
            affine_params=aff, shard=model.prototype_shard)

    micro_steps = itertools.count()

    def train_step(cine, target, valid, lrs: Dict[str, float],
                   affine=None, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        # traced (a profiler open): one span a micro-step, counting its
        # host synchronisations on the card (utils/profiling.py)
        with span("train.step", step=next(micro_steps)), \
                counting_syncs(dev):
            model.train()
            aff = _draw(affine, generator)
            logits, sim, occ = model(cine)
            occ_t = None
            if aff is not None:
                # affine(x) in train mode: its own batch statistics; the
                # running stats keep only the main forward's update
                with own_bn_stats(model):
                    occ_t = model.compute_occurrence_map(
                        affine_batch(cine, *aff))
            total, terms = _terms(logits, sim, occ, target, valid, occ_t,
                                  aff)
            _backward(model, total, accumulator)
            applied = _apply(optimizer, accumulator, lrs, stage)
            return {**_reported(total, terms, logits=logits,
                                similarities=sim), "applied": applied}

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
        return _reported(total, terms, logits=logits, similarities=sim)

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
            class_identity=class_identity, valid=valid,
            shard=model.prototype_shard)

    def train_step(cine, target, valid, lrs: Dict[str, float]
                   ) -> Dict[str, Any]:
        model.train()
        logits, min_d = model(cine)
        total, terms = _terms(logits, min_d, target, valid)
        _backward(model, total, accumulator)
        applied = _apply(optimizer, accumulator, lrs, stage)
        return {**_reported(total, terms, logits=logits,
                            min_distances=min_d), "applied": applied}

    @torch.no_grad()
    def eval_step(cine, target, valid) -> Dict[str, Any]:
        model.eval()
        logits, min_d = model(cine)
        total, terms = _terms(logits, min_d, target, valid)
        return _reported(total, terms, logits=logits, min_distances=min_d)

    @torch.no_grad()
    def push_step(cine):
        model.eval()
        return model.push_forward(cine)

    return train_step, eval_step, push_step
