"""Optimiser, parameter groups, gradient accumulation and LR control.

The JAX package's ``train/optim.py`` in torch:

* parameter groups by top-level module: ``cnn_backbone`` (or ``features``)
  -> backbone, ``add_on_layers`` -> add_on, ``occurrence_module`` ->
  occurrence, ``prototype_vectors`` -> prototypes, ``last_layer`` ->
  last_layer;
* torch-Adam semantics, weight decay added to the gradient before the
  moments: that is ``torch.optim.Adam``'s ``weight_decay``, per group;
* learning rates per group, set at run time before each step;
* gradient accumulation that SUMS micro-gradients and steps on every k-th
  micro-step: repeated ``loss.backward()`` into ``.grad`` is that sum;
* stages (warm / joint / last): a frozen group's gradient is zeroed and its
  weight decay is 0 for the step, so it keeps zero Adam moments and its
  values bit for bit. Every parameter takes part in every step (a missing
  gradient counts as zero), so Adam's step count is one for all groups,
  as in optax;
* the staged agents' ``StageOptimizers``: each stage its own ``GroupAdam``
  and ``GradAccumulator``, as the JAX package's per-stage optimiser states
  and accumulators;
* under FSDP2 (``parallel/mesh.py::fsdp_param_shardings``) the parameters,
  gradients and Adam moments are DTensors, sharded over the ranks; the
  ``state_dict``s hold full tensors and ``load_state_dict`` shards them
  again, and an accumulator's partial sums are the global batch's (summed
  across ranks under data parallelism, rank 0's alone on a load), so a
  checkpoint is the same file at any world size. FSDP2 keeps the partial
  sums of micro-steps that do not update to itself (unsharded, off
  ``.grad``): save its accumulator on an update's boundary.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch
from torch import nn

from protoasnet_tpu_torch.parallel.mesh import all_reduce_sum, is_main

__all__ = ["GROUPS", "STAGE_GROUPS", "STAGES", "group_of", "label_params",
           "GroupAdam", "GradAccumulator", "StageOptimizers",
           "ReduceLROnPlateau", "StepLR", "make_lr_scheduler"]

GROUPS = ("backbone", "add_on", "occurrence", "prototypes", "last_layer")

# which groups train in each stage
STAGE_GROUPS = {
    "warm": ("add_on", "occurrence", "prototypes"),
    "joint": ("backbone", "add_on", "occurrence", "prototypes"),
    "last": ("last_layer",),
    "all": GROUPS,
}
STAGES = ("warm", "joint", "last")  # the staged agents' optimisers

_TOP = {"cnn_backbone": "backbone", "features": "backbone",
        "add_on_layers": "add_on", "occurrence_module": "occurrence",
        "prototype_vectors": "prototypes", "last_layer": "last_layer"}


def group_of(name: str) -> str:
    """The group of a parameter from its ``named_parameters`` name (any
    other trunk parameter: backbone)."""
    return _TOP.get(name.split(".")[0], "backbone")


def _full(t: Any) -> Any:
    """A DTensor's full value (one all-gather); anything else as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _global(g: torch.Tensor) -> torch.Tensor:
    """A gradient of the global batch, full: a DTensor's (FSDP2 summed it)
    gathered, a plain one summed across ranks (a new tensor)."""
    g = g.detach()
    return _full(g) if hasattr(g, "full_tensor") else \
        all_reduce_sum(g).clone()


def _like(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A full tensor ``t`` laid out as the parameter ``p``: p's shard of it
    when p is a DTensor (each rank cuts its own; every rank holds t)."""
    if not hasattr(p, "device_mesh") or hasattr(t, "device_mesh"):
        return t
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(p.device), p.device_mesh, p.placements,
                             src_data_rank=None)


def label_params(model: nn.Module) -> Dict[str, List[nn.Parameter]]:
    """{group: parameters} over every group, in ``named_parameters``
    order (a group may be empty)."""
    out: Dict[str, List[nn.Parameter]] = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        out[group_of(name)].append(p)
    return out


class GroupAdam:
    """``torch.optim.Adam`` with one param group per label, its weight
    decay per group, learning rates and the trainable groups given at each
    step."""

    def __init__(self, model: nn.Module,
                 weight_decay_by_group: Optional[Dict[str, float]] = None):
        wd = weight_decay_by_group or {}
        groups = label_params(model)
        self.weight_decay = {g: float(wd.get(g, 0.0)) for g in GROUPS}
        self.params = [p for g in GROUPS for p in groups[g]]
        # FSDP2 keeps small parameters whole beside its DTensors: one
        # foreach kernel cannot take both
        mixed = any(hasattr(p, "device_mesh") for p in self.params)
        self.optimizer = torch.optim.Adam(
            [{"params": groups[g], "label": g, "lr": 0.0,
              "weight_decay": self.weight_decay[g]}
             for g in GROUPS if groups[g]],
            lr=0.0,  # betas (0.9, 0.999), eps 1e-8: optax's scale_by_adam
            foreach=False if mixed else None)

    def step(self, lrs: Dict[str, float], stage: str = "all") -> None:
        """One Adam step on the summed ``.grad`` with the learning rate of
        each group; groups outside ``STAGE_GROUPS[stage]`` get no update."""
        trainable = set(STAGE_GROUPS[stage])
        for group in self.optimizer.param_groups:
            g = group["label"]
            on = g in trainable
            # a frozen group: lr 0 too, so moments left from another stage
            # move nothing (optax masks the update)
            group["lr"] = float(lrs[g]) if on else 0.0
            group["weight_decay"] = self.weight_decay[g] if on else 0.0
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                elif not on:
                    p.grad.zero_()
        self.optimizer.step()

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> Dict[str, Any]:
        """``torch.optim.Adam``'s, with full tensors."""
        st = self.optimizer.state_dict()
        st["state"] = {i: {k: _full(v) for k, v in s.items()}
                       for i, s in st["state"].items()}
        return st

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state)
        for p in self.params:
            s = self.optimizer.state.get(p, {})
            for k, v in s.items():
                if isinstance(v, torch.Tensor) and v.dim() > 0:
                    s[k] = _like(v, p)


class GradAccumulator:
    """Sum-style accumulation: the micro-gradients add up in ``.grad``, and
    the optimiser steps on every ``every``-th micro-step."""

    def __init__(self, params: Iterable[nn.Parameter], every: int = 1):
        self.params = list(params)
        self.every = max(int(every), 1)
        self.count = 0

    def will_apply(self) -> bool:
        """Whether the next micro-step is one the optimiser steps on."""
        return (self.count + 1) % self.every == 0

    def micro_step(self) -> bool:
        """Count one micro-step; True when the optimiser should step now
        (then the count restarts)."""
        self.count += 1
        if self.count % self.every == 0:
            self.count = 0
            return True
        return False

    def state_dict(self) -> Dict[str, Any]:
        """The count and the partial sums in flight (None where a parameter
        has no gradient yet), as full tensors of the global batch: under
        data parallelism summed across ranks, so every rank calls it."""
        return {"count": self.count,
                "grads": [None if p.grad is None else _global(p.grad)
                          for p in self.params]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Under data parallelism rank 0 takes the partial sums and the
        other ranks start from none: the update's all-reduce adds them
        once."""
        self.count = int(state["count"])
        for p, g in zip(self.params, state["grads"]):
            p.grad = None if g is None or not is_main() else _like(
                g.to(p.device, p.dtype).clone(), p)


class StageOptimizers:
    """One ``GroupAdam`` and one ``GradAccumulator`` for each of the warm,
    joint and last stages.

    The micro-gradients sum in the parameters' ``.grad``, which only the
    active stage's accumulator owns: ``activate`` parks the outgoing
    stage's partial sums (and count) and puts back the incoming stage's, so
    a stage switch in the middle of an accumulation neither leaks one
    stage's gradients into another's step nor drops them.
    """

    def __init__(self, model: nn.Module,
                 weight_decay_by_group: Dict[str, float], every: int = 1):
        self.optimizers = {s: GroupAdam(model, weight_decay_by_group)
                           for s in STAGES}
        self.params = self.optimizers[STAGES[0]].params
        self.accumulators = {s: GradAccumulator(self.params, every)
                             for s in STAGES}
        self._empty = {"count": 0, "grads": [None] * len(self.params)}
        self.parked = {s: self._empty for s in STAGES}
        self.active: Optional[str] = None

    def activate(self, stage: str) -> None:
        if stage == self.active:
            return
        if self.active is not None:
            self.parked[self.active] = \
                self.accumulators[self.active].state_dict()
        self.accumulators[stage].load_state_dict(self.parked[stage])
        self.parked[stage] = self._empty
        self.active = stage

    def state_dict(self) -> Dict[str, Any]:
        acc = {s: (self.accumulators[s].state_dict() if s == self.active
                   else self.parked[s]) for s in STAGES}
        return {**{f"optimizer_{s}": self.optimizers[s].state_dict()
                   for s in STAGES},
                **{f"accumulator_{s}": acc[s] for s in STAGES}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for s in STAGES:
            self.optimizers[s].load_state_dict(state[f"optimizer_{s}"])
            self.parked[s] = state[f"accumulator_{s}"]
        for p in self.params:
            p.grad = None
        self.active = None


class ReduceLROnPlateau:
    """Host controller with ``torch.optim.lr_scheduler`` semantics (mode,
    factor, patience, threshold, cooldown, min_lr)."""

    def __init__(self, initial_lr: float, mode: str = "max",
                 factor: float = 0.5, patience: int = 5,
                 threshold: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0, **_ignored):
        self.lr = float(initial_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best: Optional[float] = None
        self.num_bad = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold) \
                if self.best >= 0 else \
                metric > self.best * (1.0 - self.threshold)
        return metric < self.best * (1.0 - self.threshold) \
            if self.best >= 0 else metric < self.best * (1.0 + self.threshold)

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.lr = float(state["lr"])
        self.best = state["best"]
        self.num_bad = int(state["num_bad"])
        self.cooldown_counter = int(state["cooldown_counter"])


class StepLR:
    """torch StepLR: the lr decays by gamma every step_size epochs."""

    def __init__(self, initial_lr: float, step_size: int = 10,
                 gamma: float = 0.1, **_ignored):
        self.base = float(initial_lr)
        self.lr = float(initial_lr)
        self.step_size = step_size
        self.gamma = gamma
        self._epochs = 0

    def step(self, metric: float = 0.0) -> float:
        self._epochs += 1
        self.lr = self.base * (self.gamma ** (self._epochs // self.step_size))
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return {"lr": self.lr, "epochs": self._epochs}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.lr = float(state["lr"])
        self._epochs = int(state["epochs"])


def make_lr_scheduler(schedule_cfg: Dict[str, Any], initial_lr: float):
    name = schedule_cfg.get("name", "ReduceLROnPlateau")
    cfg = {k: v for k, v in schedule_cfg.items() if k != "name"}
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(initial_lr, **cfg)
    if name == "StepLR":
        return StepLR(initial_lr, **cfg)
    raise ValueError(f"Unknown lr schedule {name!r}")
