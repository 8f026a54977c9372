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
  as in optax.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch
from torch import nn

__all__ = ["GROUPS", "STAGE_GROUPS", "group_of", "label_params",
           "GroupAdam", "GradAccumulator", "ReduceLROnPlateau", "StepLR",
           "make_lr_scheduler"]

GROUPS = ("backbone", "add_on", "occurrence", "prototypes", "last_layer")

# which groups train in each stage
STAGE_GROUPS = {
    "warm": ("add_on", "occurrence", "prototypes"),
    "joint": ("backbone", "add_on", "occurrence", "prototypes"),
    "last": ("last_layer",),
    "all": GROUPS,
}

_TOP = {"cnn_backbone": "backbone", "features": "backbone",
        "add_on_layers": "add_on", "occurrence_module": "occurrence",
        "prototype_vectors": "prototypes", "last_layer": "last_layer"}


def group_of(name: str) -> str:
    """The group of a parameter from its ``named_parameters`` name (any
    other trunk parameter: backbone)."""
    return _TOP.get(name.split(".")[0], "backbone")


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
        self.optimizer = torch.optim.Adam(
            [{"params": groups[g], "label": g, "lr": 0.0,
              "weight_decay": self.weight_decay[g]}
             for g in GROUPS if groups[g]],
            lr=0.0)  # betas (0.9, 0.999), eps 1e-8: optax's scale_by_adam

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
        return self.optimizer.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state)


class GradAccumulator:
    """Sum-style accumulation: the micro-gradients add up in ``.grad``, and
    the optimiser steps on every ``every``-th micro-step."""

    def __init__(self, params: Iterable[nn.Parameter], every: int = 1):
        self.params = list(params)
        self.every = max(int(every), 1)
        self.count = 0

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
        has no gradient yet)."""
        return {"count": self.count,
                "grads": [None if p.grad is None else p.grad.detach().clone()
                          for p in self.params]}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for p, g in zip(self.params, state["grads"]):
            p.grad = None if g is None else g.to(p.device, p.dtype).clone()


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
