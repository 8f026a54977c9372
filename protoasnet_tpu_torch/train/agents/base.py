"""Base agent: model, loaders, tracker, checkpoints and the epoch loop's
logging (the JAX package's ``train/agents/base.py`` in torch).

The agent runs on ``config["device"]`` (CUDA unless "cpu" is asked for;
without a card and without that request it raises). Its checkpoint is the
port's own: a ``torch.save`` of {epoch, iteration, model, best_metric} and
the optimiser state, {optimizer, accumulator, scheduler} for the
end-to-end agents (``EndToEndTraining``), each stage's optimizer_<stage>
and accumulator_<stage> and each scheduler_<stage> for the staged ones
(``StagedTraining``); ``last.ckpt`` after every epoch, ``model_best.ckpt``
on the best mean F1, threshold-gated named ones.

``load_checkpoint_file`` also takes the JAX package's runs: its flax
msgpack ``.ckpt`` (weights, BN statistics, each optimiser's Adam state and
accumulator, the schedulers' lr scales; ``set_state_from_jax``) and a
reference checkpoint migrated by it to a ``.pkl`` (weights and BN
statistics; the optimiser starts fresh, as in the JAX package).

Data parallelism (``parallel/mesh.py``): under PyTorch's launcher the
agent joins the process group, trains on ``cuda:LOCAL_RANK`` with the
model broadcast from rank 0, rounds every batch up to a multiple of the
number of ranks, and only rank 0 writes the checkpoints, the config dump
and the tracker's rows; every rank reads the same checkpoint.
"""

from __future__ import annotations

import glob
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from protoasnet_tpu_torch.data.dataset import get_as_dataloader
from protoasnet_tpu_torch.data.manifest import CLASS_LABELS
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import (accumulator_state_from_jax,
                                                  adam_state_from_jax,
                                                  state_dict_from_jax)
from protoasnet_tpu_torch.models.pretrained import load_pretrained_backbone
from protoasnet_tpu_torch.parallel.mesh import (barrier, data_size, is_main,
                                                local_device,
                                                maybe_initialize_distributed,
                                                replicate, world_size)
from protoasnet_tpu_torch.tracking.trackers import make_tracker
from protoasnet_tpu_torch.train.metrics import EpochMetrics
from protoasnet_tpu_torch.train.optim import GROUPS, STAGES, StageOptimizers
from protoasnet_tpu_torch.utils.device import resolve_device
from protoasnet_tpu_torch.utils.io import (checkpoint_format,
                                          load_checkpoint,
                                          load_migrated_pickle,
                                          read_flax_checkpoint,
                                          save_checkpoint)

__all__ = ["BaseAgent", "EndToEndTraining", "StagedTraining",
           "resolve_loader_batch_sizes", "stage_lrs"]


def resolve_loader_batch_sizes(dl_cfg: Dict[str, Any],
                               train_cfg: Dict[str, Any],
                               num_devices: int = 1) -> Dict[str, Any]:
    """The train batch from ``train.batch_size``; push rides
    push_batch_size, else eval_batch_size, else max(batch, 32). In place.

    Batches split over the ranks, so each size is rounded up to a multiple
    of ``num_devices`` (the padding rows carry valid=False). The eval
    batch is touched only where one is in play: an explicit
    ``eval_batch_size`` or image mode's default of 150 (video eval rides
    the train batch), as in the JAX package."""
    nd = int(num_devices)
    bsz = int(train_cfg.get("batch_size", dl_cfg.get("batch_size", 8)))
    if bsz % nd:
        bsz = -(-bsz // nd) * nd
        logging.info(f"batch_size rounded up to {bsz} for {nd} ranks")
    dl_cfg["batch_size"] = bsz
    if "eval_batch_size" in dl_cfg or int(dl_cfg.get("frames", 32)) == 1:
        ebsz = int(dl_cfg.get("eval_batch_size", 150))
        if ebsz % nd:
            dl_cfg["eval_batch_size"] = -(-ebsz // nd) * nd
    pbsz = int(dl_cfg.get("push_batch_size")
               or dl_cfg.get("eval_batch_size") or max(bsz, 32))
    dl_cfg["push_batch_size"] = -(-pbsz // nd) * nd
    return dl_cfg


class BaseAgent:
    def __init__(self, config: Dict[str, Any]):
        device = resolve_device(config.get("device"))
        if maybe_initialize_distributed(device):
            logging.info(f"distributed: rank {torch.distributed.get_rank()}"
                         f" of {world_size()}")
        self.device = local_device(device)
        self.num_devices = data_size()
        self.config = config
        self.model_config = dict(config["model"])
        self.train_config = config["train"]
        self.data_config = dict(config["data"])
        self.abstain_class = bool(config.get("abstain_class", False))
        self.save_dir = config.get("save_dir", ".")
        seed = int(self.train_config.get("seed", 0))

        self.model_config.setdefault("img_size",
                                     self.data_config.get("img_size", 224))
        model = build_model(self.model_config, device="cpu", seed=seed)
        if self.model_config.get("pretrained", False):
            load_pretrained_backbone(model, self.model_config)
        self.model = replicate(model.to(self.device))
        n_params = sum(p.numel() for p in self.model.parameters())
        logging.info(f"model {self.model_config['name']}: "
                     f"{n_params / 1e6:.2f}M params on {self.device}")

        self._store_cache: Dict[str, Any] = {}
        dl_cfg = resolve_loader_batch_sizes(
            dict(self.data_config), self.train_config, self.num_devices)
        if not is_main():
            barrier()  # rank 0 writes the packed stores; then we read them
        self.data_loaders = {
            name: get_as_dataloader(dl_cfg, split, mode, seed,
                                    self._store_cache, device=self.device)
            for name, split, mode in (("train", "train", "train"),
                                      ("val", "val", "val"),
                                      ("test", "test", "test"),
                                      ("train_push", "train", "push"))}
        if is_main():
            barrier()

        self.tracker = make_tracker(config)
        self.class_labels = list(CLASS_LABELS)
        self.current_epoch = 0
        self.current_iteration = 0
        self.best_metric = 0.0
        # the TransformLoss draws (one per step)
        self.generator = torch.Generator().manual_seed(seed)

    # ---------------- helpers ----------------

    def make_metrics(self) -> EpochMetrics:
        return EpochMetrics(
            num_classes=int(self.model_config["num_classes"]),
            abstain_class=self.abstain_class,
            num_prototypes=int(self.model.prototype_vectors.shape[0]),
            class_labels=self.class_labels)

    @property
    def logit_names(self) -> List[str]:
        return list(self.class_labels) + (["abstain"] if self.abstain_class
                                          else [])

    def pred_log_columns(self, batch, logits: np.ndarray
                         ) -> Dict[str, np.ndarray]:
        """Per-sample prediction rows of the valid (non-padding) samples."""
        v = np.asarray(batch["valid"]).astype(bool)
        cols = {
            "filename": np.array(batch["filename"], dtype=object)[v],
            "target_AS": np.asarray(batch["target_AS"])[v],
            "interval_idx": np.asarray(batch["interval_idx"])[v],
            "window_start": np.asarray(batch["window_start"])[v],
            "window_end": np.asarray(batch["window_end"])[v],
            "original_length": np.asarray(batch["original_length"])[v],
        }
        logits = np.asarray(logits, np.float32)[v]
        for i, name in enumerate(self.logit_names):
            cols[f"logit_{name}"] = logits[:, i]
        return cols

    # ---------------- checkpointing ----------------

    def get_state(self) -> Dict[str, Any]:
        return {"epoch": self.current_epoch,
                "iteration": self.current_iteration,
                "model": self.model.state_dict(),
                **self._optimizer_state(),
                "best_metric": self.best_metric}

    def set_state(self, st: Dict[str, Any]) -> None:
        self.model.load_state_dict(st["model"])
        self._load_optimizer_state(st)
        self.current_epoch = int(st["epoch"])
        self.current_iteration = int(st["iteration"])
        self.best_metric = float(st["best_metric"])

    def set_state_from_jax(self, st: Dict[str, Any]) -> None:
        """The state of a checkpoint the JAX package's agent wrote (its
        ``get_state`` layout, read by ``read_flax_checkpoint``), converted
        whole before anything is set. Its ``step`` counts micro-steps, as
        ``iteration`` does; Adam's step count comes from each optimiser
        state's own ``count``."""
        self.set_state({
            "epoch": st["epoch"], "iteration": st["iteration"],
            "best_metric": st["best_metric"],
            "model": state_dict_from_jax(self.model, st["params"],
                                         st["batch_stats"]),
            **self._optimizer_state_from_jax(st)})

    def set_state_from_migrated(self, blob: Dict[str, Any]) -> None:
        """Weights, BN statistics, epoch and iteration of a migrated
        reference checkpoint; the optimiser keeps its fresh state."""
        self.set_state({
            **self.get_state(),
            "epoch": blob.get("epoch", 0),
            "iteration": blob.get("iteration", 0),
            "model": state_dict_from_jax(self.model, blob["params"],
                                         blob["batch_stats"])})

    def _optimizer_state(self) -> Dict[str, Any]:
        """The optimisers', accumulators' and schedulers' checkpoint
        entries."""
        raise NotImplementedError

    def _load_optimizer_state(self, st: Dict[str, Any]) -> None:
        raise NotImplementedError

    def _optimizer_state_from_jax(self, st: Dict[str, Any]
                                  ) -> Dict[str, Any]:
        """``_optimizer_state``'s entries from a JAX checkpoint."""
        raise NotImplementedError

    def _scheduler_state(self, scheduler, lr_scale) -> Dict[str, Any]:
        """A scheduler's state with the JAX checkpoint's lr scale (the JAX
        package keeps nothing else of it)."""
        return {**scheduler.state_dict(), "lr": float(lr_scale)}

    def save_checkpoint(self, is_best: bool = False) -> None:
        if not self.train_config.get("save", True):
            return
        state = self.get_state()  # every rank: the accumulator sums ranks
        if not is_main():
            return
        self._ensure_config_dump()
        save_step = self.train_config.get("save_step")
        if save_step is not None and self.current_epoch % int(save_step) == 0:
            save_checkpoint(state, os.path.join(
                self.save_dir, f"epoch_{self.current_epoch}.ckpt"))
        if is_best:
            save_checkpoint(state, os.path.join(self.save_dir,
                                                "model_best.ckpt"))
        save_checkpoint(state, os.path.join(self.save_dir, "last.ckpt"))

    def _ensure_config_dump(self) -> None:
        """A run dir describes itself: dump the config unless the entry
        point already did."""
        if glob.glob(os.path.join(self.save_dir, "config_*.yml")):
            return
        from protoasnet_tpu_torch.utils.config import dump_config

        dump_config(self.config, os.path.join(self.save_dir,
                                              "config_agent.yml"))

    def save_model_w_condition(self, model_name: str, metric: float,
                               threshold: float) -> None:
        if metric > threshold:
            state = self.get_state()
            if is_main():
                save_checkpoint(state, os.path.join(
                    self.save_dir, f"{model_name}_f1-{metric:.4f}.ckpt"))

    def load_checkpoint_file(self, path: Optional[str]) -> None:
        """Load an explicit checkpoint or, with ``train.auto_resume``
        (default on), ``<save_dir>/last.ckpt`` if there is one. A file that
        does not load is logged and training starts fresh, as in the JAX
        package."""
        if not path and self.train_config.get("auto_resume", True):
            candidate = os.path.join(self.save_dir, "last.ckpt")
            if os.path.exists(candidate):
                path = candidate
                logging.info(f"auto-resume from {candidate}")
        if not path:
            return
        if not os.path.exists(path):
            logging.info(f"No checkpoint at {path!r}; training from scratch")
            return
        try:
            fmt = checkpoint_format(path)
            if fmt == "migrated":
                self.set_state_from_migrated(load_migrated_pickle(path))
            elif fmt == "flax":
                self.set_state_from_jax(read_flax_checkpoint(path))
            else:
                self.set_state(load_checkpoint(path))
            logging.info(f"Checkpoint ({fmt}) loaded from {path} (epoch "
                         f"{self.current_epoch}, iteration "
                         f"{self.current_iteration})")
        except Exception:  # noqa: BLE001 — logged; training starts fresh
            logging.exception(f"Failed to load checkpoint {path}; starting "
                              f"fresh")

    # ---------------- control flow ----------------

    def run(self) -> None:
        try:
            self.train()
        except KeyboardInterrupt:
            logging.info("CTRL+C received — finalizing")

    def train(self) -> None:
        raise NotImplementedError

    def evaluate(self, mode: str = "val"):
        return self.run_epoch(self.current_epoch, mode=mode)

    def run_epoch(self, epoch: int, mode: str = "train"):
        raise NotImplementedError

    def finalize(self) -> None:
        self.tracker.finish()


def stage_lrs(opt_cfg: Dict[str, Any], cfg_group: Dict[str, str],
              warm_occurrence: bool) -> Dict[str, Dict[str, float]]:
    """The staged agents' learning rates {stage: {group: lr}} from the
    config's ``joint_lrs``, ``warm_lrs`` and ``last_layer_lr``: a group a
    stage does not name takes its joint lr, else 1e-4; the last stage
    changes only the readout's. ``warm_occurrence``: the warm stage's
    occurrence module takes its joint lr (XProtoNet's warm optimiser
    trains it)."""
    joint = {cfg_group[k]: float(v)
             for k, v in opt_cfg.get("joint_lrs", {}).items()}
    warm = {cfg_group[k]: float(v)
            for k, v in opt_cfg.get("warm_lrs", {}).items()}
    base = {g: joint.get(g, 1e-4) for g in GROUPS}
    warm_lrs = {**base, **warm}
    if warm_occurrence:
        warm_lrs["occurrence"] = joint.get("occurrence", base["occurrence"])
    return {"warm": warm_lrs, "joint": {**base, **joint},
            "last": {**base, "last_layer": float(
                opt_cfg.get("last_layer_lr", 1e-4))}}


class EndToEndTraining:
    """The end-to-end agents: one optimiser (``self.optimizer``), its
    ``self.accumulator``, ``self.scheduler`` and one pair of steps."""

    def _steps_for(self, optimizer_name: str):
        return self.train_step, self.eval_step

    def _optimizer_state(self) -> Dict[str, Any]:
        return {"optimizer": self.optimizer.state_dict(),
                "accumulator": self.accumulator.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def _load_optimizer_state(self, st: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(st["optimizer"])
        self.accumulator.load_state_dict(st["accumulator"])
        self.scheduler.load_state_dict(st["scheduler"])

    def _optimizer_state_from_jax(self, st: Dict[str, Any]
                                  ) -> Dict[str, Any]:
        """{opt_state, acc, lr_scale} of the JAX end-to-end agents."""
        return {"optimizer": adam_state_from_jax(self.optimizer, self.model,
                                                 st["opt_state"]),
                "accumulator": accumulator_state_from_jax(
                    self.model, self.accumulator.params, st["acc"]),
                "scheduler": self._scheduler_state(self.scheduler,
                                                   st["lr_scale"])}


class StagedTraining:
    """The staged agents: ``self.stages`` (``StageOptimizers``), the steps
    of each stage in ``self._stage_steps``, ``self.schedulers`` by stage,
    and ``self._active_stage``, the stage whose learning rates ``_lrs``
    gives."""

    def _build_stages(self, make_steps, weight_decay: Dict[str, float]
                      ) -> None:
        """``self.stages`` and each stage's steps from ``make_steps`` (the
        model's step factory over ``self.bundle``)."""
        self.stages = StageOptimizers(
            self.model, weight_decay,
            int(self.train_config.get("accumulation_steps", 1)))
        self._stage_steps = {}
        for stage in STAGES:
            train_step, eval_step, self.push_step = make_steps(
                self.model, self.bundle, self.stages.optimizers[stage],
                self.stages.accumulators[stage], stage=stage)
            self._stage_steps[stage] = (train_step, eval_step)

    def _steps_for(self, optimizer_name: str):
        return self._stage_steps[optimizer_name if optimizer_name in STAGES
                                 else "joint"]

    def _optimizer_state(self) -> Dict[str, Any]:
        return {**self.stages.state_dict(),
                **{f"scheduler_{s}": sch.state_dict()
                   for s, sch in self.schedulers.items()}}

    def _load_optimizer_state(self, st: Dict[str, Any]) -> None:
        self.stages.load_state_dict(st)
        for s, sch in self.schedulers.items():
            sch.load_state_dict(st[f"scheduler_{s}"])

    def _optimizer_state_from_jax(self, st: Dict[str, Any]
                                  ) -> Dict[str, Any]:
        """{opt_state_<stage>, acc_<stage>} of the JAX staged agents (an
        accumulator a checkpoint lacks starts empty), and their lr scales:
        lr_scale_<scheduler> (XProtoNet) or one lr_scale (ProtoPNet, whose
        only scheduler is joint's)."""
        params = self.stages.params
        out = {}
        for s in STAGES:
            out[f"optimizer_{s}"] = adam_state_from_jax(
                self.stages.optimizers[s], self.model, st[f"opt_state_{s}"])
            out[f"accumulator_{s}"] = (
                accumulator_state_from_jax(self.model, params, st[f"acc_{s}"])
                if f"acc_{s}" in st else
                {"count": 0, "grads": [None] * len(params)})
        for s, sch in self.schedulers.items():
            key = f"lr_scale_{s}" if f"lr_scale_{s}" in st else "lr_scale"
            out[f"scheduler_{s}"] = self._scheduler_state(sch, st[key])
        return out

    def _train_epoch(self, epoch: int, stage: str) -> None:
        """One training epoch with ``stage``'s optimiser and accumulator."""
        self._active_stage = stage
        logging.info(f"stage: {stage}")
        self.stages.activate(stage)
        self.run_epoch(epoch, mode="train", optimizer_name=stage)
