"""The end-to-end XProtoNet / ProtoASNet agent (image and video), the JAX
package's ``XProtoNetE2EAgent`` in torch: one Adam over all parameter
groups, the 7-term loss, train -> val -> (push -> val_push) -> checkpoint
every epoch. Registered as ``Video_XProtoNet_e2e`` and ``XProtoNet_e2e``.

Each epoch's metrics go through the host: one device -> host copy per
step (the JAX package's ``on_device_metrics: false`` path).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from protoasnet_tpu_torch.losses.bundle import LossBundle
from protoasnet_tpu_torch.models.layers import prototype_class_identity
from protoasnet_tpu_torch.push.push import push_prototypes
from protoasnet_tpu_torch.train.agents.base import BaseAgent
from protoasnet_tpu_torch.train.aggregate import (aggregate_predictions,
                                                  write_csv)
from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                              GroupAdam, make_lr_scheduler)
from protoasnet_tpu_torch.train.steps import make_xprotonet_steps

__all__ = ["XProtoNetE2EAgent"]

# the config's parameter-group names -> the group labels
_CFG_GROUP = {
    "cnn_backbone": "backbone",
    "add_on_layers": "add_on",
    "occurrence_module": "occurrence",
    "prototype_vectors": "prototypes",
    "last_layer": "last_layer",
}


class XProtoNetE2EAgent(BaseAgent):
    """End-to-end agent: one Adam over all parameters."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        opt_cfg = self.train_config["optimizer"]
        mode = opt_cfg.get("mode", "lr_same")
        if mode == "lr_same":
            lr = float(opt_cfg["lr_same"])
            self.group_lrs = {g: lr for g in GROUPS}
            wd = {g: 1e-3 for g in GROUPS}  # torch: one group, wd on all
        elif mode == "lr_disjoint":
            spec = opt_cfg["lr_disjoint"]
            self.group_lrs = {_CFG_GROUP[k]: float(v)
                              for k, v in spec.items()}
            wd = {"backbone": 1e-3, "add_on": 1e-3, "occurrence": 1e-3}
        else:
            raise ValueError(f"optimizer mode {mode!r} not valid")
        self.base_lrs = dict(self.group_lrs)
        self.lr = self.group_lrs["prototypes"]

        self.bundle = LossBundle(
            self.train_config["criterion"],
            num_classes=int(self.model_config["num_classes"]),
            abstain_class=self.abstain_class)
        self.optimizer = GroupAdam(self.model, weight_decay_by_group=wd)
        self.accumulator = GradAccumulator(
            self.optimizer.params,
            int(self.train_config.get("accumulation_steps", 1)))
        self.train_step, self.eval_step, self.push_step = \
            make_xprotonet_steps(self.model, self.bundle, self.optimizer,
                                 self.accumulator, stage="all")
        sched_cfg = dict(self.train_config.get(
            "lr_schedule", {"name": "ReduceLROnPlateau"}))
        # the scheduler tracks a scale of the base lrs; the config's min_lr
        # floors the product (torch's absolute min_lr), in _clamp_lr
        self.min_abs_lr = float(sched_cfg.pop("min_lr", 0.0))
        self.scheduler = make_lr_scheduler(sched_cfg, initial_lr=1.0)
        self.load_checkpoint_file(self.model_config.get("checkpoint_path"))

    # ---------------- learning rates ----------------

    def _clamp_lr(self, base: float, scale: float) -> float:
        """base * scale, floored at min_lr; a group with base 0 is not
        trained at all and gets no floor."""
        lr = base * scale
        return max(lr, self.min_abs_lr) if base > 0 else lr

    def _lrs(self) -> Dict[str, float]:
        return {g: self._clamp_lr(self.base_lrs[g], self.scheduler.lr)
                for g in GROUPS}

    # ---------------- checkpoint state ----------------

    def get_state(self) -> Dict[str, Any]:
        return {"epoch": self.current_epoch,
                "iteration": self.current_iteration,
                "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "accumulator": self.accumulator.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "best_metric": self.best_metric}

    def set_state(self, st: Dict[str, Any]) -> None:
        self.model.load_state_dict(st["model"])
        self.optimizer.load_state_dict(st["optimizer"])
        self.accumulator.load_state_dict(st["accumulator"])
        self.scheduler.load_state_dict(st["scheduler"])
        self.current_epoch = int(st["epoch"])
        self.current_iteration = int(st["iteration"])
        self.best_metric = float(st["best_metric"])

    # ---------------- epochs ----------------

    def _epoch_log(self, epoch: int, mode: str, summary: Dict[str, Any],
                   seconds: float) -> None:
        losses = summary["losses"]
        loss_all = losses.get("loss_all", 0.0)
        f1 = summary["f1"]
        logging.info(
            f"Epoch:{epoch}_{mode} | Time:{seconds:.0f}s | "
            f"Loss:{loss_all:.3f} | Acc: {summary['accuracy']:.2%} | "
            f"f1: {[f'{v:.2%}' for v in f1]} | f1_avg: "
            f"{summary['f1_mean']:.4f} | AUC: {summary['AUC']:.4f}\n"
            f"Sparsity: {summary['sparsity']:.2f} | diversity: "
            f"{summary['diversity']}"
            + (f" | diversity_abstain: {summary['diversity_abstain']}"
               if self.abstain_class else ""))
        logging.info(f"Confusion matrix:\n{summary['confusion_matrix']}")
        if "report" in summary:
            logging.info("\n" + summary["report"])
        log = {"epoch": epoch,
               f"epoch/{mode}/loss_all": loss_all,
               f"epoch/{mode}/f1_mean": summary["f1_mean"],
               f"epoch/{mode}/accuracy": summary["accuracy"],
               f"epoch/{mode}/AUC_mean": summary["AUC"],
               f"epoch/{mode}/diversity": summary["diversity"],
               f"epoch/{mode}/sparsity": summary["sparsity"],
               "lr": float(self.lr)}
        for name, v in losses.items():
            if name != "loss_all":
                log[f"epoch/{mode}/{name}"] = v
        for name, v in zip(self.class_labels, f1):
            log[f"epoch/{mode}/f1_{name}"] = v
        if self.abstain_class:
            log[f"epoch/{mode}/diversity_abstain"] = \
                summary["diversity_abstain"]
        self.tracker.log(log)

    def run_epoch(self, epoch: int, mode: str = "train"
                  ) -> Tuple[float, float, float]:
        """One pass over the mode's loader: (balanced accuracy, mean F1,
        AUROC)."""
        loader = self.data_loaders[mode.split("_")[0] if "_push" in mode
                                   else mode]
        loader.set_epoch(epoch)
        metrics = self.make_metrics()
        is_train = mode == "train"
        t0 = time.time()
        pred_log = []
        epoch_steps = len(loader)
        for batch in loader:
            if is_train:
                m = self.train_step(batch["cine"], batch["target_dev"],
                                    batch["valid_dev"], self._lrs(),
                                    generator=self.generator)
                self.current_iteration += 1
            else:
                m = self.eval_step(batch["cine"], batch["target_dev"],
                                   batch["valid_dev"],
                                   generator=self.generator)
            # one device -> host copy per step
            loss_terms = {k: float(v) for k, v in m.items()
                          if k.startswith("loss")}
            logits = m["logits"].float().cpu().numpy()
            stats = metrics.update(
                logits, batch["target_AS"], batch["valid"],
                similarities=m["similarities"].float().cpu().numpy(),
                loss_terms=loss_terms)
            self.tracker.log({
                f"batch_{mode}/step": epoch * epoch_steps + batch["step"],
                **{f"batch_{mode}/{k}": v for k, v in loss_terms.items()},
                **{f"batch_{mode}/{k}": v for k, v in stats.items()}})
            if mode in ("val_push", "test"):
                pred_log.append(self.pred_log_columns(batch, logits))
        summary = metrics.compute()
        self._epoch_log(epoch, mode, summary, time.time() - t0)

        if pred_log:
            out_dir = os.path.join(self.save_dir, f"csv_{mode}")
            os.makedirs(out_dir, exist_ok=True)
            cols = {k: np.concatenate([c[k] for c in pred_log])
                    for k in pred_log[0]}
            write_csv(os.path.join(
                out_dir, f"e{epoch:02d}_f1_{summary['f1_mean']:.0%}.csv"),
                cols, index=True)
            video_cols, video_metrics = aggregate_predictions(
                cols, abstain_class=self.abstain_class)
            write_csv(os.path.join(out_dir, f"e{epoch:02d}_video_level.csv"),
                      video_cols)
            logging.info("%s e%d video-level (%d videos): %s", mode, epoch,
                         video_metrics.get("n_videos", 0),
                         {k: round(v, 4) for k, v in video_metrics.items()
                          if k != "n_videos"})
            self.tracker.log({f"epoch/{mode}/video_{k}": v
                              for k, v in video_metrics.items()})
        return summary["accuracy"], summary["f1_mean"], summary["AUC"]

    def push(self, replace_prototypes: bool = True) -> None:
        p = self.model.prototype_vectors.shape[0]
        new_vectors, _ = push_prototypes(
            self.data_loaders["train_push"], self.push_step,
            self.model.prototype_vectors,
            class_identity=prototype_class_identity(
                p, int(self.model_config["num_classes"])),
            class_specific=True, abstain_class=self.abstain_class,
            root_dir_for_saving_prototypes=os.path.join(self.save_dir,
                                                        "img"),
            epoch_number=f"{self.current_epoch}_pushed",
            replace_prototypes=replace_prototypes,
            render=bool(self.config.get("render_prototypes", True)))
        if replace_prototypes:
            with torch.no_grad():
                self.model.prototype_vectors.copy_(new_vectors)

    def train(self) -> None:
        tc = self.train_config
        for epoch in range(self.current_epoch, int(tc["num_train_epochs"])):
            self.current_epoch = epoch
            self.run_epoch(epoch, mode="train")
            _, mean_f1, _ = self.run_epoch(epoch, mode="val")
            self.lr = self._clamp_lr(self.base_lrs["prototypes"],
                                     self.scheduler.step(mean_f1))
            if epoch == int(tc.get("num_warm_epochs", 0)):
                self.push(replace_prototypes=False)
            if (epoch >= int(tc.get("push_start", 1 << 30))
                    and epoch % int(tc.get("push_rate", 5)) == 0):
                self.push(replace_prototypes=True)
                _, mean_f1, _ = self.run_epoch(epoch, mode="val_push")
                self.save_model_w_condition(f"{epoch}push", mean_f1, 0.65)
                is_best = mean_f1 > self.best_metric
                if is_best:
                    self.best_metric = mean_f1
                    logging.info(f"new best mean_f1 {mean_f1:.4f}")
                self.save_checkpoint(is_best=is_best)
            self.save_checkpoint(is_best=False)
