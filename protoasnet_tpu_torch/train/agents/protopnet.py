"""ProtoPNet baseline agents, the JAX package's
``train/agents/protopnet.py`` in torch.

* ``ProtoPNetE2EAgent`` (``ProtoPNet_e2e``): one Adam over all groups,
  train -> val -> (push -> val_push) -> checkpoint every epoch;
* ``ProtoPNetStagedAgent`` (``ProtoPNet_Base``): warm -> joint (``StepLR``
  stepped after each joint epoch) -> push -> two last-layer epochs (not
  for the linear activation), each stage its own optimiser and
  accumulator (``train/optim.py::StageOptimizers``).

Loss: CE + ClusterPatch + SeparationPatch + L1(FC). The push is the
spatial-patch projection (``push/push_protopnet.py``). Metrics go through
the host, one device -> host copy per step (under data parallelism, of
every rank's rows: ``parallel/mesh.py``); rank 0 writes the CSVs and the
push's files.
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
from protoasnet_tpu_torch.parallel.mesh import (gather_rows, is_main,
                                                replicate)
from protoasnet_tpu_torch.push.push_protopnet import push_prototypes_patch
from protoasnet_tpu_torch.train.agents.base import (BaseAgent,
                                                   EndToEndTraining,
                                                   StagedTraining, stage_lrs)
from protoasnet_tpu_torch.train.aggregate import write_csv
from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                              GroupAdam, make_lr_scheduler)
from protoasnet_tpu_torch.train.steps import make_protopnet_steps

__all__ = ["ProtoPNetE2EAgent", "ProtoPNetStagedAgent"]

# the config's parameter-group names -> the group labels
_CFG_GROUP = {
    "features": "backbone",
    "cnn_backbone": "backbone",
    "add_on_layers": "add_on",
    "prototype_vectors": "prototypes",
    "last_layer": "last_layer",
}


class _ProtoPNetCommon(BaseAgent):
    """The loss, epoch loop and push shared by both ProtoPNet agents."""

    def _make_bundle(self) -> LossBundle:
        return LossBundle(self.train_config["criterion"],
                          num_classes=int(self.model_config["num_classes"]),
                          abstain_class=False)

    def run_epoch(self, epoch: int, mode: str = "train",
                  optimizer_name: str = "default"
                  ) -> Tuple[float, float, float]:
        """One pass over the mode's loader: (balanced accuracy, mean F1,
        AUROC)."""
        loader = self.data_loaders[mode.split("_")[0] if "_push" in mode
                                   else mode]
        loader.set_epoch(epoch)
        metrics = self.make_metrics()
        is_train = mode == "train"
        train_step, eval_step = self._steps_for(optimizer_name)
        t0 = time.time()
        pred_log = []
        for batch in loader:
            if is_train:
                m = train_step(batch["cine"], batch["target_dev"],
                               batch["valid_dev"], self._lrs())
                self.current_iteration += 1
            else:
                m = eval_step(batch["cine"], batch["target_dev"],
                              batch["valid_dev"])
            # one device -> host copy per step
            loss_terms = {k: float(v) for k, v in m.items()
                          if k.startswith("loss")}
            logits = gather_rows(m["logits"]).float().cpu().numpy()
            metrics.update(logits, batch["target_AS"], batch["valid"],
                           similarities=None, loss_terms=loss_terms)
            if mode in ("val_push", "test"):
                pred_log.append(self.pred_log_columns(batch, logits))
        summary = metrics.compute()
        logging.info(
            f"Epoch:{epoch}_{mode} | Time:{time.time() - t0:.0f}s | "
            f"Loss:{summary['losses'].get('loss_all', 0):.3f} | "
            f"Acc: {summary['accuracy']:.2%} | f1_avg: "
            f"{summary['f1_mean']:.4f} | AUC: {summary['AUC']:.4f}")
        self.tracker.log({
            "epoch": epoch,
            f"epoch/{mode}/loss_all": summary["losses"].get("loss_all", 0.0),
            f"epoch/{mode}/f1_mean": summary["f1_mean"],
            f"epoch/{mode}/accuracy": summary["accuracy"],
            f"epoch/{mode}/AUC_mean": summary["AUC"]})
        if pred_log and is_main():
            out_dir = os.path.join(self.save_dir, f"csv_{mode}")
            os.makedirs(out_dir, exist_ok=True)
            cols = {k: np.concatenate([c[k] for c in pred_log])
                    for k in pred_log[0]}
            write_csv(os.path.join(
                out_dir, f"e{epoch:02d}_f1_{summary['f1_mean']:.0%}.csv"),
                cols, index=True)
        return summary["accuracy"], summary["f1_mean"], summary["AUC"]

    def push(self, replace_prototypes: bool = True) -> None:
        p = self.model.prototype_vectors.shape[0]
        new_vectors, _ = push_prototypes_patch(
            self.data_loaders["train_push"], self.push_step, self.model,
            class_identity=prototype_class_identity(
                p, int(self.model_config["num_classes"])),
            root_dir_for_saving_prototypes=os.path.join(self.save_dir,
                                                        "img"),
            epoch_number=f"{self.current_epoch}_pushed",
            replace_prototypes=replace_prototypes,
            img_size=int(self.data_config.get("img_size", 224)))
        if replace_prototypes:
            with torch.no_grad():
                self.model.prototype_vectors.copy_(new_vectors)
            replicate(self.model)  # rank 0's vectors on every rank


class ProtoPNetE2EAgent(EndToEndTraining, _ProtoPNetCommon):
    """End-to-end agent: one Adam over all parameters, ``StepLR`` by
    default."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        opt_cfg = self.train_config["optimizer"]
        mode = opt_cfg.get("mode", "lr_same")
        if mode == "lr_same":
            lr = float(opt_cfg["lr_same"])
            self.base_lrs = {g: lr for g in GROUPS}
            wd = {g: 1e-3 for g in GROUPS}
        elif mode == "lr_disjoint":
            self.base_lrs = {_CFG_GROUP[k]: float(v)
                             for k, v in opt_cfg["lr_disjoint"].items()}
            wd = {"backbone": 1e-3, "add_on": 1e-3}
        else:
            raise ValueError(f"optimizer mode {mode!r} not valid")
        self.lr = self.base_lrs["prototypes"]
        self.bundle = self._make_bundle()
        self.optimizer = GroupAdam(self.model, weight_decay_by_group=wd)
        self.accumulator = GradAccumulator(
            self.optimizer.params,
            int(self.train_config.get("accumulation_steps", 1)))
        self.train_step, self.eval_step, self.push_step = \
            make_protopnet_steps(self.model, self.bundle, self.optimizer,
                                 self.accumulator, stage="all")
        self.scheduler = make_lr_scheduler(
            self.train_config.get("lr_schedule", {"name": "StepLR"}), 1.0)
        self.load_checkpoint_file(self.model_config.get("checkpoint_path"))

    def _lrs(self) -> Dict[str, float]:
        return {g: self.base_lrs.get(g, 0.0) * self.scheduler.lr
                for g in GROUPS}

    def train(self) -> None:
        tc = self.train_config
        for epoch in range(self.current_epoch, int(tc["num_train_epochs"])):
            self.current_epoch = epoch
            self.run_epoch(epoch, mode="train")
            _, mean_f1, _ = self.run_epoch(epoch, mode="val")
            self.scheduler.step(mean_f1)
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
                self.save_checkpoint(is_best=is_best)
            self.save_checkpoint(is_best=False)


class ProtoPNetStagedAgent(StagedTraining, _ProtoPNetCommon):
    """Staged agent: warm -> joint -> push -> last, each stage its own
    optimiser and accumulator."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.stage_lrs = stage_lrs(self.train_config["optimizer"],
                                   _CFG_GROUP, warm_occurrence=False)
        self.lr = self.stage_lrs["joint"]["prototypes"]
        self.bundle = self._make_bundle()
        self._build_stages(make_protopnet_steps,
                           {"backbone": 1e-3, "add_on": 1e-3})
        self.schedulers = {"joint": make_lr_scheduler(
            self.train_config.get("lr_schedule", {"name": "StepLR"}), 1.0)}
        self._active_stage = "joint"
        self.load_checkpoint_file(self.model_config.get("checkpoint_path"))

    def _lrs(self) -> Dict[str, float]:
        stage = self._active_stage
        scale = self.schedulers["joint"].lr if stage == "joint" else 1.0
        return {g: self.stage_lrs[stage][g] * scale for g in GROUPS}

    def train(self) -> None:
        tc = self.train_config
        warm_epochs = int(tc.get("num_warm_epochs", 0))
        for epoch in range(self.current_epoch, int(tc["num_train_epochs"])):
            self.current_epoch = epoch
            if epoch < warm_epochs:
                self._train_epoch(epoch, "warm")
            else:
                self._train_epoch(epoch, "joint")
                self.schedulers["joint"].step()
            _, mean_f1, _ = self.run_epoch(epoch, mode="val")
            self.save_model_w_condition(f"{epoch}nopush", mean_f1, 0.65)
            if (epoch >= int(tc.get("push_start", 1 << 30))
                    and epoch % int(tc.get("push_rate", 5)) == 0):
                self.push(replace_prototypes=True)
                _, mean_f1, _ = self.run_epoch(epoch, mode="val_push")
                self.save_model_w_condition(f"{epoch}push", mean_f1, 0.65)
                # the linear activation's last layer is not retrained
                if self.model_config.get("prototype_activation_function",
                                         "log") != "linear":
                    for i in range(2):
                        self._train_epoch(epoch, "last")
                        _, mean_f1, _ = self.run_epoch(epoch, mode="val")
                        self.save_model_w_condition(f"{epoch}_{i}push",
                                                    mean_f1, 0.65)
                is_best = mean_f1 > self.best_metric
                if is_best:
                    self.best_metric = mean_f1
                self.save_checkpoint(is_best=is_best)
            self.save_checkpoint(is_best=False)
