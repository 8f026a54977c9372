"""XProtoNet / ProtoASNet agents (image and video), the JAX package's
``train/agents/xprotonet.py`` in torch.

* ``XProtoNetE2EAgent`` (``Video_XProtoNet_e2e``, ``XProtoNet_e2e``): one
  Adam over all parameter groups, the 7-term loss, train -> val ->
  (push -> val_push) -> checkpoint every epoch;
* ``XProtoNetStagedAgent`` (``XProtoNet_Base``): warm -> joint -> push ->
  last-layer epochs, each stage its own optimiser and accumulator
  (``train/optim.py::StageOptimizers``), ``ReduceLROnPlateau`` for joint
  and for last.

The epoch loop is the JAX package's: with ``train.on_device_metrics``
(default true) each step's outputs are written into device buffers and
copied to the host once at the epoch's end (``train/device_metrics.py``),
with no per-batch tracker rows; ``false``, and always for val_push and
test (their prediction CSVs need per-sample metadata), each step's loss
terms, logits and similarities are copied to the host and logged per
batch. A ``StepTimer`` logs the data / step / host_metrics breakdown of
every epoch, and a ``torch.profiler`` trace is written to ``profile_dir``
(or ``$PROTOASNET_PROFILE_DIR``) for the training epoch ``profile_epoch``
(default 1; ``utils/profiling.py``).

Both agents explain: ``explain_local`` (``explain/local.py``: one sweep of
the push step over the eval split, ranked panels), ``explain_global`` (a
push that renders the prototypes without replacing them) and
``get_sim_scores`` / ``load_sim_scores`` (per-sample similarities for
prototype ranking, ``ranking_prototypes/sim_scores_<mode>_epoch<e>.npz``).

Under data parallelism (``parallel/mesh.py``) each step runs on the rank's
rows; the host path gathers each step's logits and similarities from all
ranks, the device path at the epoch's end, so every rank computes the
single-process summary, and rank 0 writes the CSVs and the files of the
push and the explanations.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from protoasnet_tpu_torch.losses.bundle import LossBundle
from protoasnet_tpu_torch.models.backbones import \
    refuse_transformer_trunk
from protoasnet_tpu_torch.models.layers import prototype_class_identity
from protoasnet_tpu_torch.parallel.mesh import (gather_rows, is_main,
                                                replicate)
from protoasnet_tpu_torch.push.push import push_prototypes
from protoasnet_tpu_torch.train.agents.base import (BaseAgent,
                                                   EndToEndTraining,
                                                   StagedTraining, stage_lrs)
from protoasnet_tpu_torch.train.aggregate import (aggregate_predictions,
                                                  write_csv)
from protoasnet_tpu_torch.train.device_metrics import DeviceEpochBuffer
from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                              GroupAdam, make_lr_scheduler)
from protoasnet_tpu_torch.train.steps import make_xprotonet_steps
from protoasnet_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["XProtoNetE2EAgent", "XProtoNetStagedAgent"]

# the config's parameter-group names -> the group labels
_CFG_GROUP = {
    "cnn_backbone": "backbone",
    "add_on_layers": "add_on",
    "occurrence_module": "occurrence",
    "prototype_vectors": "prototypes",
    "last_layer": "last_layer",
}


class _XProtoNetAgentCommon(BaseAgent):
    """The loss, learning-rate floor, epoch loop and push shared by the
    end-to-end and the staged agents."""

    min_abs_lr = 0.0

    def _make_bundle(self) -> LossBundle:
        return LossBundle(
            self.train_config["criterion"],
            num_classes=int(self.model_config["num_classes"]),
            abstain_class=self.abstain_class)

    def _clamp_lr(self, base: float, scale: float) -> float:
        """base * scale, floored at min_lr (torch's absolute floor: the
        schedulers track a scale of the base lrs); a group with base 0 is
        not trained at all and gets no floor."""
        lr = base * scale
        return max(lr, self.min_abs_lr) if base > 0 else lr

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
        epoch_steps = len(loader)
        profile_dir = (self.config.get("profile_dir")
                       or os.environ.get("PROTOASNET_PROFILE_DIR"))
        do_trace = (is_train and profile_dir
                    and epoch == int(self.config.get("profile_epoch", 1)))
        # val_push/test keep the host path: their CSVs need per-sample
        # metadata; the device path logs no per-batch tracker rows
        on_device = (bool(self.train_config.get("on_device_metrics", True))
                     and mode not in ("val_push", "test"))
        dev_buf = None
        timer = StepTimer()
        with trace(profile_dir if do_trace else None):
            it = iter(loader)
            while True:
                with timer.phase("data"):
                    batch = next(it, None)
                if batch is None:
                    break
                with timer.phase("step"):
                    if is_train:
                        m = train_step(batch["cine"], batch["target_dev"],
                                       batch["valid_dev"], self._lrs(),
                                       generator=self.generator)
                        self.current_iteration += 1
                    else:
                        m = eval_step(batch["cine"], batch["target_dev"],
                                      batch["valid_dev"],
                                      generator=self.generator)
                with timer.phase("host_metrics"):
                    if on_device:
                        if dev_buf is None:
                            dev_buf = DeviceEpochBuffer(
                                n_batches=epoch_steps,
                                batch_size=m["logits"].shape[0],
                                num_logits=m["logits"].shape[1],
                                num_prototypes=m["similarities"].shape[1],
                                loss_names=sorted(k for k in m
                                                  if k.startswith("loss")),
                                device=m["logits"].device)
                        dev_buf.update(m, batch["target_dev"],
                                       batch["valid_dev"])
                        continue
                    # one device -> host copy per step (of every rank's
                    # rows: the host metadata is the global batch's)
                    loss_terms = {k: float(v) for k, v in m.items()
                                  if k.startswith("loss")}
                    logits = gather_rows(m["logits"]).float().cpu().numpy()
                    sims = gather_rows(m["similarities"]).float().cpu()
                    stats = metrics.update(
                        logits, batch["target_AS"], batch["valid"],
                        similarities=sims.numpy(), loss_terms=loss_terms)
                    self.tracker.log({
                        f"batch_{mode}/step": epoch * epoch_steps
                        + batch["step"],
                        **{f"batch_{mode}/{k}": v
                           for k, v in loss_terms.items()},
                        **{f"batch_{mode}/{k}": v for k, v in stats.items()}})
                    if mode in ("val_push", "test"):
                        pred_log.append(self.pred_log_columns(batch, logits))
            if dev_buf is not None:
                with timer.phase("host_metrics"):
                    dev_buf.finalize(metrics)
        timer.log(prefix=f"{mode} e{epoch} ")
        self.epoch_timer = timer  # the last epoch's breakdown
        summary = metrics.compute()
        self._epoch_log(epoch, mode, summary, time.time() - t0)

        if pred_log and is_main():
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
        refuse_transformer_trunk(self.model,
                                 "the prototype push (and explain_global)")
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
            replicate(self.model)  # rank 0's vectors on every rank

    # ---------------- explanations ----------------

    def get_sim_scores(self, mode: str = "train") -> str:
        """Write the valid samples' prototype similarities and targets of
        ``mode``'s loader to ``ranking_prototypes/`` (.npz); returns the
        path."""
        from protoasnet_tpu_torch.explain.local import sweep

        sims, targets = [], []
        for batch, v, sim, _, _ in sweep(self, mode):
            sims.append(sim)
            targets.append(np.asarray(batch["target_AS"])[v])
        out_dir = os.path.join(self.save_dir, "ranking_prototypes")
        path = os.path.join(
            out_dir, f"sim_scores_{mode}_epoch{self.current_epoch}.npz")
        if is_main():
            os.makedirs(out_dir, exist_ok=True)
            np.savez(path, sim_scores=np.concatenate(sims),
                     targets=np.concatenate(targets))
            logging.info(f"sim scores written to {out_dir}")
        return path

    def load_sim_scores(self, epoch: int, mode: str):
        data = np.load(os.path.join(
            self.save_dir, "ranking_prototypes",
            f"sim_scores_{mode}_epoch{epoch}.npz"))
        return data["sim_scores"], data["targets"]

    def explain_local(self, mode: str = "test") -> Dict[str, Any]:
        from protoasnet_tpu_torch.explain.local import explain_local

        refuse_transformer_trunk(self.model, "explain_local")
        return explain_local(self, mode=mode)

    def explain_global(self, mode: str = "test") -> None:
        """The prototypes' own evidence: a push over the train split that
        renders each prototype's best sample without replacing it."""
        self.push(replace_prototypes=False)


class XProtoNetE2EAgent(EndToEndTraining, _XProtoNetAgentCommon):
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

        self.bundle = self._make_bundle()
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

    def _lrs(self) -> Dict[str, float]:
        return {g: self._clamp_lr(self.base_lrs[g], self.scheduler.lr)
                for g in GROUPS}

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


class XProtoNetStagedAgent(StagedTraining, _XProtoNetAgentCommon):
    """Staged agent: warm -> joint -> push -> five last-layer epochs, each
    stage its own optimiser and accumulator."""

    def __init__(self, config: Dict[str, Any]):
        super().__init__(config)
        self.stage_lrs = stage_lrs(self.train_config["optimizer"],
                                   _CFG_GROUP, warm_occurrence=True)
        self.lr = self.stage_lrs["joint"]["prototypes"]
        self.bundle = self._make_bundle()
        self._build_stages(make_xprotonet_steps,
                           {"backbone": 1e-3, "add_on": 1e-3,
                            "occurrence": 1e-3})
        sched_cfg = dict(self.train_config.get(
            "lr_schedule", {"name": "ReduceLROnPlateau"}))
        self.min_abs_lr = float(sched_cfg.pop("min_lr", 0.0))
        self.schedulers = {s: make_lr_scheduler(sched_cfg, 1.0)
                           for s in ("joint", "last")}
        self._active_stage = "joint"
        self.load_checkpoint_file(self.model_config.get("checkpoint_path"))

    def _lrs(self) -> Dict[str, float]:
        stage = self._active_stage
        scale = self.schedulers["last" if stage == "last" else "joint"].lr
        return {g: self._clamp_lr(self.stage_lrs[stage][g], scale)
                for g in GROUPS}

    def train(self) -> None:
        tc = self.train_config
        warm_epochs = int(tc.get("num_warm_epochs", 0))
        for epoch in range(self.current_epoch, int(tc["num_train_epochs"])):
            self.current_epoch = epoch
            self._train_epoch(epoch, "warm" if epoch < warm_epochs
                              else "joint")
            if epoch == warm_epochs:
                self.push(replace_prototypes=False)
            _, mean_f1, _ = self.run_epoch(epoch, mode="val")
            self.save_model_w_condition(f"{epoch}nopush", mean_f1, 0.75)
            if epoch > warm_epochs and \
                    tc.get("lr_schedule", {}).get("name") != "StepLR":
                self.schedulers["joint"].step(mean_f1)
            if (epoch >= int(tc.get("push_start", 1 << 30))
                    and epoch % int(tc.get("push_rate", 5)) == 0):
                self.push(replace_prototypes=True)
                _, mean_f1, _ = self.run_epoch(epoch, mode="val_push")
                self.save_model_w_condition(f"{epoch}push", mean_f1, 0.65)
                for i in range(5):
                    self._train_epoch(epoch, "last")
                    _, mean_f1, _ = self.run_epoch(epoch, mode="val_push")
                    self.save_model_w_condition(f"{epoch}_{i}push", mean_f1,
                                                0.70)
                    self.schedulers["last"].step(mean_f1)
                    is_best = mean_f1 > self.best_metric
                    if is_best:
                        self.best_metric = mean_f1
                        logging.info(f"new best mean_f1 {mean_f1:.4f}")
                    self.save_checkpoint(is_best=is_best)
            self.save_checkpoint(is_best=False)
