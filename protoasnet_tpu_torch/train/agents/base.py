"""Base agent: model, loaders, tracker, checkpoints and the epoch loop's
logging (the JAX package's ``train/agents/base.py`` in torch).

The agent runs on ``config["device"]`` (CUDA unless "cpu" is asked for;
without a card and without that request it raises). Its checkpoint is the
port's own: a ``torch.save`` of {epoch, iteration, model, optimizer,
accumulator, scheduler, best_metric}; ``last.ckpt`` after every epoch,
``model_best.ckpt`` on the best mean F1, threshold-gated named ones.
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
from protoasnet_tpu_torch.models.pretrained import load_pretrained_backbone
from protoasnet_tpu_torch.tracking.trackers import make_tracker
from protoasnet_tpu_torch.train.metrics import EpochMetrics
from protoasnet_tpu_torch.utils.device import resolve_device
from protoasnet_tpu_torch.utils.io import load_checkpoint, save_checkpoint

__all__ = ["BaseAgent", "resolve_loader_batch_sizes"]


def resolve_loader_batch_sizes(dl_cfg: Dict[str, Any],
                               train_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The train batch from ``train.batch_size``; push rides
    push_batch_size, else eval_batch_size, else max(batch, 32). In place."""
    bsz = int(train_cfg.get("batch_size", dl_cfg.get("batch_size", 8)))
    dl_cfg["batch_size"] = bsz
    dl_cfg["push_batch_size"] = int(dl_cfg.get("push_batch_size")
                                    or dl_cfg.get("eval_batch_size")
                                    or max(bsz, 32))
    return dl_cfg


class BaseAgent:
    def __init__(self, config: Dict[str, Any]):
        self.device = resolve_device(config.get("device"))
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
        self.model = model.to(self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        logging.info(f"model {self.model_config['name']}: "
                     f"{n_params / 1e6:.2f}M params on {self.device}")

        self._store_cache: Dict[str, Any] = {}
        dl_cfg = resolve_loader_batch_sizes(dict(self.data_config),
                                            self.train_config)
        self.data_loaders = {
            name: get_as_dataloader(dl_cfg, split, mode, seed,
                                    self._store_cache, device=self.device)
            for name, split, mode in (("train", "train", "train"),
                                      ("val", "val", "val"),
                                      ("test", "test", "test"),
                                      ("train_push", "train", "push"))}

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
        raise NotImplementedError

    def set_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def save_checkpoint(self, is_best: bool = False) -> None:
        if not self.train_config.get("save", True):
            return
        self._ensure_config_dump()
        state = self.get_state()
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
            save_checkpoint(self.get_state(), os.path.join(
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
        if path.endswith((".pkl", ".pickle", ".msgpack")):
            raise ValueError(f"{path}: the port loads only its own "
                             f"checkpoints (torch.save), not the JAX "
                             f"package's")
        try:
            self.set_state(load_checkpoint(path))
            logging.info(f"Checkpoint loaded from {path} (epoch "
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
