"""Run directories, logging, seeding and the source backup of a training
run (the JAX package's ``utils/run.py`` without its compilation caches)."""

from __future__ import annotations

import logging
import os
import random
import shutil
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["set_seed", "set_logger", "create_save_loc", "open_run",
           "backup_code", "makedir"]


def makedir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators. The port's
    own randomness uses explicit generators; this covers library code."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def set_logger(save_dir: str, log_level: str = "info",
               run_type: str = "train", comment: str = "") -> None:
    """File + stdout logging, one level-named log file per run type."""
    level = getattr(logging, log_level.upper(), logging.INFO)
    makedir(save_dir)
    log_path = os.path.join(save_dir, f"{log_level}_{run_type}{comment}.log")
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):  # no duplicates when called twice
        if isinstance(h, (logging.FileHandler, logging.StreamHandler)):
            root.removeHandler(h)
            h.close()
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    fh = logging.FileHandler(log_path)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(fh)
    root.addHandler(sh)


def create_save_loc(config: Dict[str, Any]) -> None:
    """Resolve ``config['save_dir']`` to the run directory
    ``<save_dir>/<run_name>``: reused when it holds a checkpoint (so a run
    resumes), else the first free ``_<n>`` suffix."""
    base = os.path.join(config["save_dir"], config["run_name"])
    save_dir = base
    idx = 1
    while os.path.exists(save_dir):
        if any(f.endswith((".ckpt", ".pth")) for f in os.listdir(save_dir)
               if os.path.isfile(os.path.join(save_dir, f))):
            break
        save_dir = f"{base}_{idx}"
        idx += 1
    makedir(save_dir)
    config["save_dir"] = save_dir


def open_run(config: Dict[str, Any], run_type: str) -> str:
    """An entry point's run directory (``create_save_loc``), its log file
    and its ``config_<run_type>.yml``; returns the directory. Under data
    parallelism rank 0 picks and writes it and the other ranks take its
    choice (``parallel/mesh.py``)."""
    from protoasnet_tpu_torch.parallel.mesh import broadcast_object, is_main
    from protoasnet_tpu_torch.utils.config import dump_config

    if is_main():
        create_save_loc(config)
    config["save_dir"] = save_dir = broadcast_object(config["save_dir"])
    if is_main():
        set_logger(save_dir, config.get("log_level", "info"), run_type)
        dump_config(config, f"{save_dir}/config_{run_type}.yml")
    return save_dir


def backup_code(save_dir: str, src_root: Optional[str] = None) -> None:
    """Copy the package's source into ``<save_dir>/code``."""
    if src_root is None:
        src_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(save_dir, "code", os.path.basename(src_root))
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src_root, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "*.pyc", "*.so", "*.o", "_build"))
