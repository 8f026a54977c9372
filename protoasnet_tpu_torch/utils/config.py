"""Config loading: YAML files + dotted overrides (``--a.b.c=value``).

The port's own copy of the JAX package's loader: ``load_config``,
``apply_overrides`` (unknown keys raise unless ``strict=False``, which
warns and adds them), ``updated_config`` (the training entry point's
command line), ``flatten_config`` and ``dump_config``. Values are parsed
with ``yaml.safe_load`` / ``ast.literal_eval``, never ``eval``.
"""

from __future__ import annotations

import ast
import copy
import logging
import os
import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import yaml

__all__ = ["load_config", "parse_value", "apply_overrides",
           "parse_prototype_shape", "flatten_config", "updated_config",
           "dump_config"]


def parse_value(raw: str) -> Any:
    """Parse an override string: bools, null/none, numbers, YAML lists,
    python tuples like "(40, 256, 1, 1, 1)", else the string itself."""
    s = raw.strip()
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    if s.startswith("(") and s.endswith(")"):
        try:
            return ast.literal_eval(s)
        except (ValueError, SyntaxError):
            return s
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any,
                strict: bool = True) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if strict:
                raise KeyError(f"Unknown config section {p!r} in override "
                               f"--{dotted}")
            logging.warning(f"override --{dotted} creates a new config "
                            f"section {p!r} (a typo?)")
            node[p] = {}
        node = node[p]
    if parts[-1] not in node:
        if strict:
            raise KeyError(f"Unknown config key {parts[-1]!r} in override "
                           f"--{dotted}")
        if len(parts) > 1:  # new top-level flags are normal
            logging.warning(f"override --{dotted} sets a key absent from "
                            f"the config file (a typo?)")
    node[parts[-1]] = value


def apply_overrides(cfg: Dict[str, Any], overrides: Iterable[str],
                    strict: bool = True) -> Dict[str, Any]:
    """Apply ``--a.b.c=value`` / ``a.b.c=value`` strings to a copy of cfg;
    with ``strict`` a key that the config does not have raises."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        item = ov.lstrip("-")
        if "=" not in item:
            raise ValueError(f"Override {ov!r} must have the form "
                             f"--key.subkey=value")
        key, _, raw = item.partition("=")
        _set_dotted(cfg, key.strip(), parse_value(raw), strict=strict)
    return cfg


def flatten_config(cfg: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """A nested dict as {"a.b.c": value}."""
    out: Dict[str, Any] = {}
    for k, v in cfg.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_config(v, prefix=key + "."))
        else:
            out[key] = v
    return out


def parse_prototype_shape(shape: Any) -> Tuple[int, ...]:
    """Parse a prototype_shape entry (tuple, list, or string form)."""
    if isinstance(shape, (tuple, list)):
        return tuple(int(s) for s in shape)
    if isinstance(shape, str):
        return tuple(int(s) for s in ast.literal_eval(shape))
    raise TypeError(f"Cannot parse prototype_shape from {shape!r}")


def load_config(config_path: str) -> Dict[str, Any]:
    """Load a YAML config file into a nested dict."""
    with open(config_path, "r") as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"Config at {config_path} must be a mapping")
    cfg["config_path"] = config_path
    return cfg


def updated_config(argv: Optional[Sequence[str]] = None,
                   default_config_path: Optional[str] = None
                   ) -> Dict[str, Any]:
    """The training entry point's configuration from its command line.

    ``--config_path=...`` names the YAML file; the top-level flags
    ``--run_name``, ``--save_dir``, ``--eval_only``, ``--eval_data_type``,
    ``--push_only``, ``--explain_locally``, ``--explain_globally`` and
    ``--device`` (``--device cpu`` or ``--device=cpu``; CUDA when absent)
    may be missing from the file; every other argument is a dotted
    override (``--train.batch_size=5``).
    """
    args: List[str] = list(argv if argv is not None else sys.argv[1:])
    config_path = default_config_path
    device = None
    rest: List[str] = []
    i = 0
    while i < len(args):
        item = args[i].lstrip("-")
        if item.startswith("config_path="):
            config_path = item.partition("=")[2]
        elif item == "device" and i + 1 < len(args):
            device = args[i + 1]
            i += 1
        elif item.startswith("device="):
            device = item.partition("=")[2]
        else:
            rest.append(args[i])
        i += 1
    if config_path is None:
        raise ValueError("--config_path=... is required")
    cfg = load_config(config_path)
    defaults = {
        "run_name": cfg.get("run_name", os.path.splitext(
            os.path.basename(config_path))[0]),
        "save_dir": cfg.get("save_dir", "logs"),
        "eval_only": cfg.get("eval_only", False),
        "eval_data_type": cfg.get("eval_data_type", "val"),
        "push_only": cfg.get("push_only", False),
        "explain_locally": cfg.get("explain_locally", False),
        "explain_globally": cfg.get("explain_globally", False),
    }
    for k, v in defaults.items():
        cfg.setdefault(k, v)
    cfg = apply_overrides(cfg, rest, strict=False)
    if device is not None:
        cfg["device"] = device
    return cfg


def dump_config(cfg: Dict[str, Any], path: str) -> None:
    """Write ``cfg`` as YAML through a temporary file and a rename, so a
    partial ``config_*.yml`` never appears."""
    text = yaml.safe_dump(cfg, default_flow_style=False, sort_keys=False)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
