"""Config loading: YAML files + dotted overrides (``--a.b.c=value``).

The port's own copy of the JAX package's loader, limited to what the
serving path needs. Values are parsed with ``yaml.safe_load`` /
``ast.literal_eval``, never ``eval``; unknown override keys raise.
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, Iterable, Tuple

import yaml

__all__ = ["load_config", "parse_value", "apply_overrides",
           "parse_prototype_shape"]


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


def _set_dotted(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            raise KeyError(f"Unknown config section {p!r} in override "
                           f"--{dotted}")
        node = node[p]
    if parts[-1] not in node:
        raise KeyError(f"Unknown config key {parts[-1]!r} in override "
                       f"--{dotted}")
    node[parts[-1]] = value


def apply_overrides(cfg: Dict[str, Any], overrides: Iterable[str]
                    ) -> Dict[str, Any]:
    """Apply ``--a.b.c=value`` / ``a.b.c=value`` strings to a copy of cfg;
    a key that the config does not have raises."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        item = ov.lstrip("-")
        if "=" not in item:
            raise ValueError(f"Override {ov!r} must have the form "
                             f"--key.subkey=value")
        key, _, raw = item.partition("=")
        _set_dotted(cfg, key.strip(), parse_value(raw))
    return cfg


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
