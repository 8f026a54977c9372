"""Explanation entry point of the port, the flags of the JAX package's
``explain.py``:

    python -m protoasnet_tpu_torch.explain \
        --config_path=protoasnet_tpu/configs/ours_protoasnet_video.yml \
        --save_dir=logs [--run_name=...] [--device cpu] \
        --explain_locally=true [--explain_globally=true] \
        --eval_data_type=test [--model.checkpoint_path=<ckpt>]

The run directory is ``<save_dir>/<run_name>`` of the training run; the
agent loads ``--model.checkpoint_path`` or the run's ``last.ckpt`` (the
port's own, the JAX package's flax ``.ckpt`` or a migrated reference
``.pkl``) and raises when no trained checkpoint was loaded. Local
explanations go to ``explain_<mode>/`` (with ``model_products.pickle``),
global ones (a push that does not replace the prototypes) to
``img/epoch-<e>_pushed/``; the config is dumped as
``config_explain_<mode>.yml``. CUDA unless ``--device cpu``. Under
``python -m torch.distributed.run`` the sweep and the push are
data-parallel over the cards (``parallel/mesh.py``) and rank 0 writes.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Optional, Sequence

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the command line ``argv`` (default ``sys.argv[1:]``); returns
    {"agent", "local": explain_local's summary or None}."""
    from protoasnet_tpu_torch.parallel.mesh import joined_group
    from protoasnet_tpu_torch.utils.config import updated_config
    from protoasnet_tpu_torch.utils.device import resolve_device

    config = updated_config(argv)
    # no card, no CPU request: raise
    with joined_group(resolve_device(config.get("device"))):
        return _run(config)


def _run(config: Dict[str, Any]) -> Dict[str, Any]:
    from protoasnet_tpu_torch.utils.run import open_run, set_seed

    mode = config.get("eval_data_type", "test")
    save_dir = open_run(config, f"explain_{mode}")
    set_seed(int(config["train"].get("seed", 0)))

    from protoasnet_tpu_torch.train.agents import build_agent

    agent = build_agent(config)
    if agent.current_iteration == 0 and agent.current_epoch == 0:
        raise RuntimeError(f"no trained checkpoint was loaded for {save_dir} "
                           f"(--model.checkpoint_path or last.ckpt); "
                           f"explanations of untrained weights are refused")
    if not hasattr(agent, "explain_local"):
        raise ValueError(f"agent {config['agent']!r} has no explanations "
                         f"(the XProtoNet agents have)")
    local = None
    if config.get("explain_locally", True):
        local = agent.explain_local(mode=mode)
    if config.get("explain_globally", False):
        agent.explain_global(mode=mode)
    logging.info(f"explanations written under {save_dir}")
    agent.finalize()
    return {"agent": agent, "local": local}


if __name__ == "__main__":
    main()
