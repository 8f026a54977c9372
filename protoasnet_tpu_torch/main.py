"""Train / evaluate / push entry point of the port.

    python -m protoasnet_tpu_torch.main \
        --config_path=protoasnet_tpu/configs/ours_protoasnet_video.yml \
        --save_dir=logs [--run_name=...] [--device cpu] \
        [--eval_only=true --eval_data_type=test] [--push_only=true] \
        [--model.checkpoint_path=...] [--any.nested.key=value]

The flags of the JAX package's ``main.py``. It runs on CUDA unless
``--device cpu`` is given, and raises when there is no card and no such
request. The run directory is ``<save_dir>/<run_name>`` (reused, and the
run resumed, when it holds a checkpoint).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None):
    """Run the command line ``argv`` (default ``sys.argv[1:]``); returns
    the agent."""
    from protoasnet_tpu_torch.utils.config import dump_config, updated_config
    from protoasnet_tpu_torch.utils.device import resolve_device
    from protoasnet_tpu_torch.utils.run import (backup_code, create_save_loc,
                                                set_logger, set_seed)

    config = updated_config(argv)
    resolve_device(config.get("device"))  # no card, no CPU request: raise
    create_save_loc(config)
    save_dir = config["save_dir"]
    run_type = "train"
    if config.get("eval_only"):
        run_type = f"eval_{config.get('eval_data_type', 'val')}"
    elif config.get("push_only"):
        run_type = "push"
    set_logger(save_dir, config.get("log_level", "info"), run_type)
    dump_config(config, f"{save_dir}/config_{run_type}.yml")
    set_seed(int(config["train"].get("seed", 0)))
    if run_type == "train":
        backup_code(save_dir)

    from protoasnet_tpu_torch.train.agents import build_agent

    agent = build_agent(config)
    if config.get("eval_only"):
        agent.evaluate(mode=config.get("eval_data_type", "val"))
    elif config.get("push_only"):
        agent.push(replace_prototypes=False)
    else:
        agent.run()
        logging.info("evaluating the final model on val")
        agent.evaluate(mode="val")
    agent.finalize()
    return agent


if __name__ == "__main__":
    main()
