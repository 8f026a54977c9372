"""Agent registry: the configs' ``agent:`` names -> agent classes, the five
names of the JAX package's registry."""

from typing import Any, Dict

from protoasnet_tpu_torch.train.agents.protopnet import (ProtoPNetE2EAgent,
                                                        ProtoPNetStagedAgent)
from protoasnet_tpu_torch.train.agents.xprotonet import (XProtoNetE2EAgent,
                                                        XProtoNetStagedAgent)

__all__ = ["AGENTS", "build_agent"]

AGENTS = {
    "Video_XProtoNet_e2e": XProtoNetE2EAgent,
    "XProtoNet_e2e": XProtoNetE2EAgent,
    "XProtoNet_Base": XProtoNetStagedAgent,
    "ProtoPNet_Base": ProtoPNetStagedAgent,
    "ProtoPNet_e2e": ProtoPNetE2EAgent,
}


def build_agent(config: Dict[str, Any]):
    name = config["agent"]
    if name not in AGENTS:
        raise ValueError(f"Unknown agent {name!r}; options: "
                         f"{sorted(AGENTS)}")
    return AGENTS[name](config)
