"""Agent registry: the configs' ``agent:`` names -> agent classes.

Ported so far: the end-to-end XProtoNet agent, under both of its names.
The staged agents (``XProtoNet_Base``, ``ProtoPNet_Base``,
``ProtoPNet_e2e``) are still to port (ROADMAP.md) and raise.
"""

from typing import Any, Dict

from protoasnet_tpu_torch.train.agents.xprotonet import XProtoNetE2EAgent

__all__ = ["AGENTS", "build_agent"]

AGENTS = {
    "Video_XProtoNet_e2e": XProtoNetE2EAgent,
    "XProtoNet_e2e": XProtoNetE2EAgent,
}
_NOT_PORTED = ("XProtoNet_Base", "ProtoPNet_Base", "ProtoPNet_e2e")


def build_agent(config: Dict[str, Any]):
    name = config["agent"]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"agent {name!r} is not ported yet; see "
                                  f"ROADMAP.md")
    if name not in AGENTS:
        raise ValueError(f"Unknown agent {name!r}; options: "
                         f"{sorted(AGENTS)}")
    return AGENTS[name](config)
