"""Device selection for the port's entry points.

CUDA is the default. The CPU is used only when the caller asks for it
(``device="cpu"``), as the tests do; without a card and without that
request the entry points raise instead of carrying on on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; this entry point runs on an NVIDIA GPU "
            "unless the caller passes device='cpu' (--device cpu)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
