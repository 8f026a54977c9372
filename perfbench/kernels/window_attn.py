"""Work of the shifted-window attention (``window_attn_kernel``) from the
configuration's shapes, whatever computes it.

One call is one block's attention over a batch of clips. Per (window,
head) of N tokens and head width d: q, k and v read once and o written once
at the input's bytes (4·N·d·elem), and 4·N²·d FLOP (q·kᵀ and the product
with v); per call the fp32 bias table once (rows·heads·4 bytes). The
least time of a call is the larger of its bytes over the card's bandwidth
and its FLOP over its peak for the inputs' type. The windows follow the
published rule: a side not larger than the window takes the side as its
window; the rest is padded to whole windows, the padding's tokens counted.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

__all__ = ["KERNEL", "calls", "bytes_moved", "flops", "bound_s"]

KERNEL = "window_attn_kernel"


def calls(cfg) -> List[Tuple[int, int, int, int, int]]:
    """(windows a clip, N, heads, d, table rows) of every block's call, in
    order, for the configuration's clips and cut."""
    patch = [int(p) for p in cfg["patch_size"]]
    window = [int(w) for w in cfg["window_size"]]
    depths = [int(d) for d in cfg["depths"]]
    stages = len(depths) + int(cfg.get("backbone_last_layer_num", -3)) + 2
    size = [-(-int(cfg["frames"]) // patch[0])] + [
        -(-int(cfg["img_size"]) // p) for p in patch[1:]]
    rows = math.prod(2 * w - 1 for w in window)
    out = []
    for i in range(stages):
        heads = int(cfg["num_heads"][i])
        d = int(cfg["embed_dim"]) * 2 ** i // heads
        win = [s if s <= w else w for s, w in zip(size, window)]
        windows = math.prod(-(-s // w) for s, w in zip(size, win))
        out += [(windows, math.prod(win), heads, d, rows)] * depths[i]
        size = [size[0], -(-size[1] // 2), -(-size[2] // 2)]
    return out


def bytes_moved(pairs: int, n: int, d: int, elem: int, rows: int,
                heads: int) -> int:
    return pairs * 4 * n * d * elem + rows * heads * 4


def flops(pairs: int, n: int, d: int) -> int:
    return pairs * 4 * n * n * d


def bound_s(batch: int, cfg, elem: int, peak: Dict[str, float]) -> float:
    """The least time of one forward's calls at ``batch`` clips."""
    rate = {2: "bf16_flops_per_s"}[elem]  # no fp32 peak in the table yet
    total = 0.0
    for windows, n, heads, d, rows in calls(cfg):
        pairs = batch * windows * heads
        total += max(bytes_moved(pairs, n, d, elem, rows, heads)
                     / peak["hbm_bytes_per_s"], flops(pairs, n, d)
                     / peak[rate])
    return total
