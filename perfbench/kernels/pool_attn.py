"""Work of the pooling attention (``pool_attn_kernel``) from the
configuration's shapes, whatever computes it.

One call is one block's attention over a batch of clips, after the
pooling. Per (clip, head) of Lq queries, Lk keys and head width d: q, k and
v read once at the input's bytes ((Lq + 2·Lk)·d·in_elem: the served trunk
hands over the pooling norms' fp32 output), o written once
(Lq·d·out_elem); per call the three positional tables once (rows·d at
out_elem, the type they are read in) and the index rule's int32 entries.
Nothing of Lq×Lk size is counted: the kernel keeps the logits, the
positional terms and P in registers and never writes them.
FLOP per (clip, head): 4·Lq·Lk·d (q·kᵀ and the product with v) plus the
positional terms, 2·(Lq - 1)·(k_t + k_h + k_w)·d (each spatial query
against each axis's k side). The least time of a call is the larger of its
bytes over the card's bandwidth and its FLOP over the bf16 peak (the
kernel's products are bf16 under the configuration's dtype).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from perfbench.reference.mvit_xprotonet import schedule

__all__ = ["KERNEL", "call_of", "calls", "bytes_moved", "flops",
           "call_bound_s", "bound_s"]

KERNEL = "pool_attn_kernel"
# (Lq, Lk, heads, d, k_t + k_h + k_w, table rows, index entries)
Call = Tuple[int, int, int, int, int, int, int]


def call_of(q_thw, k_thw, heads: int, d: int) -> Call:
    """One call's shape from its pooled q and k sides."""
    return (1 + math.prod(q_thw), 1 + math.prod(k_thw), int(heads), int(d),
            sum(k_thw), sum(2 * max(q, k) - 1 for q, k in zip(q_thw, k_thw)),
            sum(q * k for q, k in zip(q_thw, k_thw)))


def calls(cfg) -> List[Call]:
    """Every block's call, in order, for the configuration's clips and
    cut."""
    return [call_of(s["q_thw"], s["kv_thw"], s["heads"], s["head_dim"])
            for s in schedule(cfg)]


def bytes_moved(pairs: int, call: Call, in_elem: int, out_elem: int) -> int:
    lq, lk, _, d, _, rows, entries = call
    return pairs * ((lq + 2 * lk) * d * in_elem + lq * d * out_elem) \
        + rows * d * out_elem + entries * 4


def flops(pairs: int, call: Call) -> int:
    lq, lk, _, d, r = call[:5]
    return pairs * (4 * lq * lk * d + 2 * (lq - 1) * r * d)


def call_bound_s(batch: int, call: Call, in_elem: int, out_elem: int,
                 peak: Dict[str, float]) -> float:
    """The least time of one call at ``batch`` clips."""
    pairs = batch * call[2]
    return max(bytes_moved(pairs, call, in_elem, out_elem)
               / peak["hbm_bytes_per_s"],
               flops(pairs, call) / peak["bf16_flops_per_s"])


def bound_s(batch: int, cfg, peak: Dict[str, float]) -> float:
    """The least time of one forward's calls at ``batch`` clips, as the
    served trunk makes them under bf16 autocast (fp32 q, k and v in, bf16
    out)."""
    return sum(call_bound_s(batch, c, 4, 2, peak) for c in calls(cfg))
