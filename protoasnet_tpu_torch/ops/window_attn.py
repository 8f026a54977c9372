"""Shifted-window 3-D attention with a relative-position bias (Video Swin).

For a volume of per-token ``qkv`` (B, T, H, W, 3C), whose sides are
multiples of the window (Wt, Wh, Ww), every window of N = Wt·Wh·Ww tokens
of the volume rolled by ``-shift`` attends within itself, head by head:

    o = softmax(q·kᵀ·d^-1/2 + B + M)·v

- B, the relative-position bias: ``table[index[i, j], head]``, ``table``
  of (2·Vt-1)(2·Vh-1)(2·Vw-1) rows for the module's window (Vt, Vh, Vw),
  ``index`` its pairwise relative-position index (``relative_position_
  index``). Where the window was cut to the input (a side not larger than
  the window), the bias is read as ``index[:N, :N]``, as the published code
  reads it;
- M, the shifted windows' region mask: -100 between two tokens that came
  from different regions of the rolled volume, 0 otherwise (only where some
  shift is not 0).

The output is rolled back, so it lies where its token lay: (B, T, H, W, C).
The per-token products (qkv before, the projection after) commute with the
roll and the window partition, so they stay outside.

``window_attention`` sends a CUDA volume to the fused kernel
(``ops/window_attn_cuda.py``, ``csrc/window_attn.cu``: the bias gathered and
the mask computed inside it, no (windows, heads, N, N) tensor in memory;
under autograd its Function recomputes this module's route for the
gradient, a few clips at a time) and counts ``swin.window_attn`` on the
innermost span open; a volume off the card runs ``window_attention_torch``,
the published route in torch ops, and counts ``swin.window_attn.plain``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from protoasnet_tpu_torch.utils.profiling import count

__all__ = ["MASK_VALUE", "window_and_shift", "relative_position_index",
           "region_labels", "shift_mask", "window_attention_torch",
           "window_attention_backward", "window_attention"]

MASK_VALUE = -100.0
BACKWARD_BYTES = 1 << 30  # the backward's logits, P and their gradient
Size3 = Tuple[int, int, int]


def window_and_shift(size: Sequence[int], window: Sequence[int],
                     shift: Sequence[int]) -> Tuple[Size3, Size3]:
    """The window and shift a volume of ``size`` takes: where a side is not
    larger than the window, the window is the side and its shift 0."""
    win = tuple(int(s) if int(s) <= int(w) else int(w)
                for w, s in zip(window, size))
    sh = tuple(0 if int(s) <= int(w) else int(h)
               for w, s, h in zip(window, size, shift))
    return win, sh


def relative_position_index(window: Sequence[int],
                            device=None) -> torch.Tensor:
    """(N, N) int64: the table row of each (query, key) pair of a window."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(int(w), device=device) for w in window],
        indexing="ij")).flatten(1)  # (3, N)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    wt, wh, ww = (int(w) for w in window)
    rel = rel + torch.tensor([wt - 1, wh - 1, ww - 1], device=device)
    return (rel * torch.tensor([(2 * wh - 1) * (2 * ww - 1), 2 * ww - 1, 1],
                               device=device)).sum(-1)


def region_labels(size: Sequence[int], window: Sequence[int],
                  shift: Sequence[int], device=None) -> torch.Tensor:
    """(T, H, W) int64: the region of each position of the rolled volume,
    each side cut at -window and -shift (a side whose shift is 0 is one
    region)."""
    labels = []
    for s, w, h in zip(size, window, shift):
        p = torch.arange(int(s), device=device)
        labels.append(((p >= s - w).long() + (p >= s - h).long())
                      if h else torch.zeros_like(p))
    lt, lh, lw = labels
    return lt[:, None, None] * 9 + lh[None, :, None] * 3 + lw[None, None, :]


def _partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """(B, T, H, W, ...) -> (B·windows, N, ...), windows in (t, h, w)
    order, tokens in (t, h, w) order within a window."""
    b, t, h, w = x.shape[:4]
    wt, wh, ww = window
    rest = x.shape[4:]
    x = x.reshape(b, t // wt, wt, h // wh, wh, w // ww, ww, *rest)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, *range(7, 7 + len(rest)))
    return x.reshape(-1, wt * wh * ww, *rest)


def _merge(x: torch.Tensor, b: int, size: Sequence[int],
           window: Sequence[int]) -> torch.Tensor:
    """The inverse of ``_partition``: (B·windows, N, C) -> (B, T, H, W, C)."""
    t, h, w = size
    wt, wh, ww = window
    c = x.shape[-1]
    x = x.reshape(b, t // wt, h // wh, w // ww, wt, wh, ww, c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, t, h, w, c)


def shift_mask(size: Sequence[int], window: Sequence[int],
               shift: Sequence[int], device=None,
               dtype=torch.float32) -> torch.Tensor:
    """(windows, N, N): ``MASK_VALUE`` between tokens of different regions
    of the rolled volume, 0 within one."""
    lab = _partition(region_labels(size, window, shift, device)[None],
                     window)  # (windows, N)
    diff = lab[:, None, :] != lab[:, :, None]
    return torch.zeros(diff.shape, dtype=dtype, device=device).masked_fill(
        diff, MASK_VALUE)


def window_attention_torch(qkv: torch.Tensor, table: torch.Tensor,
                           index: torch.Tensor, num_heads: int,
                           window: Sequence[int], shift: Sequence[int]
                           ) -> torch.Tensor:
    """The published route: roll, partition, q scaled by d^-1/2, q·kᵀ, +
    bias, + mask, softmax, ·v, merge, roll back. ``index`` is the module
    window's (full) relative-position index."""
    b, t, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // num_heads
    size = (t, h, w)
    shifted = any(shift)
    if shifted:
        qkv = torch.roll(qkv, shifts=[-s for s in shift], dims=(1, 2, 3))
    x = _partition(qkv, window)  # (B·windows, N, 3C)
    bw, n = x.shape[:2]
    x = x.reshape(bw, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = x[0] * hd ** -0.5, x[1], x[2]
    bias = table[index[:n, :n].reshape(-1)].reshape(n, n, num_heads
                                                   ).permute(2, 0, 1)
    attn = q @ k.transpose(-2, -1) + bias
    if shifted:
        mask = shift_mask(size, window, shift, qkv.device)
        attn = (attn.reshape(b, -1, num_heads, n, n) + mask[:, None]
                ).reshape(bw, num_heads, n, n)
    o = F.softmax(attn, dim=-1) @ v
    o = _merge(o.transpose(1, 2).reshape(bw, n, c), b, size, window)
    if shifted:
        o = torch.roll(o, shifts=list(shift), dims=(1, 2, 3))
    return o


def window_attention_backward(qkv: torch.Tensor, table: torch.Tensor,
                              index: torch.Tensor, num_heads: int,
                              window: Sequence[int], shift: Sequence[int],
                              grad: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients at qkv and the table of ``window_attention_torch``
    against ``grad``, recomputed in fp32 under autograd, in runs of clips
    whose logits take at most about ``BACKWARD_BYTES`` (one clip at
    least); in qkv's and the table's dtypes."""
    b, t, h, w, _ = qkv.shape
    n = math.prod(window)
    windows = math.prod(s // x for s, x in zip((t, h, w), window))
    per_clip = 3 * windows * num_heads * n * n * 4  # logits, P, their grad
    step = max(1, BACKWARD_BYTES // per_clip)
    g_qkv = torch.empty_like(qkv)
    g_table = torch.zeros(table.shape, dtype=torch.float32,
                          device=table.device)
    with torch.enable_grad(), torch.autocast(qkv.device.type, enabled=False):
        for s in range(0, b, step):
            x = qkv[s:s + step].detach().float().requires_grad_(True)
            tb = table.detach().float().requires_grad_(True)
            o = window_attention_torch(x, tb, index, num_heads, window, shift)
            gx, gt = torch.autograd.grad(o, (x, tb),
                                         grad[s:s + step].float())
            g_qkv[s:s + step] = gx.to(qkv.dtype)
            g_table += gt
    return g_qkv, g_table.to(table.dtype)


def window_attention(qkv: torch.Tensor, table: torch.Tensor,
                     index: torch.Tensor, num_heads: int,
                     window: Sequence[int], shift: Sequence[int],
                     table_window: Sequence[int]) -> torch.Tensor:
    """(B, T, H, W, 3C) -> (B, T, H, W, C), sides multiples of ``window``:
    the fused kernel for a CUDA volume (with or without grad; it raises on
    what it does not take), else the plain route."""
    if qkv.is_cuda:
        from protoasnet_tpu_torch.ops.window_attn_cuda import \
            window_attn_cuda

        count("swin.window_attn")
        return window_attn_cuda(qkv, table, index, num_heads, window, shift,
                                table_window)
    count("swin.window_attn.plain")
    return window_attention_torch(qkv, table, index, num_heads, window,
                                  shift)
