"""Pooling attention with decomposed relative positions and residual
pooling (MViTv2, Li et al., arXiv:2112.01526; torchvision's
``MultiscaleAttention``), after the pooling.

A block's q, k and v come pooled and normed, each as its class token
``*_cls`` (N, D) and its spatial tokens ``*_sp`` (N, T, H, W, D), N =
clips·heads (a clip's heads in a row), D the head width. With q and k the
class token followed by the spatial tokens in (t, h, w) order, per head:

    A = (q·d^-1/2)·kᵀ
    A[1:, 1:] += q·R_t[t_q, t_k] + q·R_h[h_q, h_k] + q·R_w[w_q, w_k]
    o = softmax(A)·v;  o[1:] += q[1:]

- the positional terms use q unscaled and leave the class token's row and
  column out; R_a = table_a[idx_a], ``rel_index``'s rule per axis, each
  table of 2·max(q_a, k_a) - 1 rows for the block's pooled sizes;
- the residual pooling adds q to the spatial rows only.

The output is (clips, 1 + T·H·W, heads·D), the class token first and the
heads side by side, as the block's projection takes it.

``pool_attention`` sends CUDA tensors to the fused kernel
(``ops/pool_attn_cuda.py``, ``csrc/pool_attn.cu``: the positional terms
computed inside it, no Lq×Lk tensor in memory; under autograd its Function
recomputes this module's route for the gradient, a few clips at a time)
and counts ``mvit.pool_attn`` on the innermost span open; tensors off the
card run ``pool_attention_torch``, the published route in torch ops, and
count ``mvit.pool_attn.plain``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from protoasnet_tpu_torch.utils.profiling import count

__all__ = ["rel_index", "table_rows", "decomposed_rel_pos",
           "pool_attention_torch", "pool_attention_backward",
           "pool_attention"]

BACKWARD_BYTES = 1 << 30  # the backward's logits, P and their gradient


def rel_index(q: int, k: int, device=None) -> torch.Tensor:
    """(q, k) int64: the table row of each (query, key) pair of one axis,
    ``i·max(k/q, 1) - j·max(q/k, 1) + (k - 1)·max(q/k, 1)`` truncated, in
    float32 as the published code computes it."""
    q_ratio, k_ratio = max(k / q, 1.0), max(q / k, 1.0)
    i = torch.arange(q, device=device, dtype=torch.float32)[:, None]
    j = torch.arange(k, device=device, dtype=torch.float32)[None, :]
    return (i * q_ratio - (j + (1.0 - k)) * k_ratio).long()


def table_rows(q: int, k: int) -> int:
    """Rows of an axis's table for pooled sizes q (queries) and k (keys)."""
    return 2 * max(int(q), int(k)) - 1


def decomposed_rel_pos(q_sp: torch.Tensor, k_size: Sequence[int],
                       rel_t: torch.Tensor, rel_h: torch.Tensor,
                       rel_w: torch.Tensor) -> torch.Tensor:
    """(N, Sq, Sk): the positional terms between the spatial tokens."""
    n, qt, qh, qw, d = q_sp.shape
    kt, kh, kw = (int(s) for s in k_size)
    dev = q_sp.device
    r_t = torch.einsum("nthwc,tkc->nthwk", q_sp, rel_t[rel_index(qt, kt,
                                                                 dev)])
    r_h = torch.einsum("nthwc,hkc->nthwk", q_sp, rel_h[rel_index(qh, kh,
                                                                 dev)])
    r_w = torch.einsum("nthwc,wkc->nthwk", q_sp, rel_w[rel_index(qw, kw,
                                                                 dev)])
    rel = (r_t[..., :, None, None] + r_h[..., None, :, None]
           + r_w[..., None, None, :])
    return rel.reshape(n, qt * qh * qw, kt * kh * kw)


def _tokens(cls: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
    return torch.cat([cls[:, None], sp.reshape(sp.shape[0], -1,
                                               sp.shape[-1])], 1)


def pool_attention_torch(q_cls: torch.Tensor, q_sp: torch.Tensor,
                         k_cls: torch.Tensor, k_sp: torch.Tensor,
                         v_cls: torch.Tensor, v_sp: torch.Tensor,
                         rel_t: torch.Tensor, rel_h: torch.Tensor,
                         rel_w: torch.Tensor, heads: int) -> torch.Tensor:
    """The published route: the class tokens put back, (q·d^-1/2)·kᵀ, +
    the positional terms on the spatial rows and columns, softmax, ·v, +
    q on the spatial rows, the heads side by side."""
    n, d = q_cls.shape
    q, k, v = _tokens(q_cls, q_sp), _tokens(k_cls, k_sp), _tokens(v_cls,
                                                                 v_sp)
    attn = (q * d ** -0.5) @ k.transpose(1, 2)
    rel = decomposed_rel_pos(q_sp, k_sp.shape[1:4], rel_t, rel_h, rel_w)
    attn = attn + F.pad(rel.to(attn.dtype), (1, 0, 1, 0))
    o = F.softmax(attn, dim=-1) @ v
    o = o + F.pad(q[:, 1:], (0, 0, 1, 0)).to(o.dtype)
    lq = o.shape[1]
    return o.reshape(n // heads, heads, lq, d).transpose(1, 2).reshape(
        n // heads, lq, heads * d)


def pool_attention_backward(inputs: Sequence[torch.Tensor], heads: int,
                            grad: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gradients at ``inputs`` (q_cls, q_sp, k_cls, k_sp, v_cls, v_sp,
    rel_t, rel_h, rel_w) of ``pool_attention_torch`` against ``grad``,
    recomputed in fp32 under autograd, in runs of clips whose logits take
    at most about ``BACKWARD_BYTES`` (one clip at least); in the inputs'
    dtypes."""
    toks, tables = inputs[:6], inputs[6:]
    n = toks[0].shape[0]
    clips = n // heads
    lq = 1 + toks[1][0].numel() // toks[1].shape[-1]
    lk = 1 + toks[3][0].numel() // toks[3].shape[-1]
    per_clip = 3 * heads * lq * lk * 4  # logits, P, their gradient
    step = max(1, BACKWARD_BYTES // per_clip)
    g_toks = [torch.empty_like(t) for t in toks]
    g_tab = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
             for t in tables]
    with torch.enable_grad(), torch.autocast(grad.device.type,
                                             enabled=False):
        for s in range(0, clips, step):
            rows = slice(s * heads, min(clips, s + step) * heads)
            xs = [t[rows].detach().float().requires_grad_(True)
                  for t in toks]
            tb = [t.detach().float().requires_grad_(True) for t in tables]
            o = pool_attention_torch(*xs, *tb, heads)
            gs = torch.autograd.grad(o, xs + tb,
                                     grad[s:s + step].float())
            for g_out, g in zip(g_toks, gs[:6]):
                g_out[rows] = g.to(g_out.dtype)
            for acc, g in zip(g_tab, gs[6:]):
                acc += g
    return tuple(g_toks) + tuple(g.to(t.dtype) for g, t in zip(g_tab,
                                                               tables))


def pool_attention(q_cls: torch.Tensor, q_sp: torch.Tensor,
                   k_cls: torch.Tensor, k_sp: torch.Tensor,
                   v_cls: torch.Tensor, v_sp: torch.Tensor,
                   rel_t: torch.Tensor, rel_h: torch.Tensor,
                   rel_w: torch.Tensor, heads: int) -> torch.Tensor:
    """-> (clips, 1 + T·H·W, heads·D): the fused kernel for CUDA tensors
    (with or without grad; it raises on what it does not take), else the
    plain route."""
    if q_sp.is_cuda:
        from protoasnet_tpu_torch.ops.pool_attn_cuda import pool_attn_cuda

        out = pool_attn_cuda(q_cls, q_sp, k_cls, k_sp, v_cls, v_sp, rel_t,
                             rel_h, rel_w, heads)
        count("mvit.pool_attn")
        return out
    count("mvit.pool_attn.plain")
    return pool_attention_torch(q_cls, q_sp, k_cls, k_sp, v_cls, v_sp,
                                rel_t, rel_h, rel_w, heads)
