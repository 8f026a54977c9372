"""Multiscale Vision Transformer v2 trunk (Li et al., "MViTv2: Improved
Multiscale Vision Transformers for Classification and Detection",
arXiv:2112.01526; the block rules of torchvision's ``mvit_v2_s``),
channels-last.

(N, T, H, W, 3) -> (N, T', H', W', C'):
- patch embedding: a Conv3d (``conv_proj``; MViTv2-B: 3 -> 96, kernel
  (3, 7, 7), stride (2, 4, 4), padding (1, 3, 3)), the tokens flattened in
  (t, h, w) order and a class token put in front of them
  (``pos_encoding.class_token``; relative positions, so no absolute ones);
- blocks, each pre-LN: ``xn = LN1(x)``; qkv of ``xn`` split into heads;
  q, k and v each pooled (the class token kept out of a depthwise Conv3d
  over the head width, kernel 3, padding 1, no bias, its weights shared by
  the heads; then a LayerNorm over the head width on every row); the
  pooling attention (``ops/pool_attn.py``: logits, decomposed relative
  positions from q, softmax, ·v, q added to the spatial rows); the
  projection. The skip is x, or ``project(xn)`` where the width changes,
  max-pooled (kernel (1, 3, 3), stride (1, 2, 2), padding (0, 1, 1), the
  class token passing) where q is strided; then ``x = skip + attn`` and
  ``x = x + MLP(LN2(x))`` (Linear, exact GELU, Linear).

The schedule: the width and the heads double, and q is pooled at stride
(1, 2, 2), at the first block of stages 2-4; k and v are pooled at
``kv_stride`` divided by every q stride so far ((1, 8, 8), (1, 4, 4),
(1, 2, 2), (1, 1, 1) from stage 1 to 4); every head is ``embed_dim`` wide.
The relative-position tables are sized for the pooled sides that
``input_size`` gives (2·max(q, k) - 1 rows an axis), so the trunk takes
clips of that size only.

``last_layer_num`` cuts it as the other video trunks are cut: -3 drops
the last stage (MViTv2-B at 32x112x112: (N, 16, 7, 7, 384), the last
block's raw spatial tokens, no final norm, the class token dropped); -2
keeps every stage. The published model's final norm, head and classifier
are never part of the trunk.

Module and parameter names are the upstream ones (``conv_proj``,
``pos_encoding.class_token``, ``blocks.{i}.{norm1, attn.qkv,
attn.project.0, attn.pool_{q,k,v}.{pool, norm_act.0}, attn.rel_pos_{h,w,t},
norm2, mlp.0, mlp.3, project}``), so an upstream state_dict loads under a
prefix. Stochastic depth ("row") is active in training only, at the
published linear ramp over all blocks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from protoasnet_tpu_torch.models.backbones.swin3d import _stochastic_depth
from protoasnet_tpu_torch.ops.pool_attn import pool_attention, table_rows

__all__ = ["MVIT_SPECS", "MViT", "MultiscaleBlock", "MultiscaleAttention",
           "block_schedule"]

Size3 = Tuple[int, int, int]

# MViTv2-B (SlowFast configs/Kinetics/MVITv2_B_32x3.yaml) on this
# repository's 32x112x112 clips
MVIT_SPECS: Dict[str, Dict] = {
    "mvit_v2_b": {"embed_dim": 96, "depths": (2, 3, 16, 3), "num_heads": 1,
                  "patch_kernel": (3, 7, 7), "patch_stride": (2, 4, 4),
                  "patch_padding": (1, 3, 3), "pool_kernel": (3, 3, 3),
                  "kv_stride": (1, 8, 8), "q_stride": (1, 2, 2),
                  "mlp_ratio": 4.0, "stochastic_depth_prob": 0.3,
                  "input_size": (32, 112, 112)},
}


def _out(size: Sequence[int], kernel: Sequence[int], stride: Sequence[int],
         padding: Sequence[int]) -> Size3:
    return tuple((s + 2 * p - k) // st + 1
                 for s, k, st, p in zip(size, kernel, stride, padding))


def block_schedule(embed_dim: int, depths: Sequence[int], num_heads: int,
                   patch_kernel: Sequence[int], patch_stride: Sequence[int],
                   patch_padding: Sequence[int], pool_kernel: Sequence[int],
                   kv_stride: Sequence[int], q_stride: Sequence[int],
                   input_size: Sequence[int], stages: int, **_
                   ) -> List[Dict]:
    """Every kept block's widths, heads, strides and token sides: dicts of
    ``dim_in``, ``dim_out``, ``heads``, ``stride_q``, ``stride_kv``,
    ``thw`` (the input sides), ``q_thw`` and ``kv_thw`` (pooled)."""
    thw = _out(input_size, patch_kernel, patch_stride, patch_padding)
    pad = [k // 2 for k in pool_kernel]
    firsts = {sum(depths[:i]) for i in range(1, len(depths))}
    kv = tuple(int(s) for s in kv_stride)
    dim, heads = int(embed_dim), int(num_heads)
    out = []
    for i in range(sum(int(d) for d in depths[:stages])):
        dim_in = dim
        stride = (1, 1, 1)
        if i in firsts:
            stride = tuple(int(s) for s in q_stride)
            kv = tuple(max(a // b, 1) for a, b in zip(kv, stride))
            dim, heads = 2 * dim, 2 * heads
        q_thw = _out(thw, pool_kernel, stride, pad)
        kv_thw = _out(thw, pool_kernel, kv, pad)
        out.append({"dim_in": dim_in, "dim_out": dim, "heads": heads,
                    "stride_q": stride, "stride_kv": kv, "thw": thw,
                    "q_thw": q_thw, "kv_thw": kv_thw})
        thw = q_thw
    return out


class _PositionalEncoding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.class_token = nn.Parameter(torch.zeros(dim))


class _Pool(nn.Module):
    """A depthwise Conv3d over the head width and a LayerNorm after it
    (``pool``, ``norm_act.0``)."""

    def __init__(self, head_dim: int, kernel: Sequence[int],
                 stride: Sequence[int]):
        super().__init__()
        self.pool = nn.Conv3d(head_dim, head_dim, tuple(kernel),
                              stride=tuple(stride),
                              padding=tuple(k // 2 for k in kernel),
                              groups=head_dim, bias=False)
        self.norm_act = nn.Sequential(nn.LayerNorm(head_dim, eps=1e-6))

    def forward(self, part: torch.Tensor, thw: Size3
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L, heads, D), the class token first -> the class tokens
        (B·heads, D) and the pooled spatial tokens (B·heads, T, H, W, D),
        both normed."""
        b, _, heads, d = part.shape
        cls = part[:, 0].reshape(b * heads, d)
        # NCDHW laid out in full, whatever the heads: with one head the
        # reshape is a channels-last view, for which PyTorch sends the
        # depthwise conv to cuDNN's generic implicit GEMM (27% of the served
        # trunk's device time on an H100) instead of its depthwise kernel
        sp = part[:, 1:].unflatten(1, thw).permute(0, 4, 5, 1, 2, 3
                                                   ).reshape(b * heads, d,
                                                             *thw)
        sp = self.pool(sp.contiguous())
        # channels-last in the conv's dtype before the norm (which runs in
        # fp32 under autocast), so the transposition moves half the bytes
        sp = sp.permute(0, 2, 3, 4, 1).contiguous()
        return self.norm_act(cls), self.norm_act(sp)


class MultiscaleAttention(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, heads: int,
                 pool_kernel: Sequence[int], stride_q: Sequence[int],
                 stride_kv: Sequence[int], q_thw: Size3, kv_thw: Size3):
        super().__init__()
        self.heads = int(heads)
        self.head_dim = dim_out // self.heads
        self.qkv = nn.Linear(dim_in, 3 * dim_out)
        self.project = nn.Sequential(nn.Linear(dim_out, dim_out))
        self.pool_q = _Pool(self.head_dim, pool_kernel, stride_q)
        self.pool_k = _Pool(self.head_dim, pool_kernel, stride_kv)
        self.pool_v = _Pool(self.head_dim, pool_kernel, stride_kv)
        (qt, qh, qw), (kt, kh, kw) = q_thw, kv_thw
        self.rel_pos_h = nn.Parameter(torch.zeros(table_rows(qh, kh),
                                                  self.head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(table_rows(qw, kw),
                                                  self.head_dim))
        self.rel_pos_t = nn.Parameter(torch.zeros(table_rows(qt, kt),
                                                  self.head_dim))

    def forward(self, x: torch.Tensor, thw: Size3) -> torch.Tensor:
        b, length, _ = x.shape
        qkv = self.qkv(x).view(b, length, 3, self.heads, self.head_dim)
        q_cls, q_sp = self.pool_q(qkv[:, :, 0], thw)
        k_cls, k_sp = self.pool_k(qkv[:, :, 1], thw)
        v_cls, v_sp = self.pool_v(qkv[:, :, 2], thw)
        o = pool_attention(q_cls, q_sp, k_cls, k_sp, v_cls, v_sp,
                           self.rel_pos_t, self.rel_pos_h, self.rel_pos_w,
                           self.heads)
        return self.project(o)


class MultiscaleBlock(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, heads: int,
                 pool_kernel: Sequence[int], stride_q: Sequence[int],
                 stride_kv: Sequence[int], thw: Size3, q_thw: Size3,
                 kv_thw: Size3, mlp_ratio: float = 4.0,
                 stochastic_depth_prob: float = 0.0):
        super().__init__()
        self.thw = tuple(thw)
        self.norm1 = nn.LayerNorm(dim_in, eps=1e-6)
        self.attn = MultiscaleAttention(dim_in, dim_out, heads, pool_kernel,
                                        stride_q, stride_kv, q_thw, kv_thw)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        hidden = int(dim_out * mlp_ratio)
        # indices as the published MLP (Linear, GELU, Dropout, Linear,
        # Dropout), its dropouts 0
        self.mlp = nn.Sequential(nn.Linear(dim_out, hidden), nn.GELU(),
                                 nn.Identity(), nn.Linear(hidden, dim_out),
                                 nn.Identity())
        self.project = (nn.Linear(dim_in, dim_out) if dim_in != dim_out
                        else None)
        self.skip_stride = tuple(int(s) for s in stride_q)
        self.stochastic_depth_prob = float(stochastic_depth_prob)

    def _pool_skip(self, x: torch.Tensor) -> torch.Tensor:
        if math.prod(self.skip_stride) == 1:
            return x
        b, _, c = x.shape
        kernel = [s + 1 if s > 1 else s for s in self.skip_stride]
        sp = x[:, 1:].reshape(b, *self.thw, c).permute(0, 4, 1, 2, 3)
        sp = F.max_pool3d(sp, kernel, self.skip_stride,
                          [k // 2 for k in kernel])
        return torch.cat([x[:, :1], sp.flatten(2).transpose(1, 2)], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.stochastic_depth_prob
        xn = self.norm1(x)
        attn = self.attn(xn, self.thw)
        skip = self._pool_skip(x if self.project is None
                               else self.project(xn))
        x = skip + _stochastic_depth(attn, p, self.training)
        return x + _stochastic_depth(self.mlp(self.norm2(x)), p,
                                     self.training)


class MViT(nn.Module):
    """Truncatable MViTv2 trunk, channels-last in and out."""

    channels_last = True  # XProtoNet hands it (N, T, H, W, 3) as it is

    def __init__(self, embed_dim: int, depths: Sequence[int],
                 num_heads: int, patch_kernel: Sequence[int],
                 patch_stride: Sequence[int], patch_padding: Sequence[int],
                 pool_kernel: Sequence[int], kv_stride: Sequence[int],
                 q_stride: Sequence[int], input_size: Sequence[int],
                 mlp_ratio: float = 4.0, stochastic_depth_prob: float = 0.3,
                 last_layer_num: int = -3):
        super().__init__()
        if last_layer_num not in (-3, -2):
            raise ValueError(f"an MViT trunk is cut at -3 (without its last "
                             f"stage) or -2 (whole), not {last_layer_num}")
        self.input_size = tuple(int(s) for s in input_size)
        sched = block_schedule(embed_dim, depths, num_heads, patch_kernel,
                               patch_stride, patch_padding, pool_kernel,
                               kv_stride, q_stride, input_size,
                               len(depths) + last_layer_num + 2)
        self.conv_proj = nn.Conv3d(3, int(embed_dim), tuple(patch_kernel),
                                   stride=tuple(patch_stride),
                                   padding=tuple(patch_padding))
        self.pos_encoding = _PositionalEncoding(int(embed_dim))
        total = sum(int(d) for d in depths)
        self.blocks = nn.ModuleList(
            MultiscaleBlock(s["dim_in"], s["dim_out"], s["heads"],
                            pool_kernel, s["stride_q"], s["stride_kv"],
                            s["thw"], s["q_thw"], s["kv_thw"], mlp_ratio,
                            stochastic_depth_prob * i / max(1, total - 1))
            for i, s in enumerate(sched))
        self.out_thw = sched[-1]["q_thw"]
        self.out_channels = sched[-1]["dim_out"]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """torchvision's init from ``generator`` (a CPU generator): every
        Linear, relative-position table and the class token trunc-normal
        (std 0.02, cut at ±2), Linear biases 0, LayerNorm 1 and 0; the
        convolutions as ``nn.Conv3d`` draws them."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, (MultiscaleAttention, _PositionalEncoding)):
                for p in m.parameters(recurse=False):
                    nn.init.trunc_normal_(p, std=0.02, generator=generator)
            elif isinstance(m, nn.Conv3d):
                bound = 1.0 / m.weight[0].numel() ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[1:4]) != self.input_size:
            raise ValueError(f"this MViT trunk's positional tables are sized "
                             f"for clips of {self.input_size}, not "
                             f"{tuple(x.shape[1:4])}")
        x = self.conv_proj(x.permute(0, 4, 1, 2, 3))
        b, c = x.shape[:2]
        x = torch.cat([self.pos_encoding.class_token.to(x.dtype).expand(
            b, 1, c), x.flatten(2).transpose(1, 2)], 1)
        for block in self.blocks:
            x = block(x)
        return x[:, 1:].reshape(b, *self.out_thw, self.out_channels)
