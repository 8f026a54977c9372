"""Video Swin Transformer trunk (Liu et al., "Video Swin Transformer",
arXiv:2106.13230; torchvision's ``swin3d_*``), channels-last.

(N, T, H, W, 3) -> (N, T', H', W', C'):
- patch embedding: a Conv3d with kernel = stride = the patch (2, 4, 4),
  computed as the Linear over each patch it is (``patch_embed.proj``, its
  weight kept in the Conv3d's shape), then LayerNorm;
- stages of blocks, each pre-LN: x + attention(LN(x)), then x +
  MLP(LN(x)) (Linear, exact GELU, Linear); the attention runs in windows
  (``ops/window_attn.py``), every odd block of a stage on the volume
  rolled by half the window, with the relative-position bias of its table;
- patch merging between stages: the 2×2 spatial neighbours concatenated
  (x0 = [0::2, 0::2], x1 = [1::2, 0::2], x2 = [0::2, 1::2], x3 = [1::2,
  1::2]), LayerNorm over 4C, Linear 4C -> 2C without bias.

``last_layer_num`` cuts it as the R(2+1)D trunk is cut: -3 drops the last
stage and its merge (Swin-B: (N, T/2, H/16, W/16, 512), the last block's
raw output, no final norm); -2 keeps every stage. The pool, final norm and
classifier of the published model are never part of the trunk.

Module and parameter names are the upstream ones (``patch_embed``,
``features.{2i}.{j}.{norm1, attn.qkv, attn.proj, attn.relative_position_
bias_table, norm2, mlp.0, mlp.3}``, ``features.{2i+1}.{norm, reduction}``),
so an upstream state_dict loads under a prefix. ``relative_position_index``
is made from the window and kept out of the state_dict. Stochastic depth
("row": whole samples of a branch dropped, the rest scaled) is active in
training only, at the published linear ramp over all blocks.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from protoasnet_tpu_torch.ops.window_attn import (relative_position_index,
                                                  window_and_shift,
                                                  window_attention)

__all__ = ["SWIN3D_SPECS", "SwinTransformer3d", "SwinBlock3d",
           "ShiftedWindowAttention3d", "PatchMerging", "PatchEmbed3d"]

# torchvision's swin3d_b (the published Swin-B of arXiv:2106.13230)
SWIN3D_SPECS: Dict[str, Dict] = {
    "swin3d_b": {"patch_size": (2, 4, 4), "embed_dim": 128,
                 "depths": (2, 2, 18, 2), "num_heads": (4, 8, 16, 32),
                 "window_size": (8, 7, 7), "mlp_ratio": 4.0,
                 "stochastic_depth_prob": 0.1},
}


def _stochastic_depth(x: torch.Tensor, p: float, training: bool
                      ) -> torch.Tensor:
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    noise = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1), dtype=x.dtype,
                        device=x.device).bernoulli_(keep)
    return x * noise.div_(keep)


class PatchEmbed3d(nn.Module):
    def __init__(self, patch_size: Sequence[int], embed_dim: int,
                 in_channels: int = 3):
        super().__init__()
        self.patch_size = tuple(int(p) for p in patch_size)
        self.proj = nn.Conv3d(in_channels, embed_dim, self.patch_size,
                              stride=self.patch_size)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, h, w, c = x.shape
        pt, ph, pw = self.patch_size
        pad = ((-t) % pt, (-h) % ph, (-w) % pw)
        if any(pad):
            x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        t, h, w = t + pad[0], h + pad[1], w + pad[2]
        # each patch flattened in the conv weight's (c, kt, kh, kw) order
        x = x.reshape(n, t // pt, pt, h // ph, ph, w // pw, pw, c)
        x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(
            n, t // pt, h // ph, w // pw, c * pt * ph * pw)
        weight = self.proj.weight
        x = F.linear(x, weight.reshape(weight.shape[0], -1), self.proj.bias)
        return self.norm(x)


class ShiftedWindowAttention3d(nn.Module):
    def __init__(self, dim: int, window_size: Sequence[int],
                 shift_size: Sequence[int], num_heads: int):
        super().__init__()
        self.window_size = tuple(int(w) for w in window_size)
        self.shift_size = tuple(int(s) for s in shift_size)
        self.num_heads = int(num_heads)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        wt, wh, ww = self.window_size
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1), self.num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(self.window_size),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, t, h, w, _ = x.shape
        window, shift = window_and_shift((t, h, w), self.window_size,
                                         self.shift_size)
        pad = tuple((-s) % k for s, k in zip((t, h, w), window))
        if any(pad):  # zeros after the norm, as the published code pads
            x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        o = window_attention(self.qkv(x), self.relative_position_bias_table,
                             self.relative_position_index, self.num_heads,
                             window, shift, self.window_size)
        if any(pad):
            o = o[:, :t, :h, :w]
        return self.proj(o)


class SwinBlock3d(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int],
                 shift_size: Sequence[int], mlp_ratio: float = 4.0,
                 stochastic_depth_prob: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = ShiftedWindowAttention3d(dim, window_size, shift_size,
                                             num_heads)
        self.norm2 = nn.LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        # indices as the published MLP (Linear, GELU, Dropout, Linear,
        # Dropout), its dropouts 0
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Identity(), nn.Linear(hidden, dim),
                                 nn.Identity())
        self.stochastic_depth_prob = float(stochastic_depth_prob)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.stochastic_depth_prob
        x = x + _stochastic_depth(self.attn(self.norm1(x)), p, self.training)
        return x + _stochastic_depth(self.mlp(self.norm2(x)), p,
                                     self.training)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-3:-1]
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[..., 0::2, 0::2, :], x[..., 1::2, 0::2, :],
                       x[..., 0::2, 1::2, :], x[..., 1::2, 1::2, :]], -1)
        return self.reduction(self.norm(x))


class SwinTransformer3d(nn.Module):
    """Truncatable Video Swin trunk, channels-last in and out."""

    channels_last = True  # XProtoNet hands it (N, T, H, W, 3) as it is

    def __init__(self, patch_size: Sequence[int], embed_dim: int,
                 depths: Sequence[int], num_heads: Sequence[int],
                 window_size: Sequence[int], mlp_ratio: float = 4.0,
                 stochastic_depth_prob: float = 0.1,
                 last_layer_num: int = -3):
        super().__init__()
        if last_layer_num not in (-3, -2):
            raise ValueError(f"a Swin3D trunk is cut at -3 (without its last "
                             f"stage) or -2 (whole), not {last_layer_num}")
        stages = len(depths) + last_layer_num + 2
        window_size = tuple(int(w) for w in window_size)
        self.out_channels = int(embed_dim) * 2 ** (stages - 1)
        self.patch_embed = PatchEmbed3d(patch_size, embed_dim)
        total = sum(int(d) for d in depths)
        layers = []
        block = 0
        for i in range(stages):
            dim = int(embed_dim) * 2 ** i
            blocks = []
            for j in range(int(depths[i])):
                shift = [0 if j % 2 == 0 else w // 2 for w in window_size]
                blocks.append(SwinBlock3d(
                    dim, int(num_heads[i]), window_size, shift,
                    mlp_ratio, stochastic_depth_prob * block / max(1, total
                                                                     - 1)))
                block += 1
            layers.append(nn.Sequential(*blocks))
            if i < stages - 1:
                layers.append(PatchMerging(dim))
        self.features = nn.Sequential(*layers)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """torchvision's init from ``generator`` (a CPU generator): every
        Linear and bias table trunc-normal (std 0.02, cut at ±2), Linear
        biases 0, LayerNorm 1 and 0; the patch embedding's conv as
        ``nn.Conv3d`` draws it."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, ShiftedWindowAttention3d):
                nn.init.trunc_normal_(m.relative_position_bias_table,
                                      std=0.02, generator=generator)
            elif isinstance(m, nn.Conv3d):
                bound = 1.0 / m.weight[0].numel() ** 0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(self.patch_embed(x))

