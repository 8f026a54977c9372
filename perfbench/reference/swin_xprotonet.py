"""Plain PyTorch reference of ProtoASNet's Video_XProtoNet on a Video Swin
trunk (Liu et al., "Video Swin Transformer", arXiv:2106.13230; the model
torchvision builds as ``swin3d_b``).

The benchmark's yardstick for the served logits of the configuration
``protoasnet_video_swin3d_b``. Float32 functional torch over a state_dict
in the upstream naming, with TF32 off for matmuls and cuDNN while it runs;
it imports nothing of the program. The trunk follows the published
forward, cut after stage 3 (``backbone_last_layer_num: -3``), widths from
the configuration's own keys (``patch_size``, ``embed_dim``, ``depths``,
``num_heads``, ``window_size``, ``mlp_ratio``):

- patch embedding: the input padded to whole patches, a Conv3d with kernel
  = stride = the patch (``cnn_backbone.patch_embed.proj``), channels-last,
  LayerNorm (``patch_embed.norm``);
- each block j of stage i (``cnn_backbone.features.{2i}.{j}``): x + attn(
  LN(x)), then x + Linear(GELU(Linear(LN(x)))) (``mlp.0``, ``mlp.3``, the
  exact erf GELU). The attention: the volume padded with zeros to whole
  windows, rolled by -shift in odd blocks (half the window), partitioned
  into windows, qkv (``attn.qkv``), q scaled by d^-1/2, q·kᵀ, + the bias
  ``attn.relative_position_bias_table[index[:N, :N]]``, + the -100 region
  mask in shifted blocks, softmax, ·v, ``attn.proj``, windows merged, rolled
  back, the padding cut off. A side not larger than the window takes the
  side as its window and no shift;
- patch merging between stages (``features.{2i+1}``): the 2×2 spatial
  neighbours concatenated (x0 = [0::2, 0::2], x1 = [1::2, 0::2], x2 =
  [0::2, 1::2], x3 = [1::2, 1::2]), LayerNorm over 4C (``norm``), Linear
  4C -> 2C without bias (``reduction``).

The head is the flagship's (``xprotonet.py``: add-on, occurrence, ROI
cosine, readout with the abstain logit), its functions imported from there
unchanged, so the two configurations share one yardstick for the head.
Stochastic depth is a training-time regulariser and is never applied here.
The attention is computed in blocks of ``WINDOWS_PER_BLOCK`` windows, so
the check of a whole served batch fits on the card.

``make_weights`` draws every tensor from the seed. Its scales are the
benchmark's, not torchvision's initialisation (trunc-normal 0.02, which
leaves each residual branch ~1% of the stream and the bias at ~1/50 of a
logit, so a check could not see a broken attention): Linear and conv
weights N(0, 1/fan_in), so each branch adds about as much as the stream
holds; biases N(0, 0.1); LayerNorm weights U(0.75, 1.25) and shifts N(0,
0.1); the bias table N(0, 1), on the order of the attention logits.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import xprotonet as _xp
from perfbench.reference.xprotonet import (fp8_e4m3, gray_to_input,
                                           parse_shape)

__all__ = ["WINDOWS_PER_BLOCK", "widths", "param_spec", "make_weights",
           "gray_to_input", "forward", "occurrence_map", "fp8_e4m3",
           "head_shape", "serve_flops", "trunk"]

WINDOWS_PER_BLOCK = 512
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
Weights = Dict[str, torch.Tensor]
TRUNK = "cnn_backbone."


def widths(cfg) -> Dict:
    """The trunk's published widths from the configuration, and the number
    of stages the cut keeps."""
    depths = [int(d) for d in cfg["depths"]]
    cut = int(cfg.get("backbone_last_layer_num", -3))
    if cut not in (-3, -2):
        raise ValueError(f"a Swin trunk is cut at -3 or -2, not {cut}")
    return {"patch": [int(p) for p in cfg["patch_size"]],
            "dim": int(cfg["embed_dim"]), "depths": depths,
            "heads": [int(h) for h in cfg["num_heads"]],
            "window": [int(w) for w in cfg["window_size"]],
            "hidden": float(cfg["mlp_ratio"]),
            "stages": len(depths) + cut + 2}


# --- the state_dict's layout -------------------------------------------------

def _ln(name: str, c: int):
    return [(f"{name}.weight", (c,), "ln_weight"),
            (f"{name}.bias", (c,), "ln_bias")]


def _linear(name: str, cout: int, cin: int, bias: bool = True):
    out = [(f"{name}.weight", (cout, cin), "linear")]
    return out + ([(f"{name}.bias", (cout,), "bias")] if bias else [])


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the upstream state_dict."""
    s = widths(cfg)
    c = s["dim"]
    wt, wh, ww = s["window"]
    rows = (2 * wt - 1) * (2 * wh - 1) * (2 * ww - 1)
    spec = [(TRUNK + "patch_embed.proj.weight", (c, 3, *s["patch"]),
             "linear"), (TRUNK + "patch_embed.proj.bias", (c,), "bias")]
    spec += _ln(TRUNK + "patch_embed.norm", c)
    for i in range(s["stages"]):
        dim = c * 2 ** i
        hidden = int(dim * s["hidden"])
        for j in range(s["depths"][i]):
            b = f"{TRUNK}features.{2 * i}.{j}."
            spec += _ln(b + "norm1", dim)
            spec += [(b + "attn.relative_position_bias_table",
                      (rows, s["heads"][i]), "table")]
            spec += _linear(b + "attn.qkv", 3 * dim, dim)
            spec += _linear(b + "attn.proj", dim, dim)
            spec += _ln(b + "norm2", dim)
            spec += _linear(b + "mlp.0", hidden, dim)
            spec += _linear(b + "mlp.3", dim, hidden)
        if i < s["stages"] - 1:
            m = f"{TRUNK}features.{2 * i + 1}."
            spec += _ln(m + "norm", 4 * dim)
            spec += _linear(m + "reduction", 2 * dim, 4 * dim, bias=False)
    out_c = c * 2 ** (s["stages"] - 1)
    p, d = parse_shape(cfg["prototype_shape"])[:2]
    k = int(cfg["num_classes"])
    unit = (1, 1, 1)
    spec += [("add_on_layers.0.weight", (d, out_c, *unit), "conv"),
             ("add_on_layers.0.bias", (d,), "head_bias"),
             ("add_on_layers.2.weight", (d, d, *unit), "conv"),
             ("add_on_layers.2.bias", (d,), "head_bias"),
             ("occurrence_module.0.weight", (d, out_c, *unit), "conv"),
             ("occurrence_module.0.bias", (d,), "head_bias"),
             ("occurrence_module.2.weight", (d // 2, d, *unit), "conv"),
             ("occurrence_module.2.bias", (d // 2,), "head_bias"),
             ("occurrence_module.4.weight", (p, d // 2, *unit), "conv"),
             ("prototype_vectors", (p, d, *unit), "uniform01"),
             ("last_layer.weight", (k, p), "readout")]
    return spec


@torch.no_grad()
def make_weights(cfg, seed: int, device) -> Weights:
    """The upstream state_dict drawn from ``seed`` on ``device`` in two
    calls of one generator (fp32), at the scales of the module docstring;
    the head as ``xprotonet.make_weights`` draws it."""
    spec = param_spec(cfg)
    sizes = [math.prod(s) for _, s, _ in spec]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 64))
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out: Weights = {}
    ofs = 0
    for (name, shape, init), n in zip(spec, sizes):
        z, u = normal[ofs:ofs + n].view(shape), uniform[ofs:ofs + n].view(
            shape)
        ofs += n
        if init == "linear":
            out[name] = z / math.sqrt(math.prod(shape[1:]))
        elif init == "bias":
            out[name] = z * 0.1
        elif init == "ln_weight":
            out[name] = 0.75 + 0.5 * u
        elif init == "ln_bias":
            out[name] = 0.1 * z
        elif init == "table":
            out[name] = z.clone()
        elif init == "conv":
            out[name] = z * math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
        elif init == "head_bias":
            out[name] = z * 0.01
        elif init == "uniform01":
            out[name] = u.clone()
        elif init == "readout":
            out[name] = z.clone()
        else:
            raise ValueError(init)
    return out


# --- forward -------------------------------------------------------------------

@contextlib.contextmanager
def _fp32() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN while the reference runs."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _q(t: torch.Tensor, quant: Quant) -> torch.Tensor:
    return t if quant is None else quant(t)


def _lin(w: Weights, name: str, x, quant: Quant):
    return F.linear(_q(x, quant), _q(w[name + ".weight"], quant),
                    w.get(name + ".bias"))


def _layer_norm(w: Weights, name: str, x):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"],
                        w[name + ".bias"], 1e-5)


def _relative_position_index(window: Sequence[int], device) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(k, device=device) for k in window],
        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel.contiguous()
    rel[:, :, 0] += window[0] - 1
    rel[:, :, 1] += window[1] - 1
    rel[:, :, 2] += window[2] - 1
    rel[:, :, 0] *= (2 * window[1] - 1) * (2 * window[2] - 1)
    rel[:, :, 1] *= 2 * window[2] - 1
    return rel.sum(-1)


def _attention_mask(x, size, window, shift) -> torch.Tensor:
    """(windows, N, N): -100 between tokens of different regions of the
    rolled volume, as the published code builds it."""
    mask = x.new_zeros(size)
    slices = [((0, -window[i]), (-window[i], -shift[i]), (-shift[i], None))
              for i in range(3)]
    label = 0
    for d in slices[0]:
        for h in slices[1]:
            for w in slices[2]:
                mask[d[0]:d[1], h[0]:h[1], w[0]:w[1]] = label
                label += 1
    nw = math.prod(s // k for s, k in zip(size, window))
    mask = mask.view(size[0] // window[0], window[0], size[1] // window[1],
                     window[1], size[2] // window[2], window[2])
    mask = mask.permute(0, 2, 4, 1, 3, 5).reshape(nw, math.prod(window))
    mask = mask.unsqueeze(1) - mask.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def _window_attention(w: Weights, p: str, x, heads: int,
                      window_cfg: Sequence[int], quant: Quant, shifted: bool):
    b, t, h, wd, c = x.shape
    size = (t, h, wd)
    window = [s if s <= k else k for s, k in zip(size, window_cfg)]
    shift = [0 if s <= k or not shifted else k // 2
             for s, k in zip(size, window_cfg)]
    pad = [(k - s % k) % k for s, k in zip(size, window)]
    x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    tp, hp, wp = (s + q for s, q in zip(size, pad))
    if sum(shift) > 0:
        x = torch.roll(x, shifts=(-shift[0], -shift[1], -shift[2]),
                       dims=(1, 2, 3))
    nw = (tp // window[0]) * (hp // window[1]) * (wp // window[2])
    n = math.prod(window)
    x = x.view(b, tp // window[0], window[0], hp // window[1], window[1],
               wp // window[2], window[2], c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b * nw, n, c)
    qkv = _lin(w, p + "qkv", x, quant).reshape(b * nw, n, 3, heads,
                                               c // heads)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    index = _relative_position_index(window_cfg, x.device)[:n, :n]
    bias = w[p + "relative_position_bias_table"][index.reshape(-1)]
    bias = bias.view(n, n, heads).permute(2, 0, 1)
    mask = (_attention_mask(x, (tp, hp, wp), window, shift)
            if sum(shift) > 0 else None)
    outs = []
    for lo in range(0, b * nw, WINDOWS_PER_BLOCK):
        hi = min(b * nw, lo + WINDOWS_PER_BLOCK)
        attn = _q(q[lo:hi], quant) @ _q(k[lo:hi], quant).transpose(-2, -1)
        attn = attn + bias
        if mask is not None:
            attn = attn + mask[torch.arange(lo, hi, device=x.device) % nw,
                               None]
        attn = F.softmax(attn, dim=-1)
        outs.append(_q(attn, quant) @ _q(v[lo:hi], quant))
    x = torch.cat(outs).transpose(1, 2).reshape(b * nw, n, c)
    x = _lin(w, p + "proj", x, quant)
    x = x.view(b, tp // window[0], hp // window[1], wp // window[2],
               window[0], window[1], window[2], c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, tp, hp, wp, c)
    if sum(shift) > 0:
        x = torch.roll(x, shifts=tuple(shift), dims=(1, 2, 3))
    return x[:, :t, :h, :wd, :]


def _patch_merging(w: Weights, p: str, x, quant: Quant):
    h, wd = x.shape[-3:-1]
    x = F.pad(x, (0, 0, 0, wd % 2, 0, h % 2))
    x = torch.cat([x[..., 0::2, 0::2, :], x[..., 1::2, 0::2, :],
                   x[..., 0::2, 1::2, :], x[..., 1::2, 1::2, :]], -1)
    return _lin(w, p + "reduction", _layer_norm(w, p + "norm", x), quant)


def trunk(w: Weights, cfg, x, train: bool = False, quant: Quant = None):
    """(N, T, H, W, 3) -> the trunk's channels-last features (N, T', H',
    W', C'). ``train`` changes nothing (no BatchNorm, no stochastic
    depth); it is taken for the flagship reference's signature."""
    s = widths(cfg)
    pt, ph, pw = s["patch"]
    h = x.permute(0, 4, 1, 2, 3)
    t_, h_, w_ = h.shape[2:]
    h = F.pad(h, (0, (pw - w_ % pw) % pw, 0, (ph - h_ % ph) % ph, 0,
                  (pt - t_ % pt) % pt))
    h = F.conv3d(_q(h, quant), _q(w[TRUNK + "patch_embed.proj.weight"],
                                  quant),
                 w[TRUNK + "patch_embed.proj.bias"], stride=s["patch"])
    h = _layer_norm(w, TRUNK + "patch_embed.norm", h.permute(0, 2, 3, 4, 1))
    for i in range(s["stages"]):
        for j in range(s["depths"][i]):
            b = f"{TRUNK}features.{2 * i}.{j}."
            y = _window_attention(w, b + "attn.", _layer_norm(w, b + "norm1",
                                                              h),
                                  s["heads"][i], s["window"], quant,
                                  shifted=j % 2 == 1)
            h = h + y
            y = F.gelu(_lin(w, b + "mlp.0", _layer_norm(w, b + "norm2", h),
                            quant))
            h = h + _lin(w, b + "mlp.3", y, quant)
        if i < s["stages"] - 1:
            h = _patch_merging(w, f"{TRUNK}features.{2 * i + 1}.", h, quant)
    return h


def _head(w: Weights, fmap, quant: Quant):
    """The flagship reference's head over channels-last features."""
    feat = _xp._lin(w, "add_on_layers.2", torch.relu(
        _xp._lin(w, "add_on_layers.0", fmap, quant)), quant)
    occ = _xp._occurrence(w, fmap, quant)
    n, p, d = occ.shape[0], occ.shape[-1], feat.shape[-1]
    roi = torch.einsum("nsp,nsd->npd", _q(occ.reshape(n, -1, p), quant),
                       _q(feat.reshape(n, -1, d), quant))
    proto = w["prototype_vectors"].reshape(p, d)
    cos = (roi * proto[None]).sum(-1) / (
        torch.linalg.vector_norm(roi, dim=-1).clamp_min(_xp.EPS)
        * torch.linalg.vector_norm(proto, dim=-1).clamp_min(_xp.EPS)[None])
    sim = (cos + 1.0) / 2.0
    logits = F.linear(_q(sim, quant), _q(w["last_layer.weight"], quant))
    return logits, sim, occ


def forward(w: Weights, cfg, x: torch.Tensor, train: bool = False,
            quant: Quant = None):
    """x (N, T, H, W, 3) float -> (logits (N, K), sim (N, P), occurrence
    (N, T', H', W', P))."""
    with _fp32():
        return _head(w, trunk(w, cfg, x, train, quant), quant)


def occurrence_map(w: Weights, cfg, x, train: bool = False,
                   quant: Quant = None):
    with _fp32():
        return _xp._occurrence(w, trunk(w, cfg, x, train, quant), quant)


# --- work counts ---------------------------------------------------------------

def _meta_weights(cfg) -> Weights:
    return {n: torch.empty(s, device="meta") for n, s, _ in param_spec(cfg)}


def _input_shape(cfg) -> Tuple[int, ...]:
    s = int(cfg["img_size"])
    return (int(cfg["frames"]), s, s, 3)


def head_shape(cfg) -> Tuple[int, int, int]:
    """(S positions, P prototypes, D channels) at the prototype head."""
    x = torch.empty((1, *_input_shape(cfg)), device="meta")
    fmap = trunk(_meta_weights(cfg), cfg, x)
    p, d = parse_shape(cfg["prototype_shape"])[:2]
    return math.prod(fmap.shape[1:-1]), p, d


def serve_flops(cfg, batch: int = 1) -> float:
    """Matmul and convolution FLOPs of the served forward, per sample, 2 a
    multiply-add."""
    from torch.utils.flop_counter import FlopCounterMode

    w = _meta_weights(cfg)
    x = torch.empty((batch, *_input_shape(cfg)), device="meta")
    with FlopCounterMode(display=False) as counter:
        forward(w, cfg, x)
    return float(counter.get_total_flops()) / batch
