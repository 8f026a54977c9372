"""Plain PyTorch reference of ProtoASNet's Video_XProtoNet on an MViTv2
trunk (Li et al., "MViTv2: Improved Multiscale Vision Transformers for
Classification and Detection", arXiv:2112.01526; MViTv2-B as SlowFast's
``configs/Kinetics/MVITv2_B_32x3.yaml`` sets it, built by the rules of
torchvision's ``mvit_v2_s``).

The benchmark's yardstick for the served logits of the configuration
``protoasnet_video_mvitv2_b``. Float32 functional torch over a state_dict
in the upstream naming, with TF32 off for matmuls and cuDNN while it runs;
it imports nothing of the program. The trunk follows the published
forward, cut after stage 3 (``backbone_last_layer_num: -3``), widths and
strides from the configuration's own keys (``embed_dim``, ``depths``,
``num_heads``, ``patch_kernel``, ``patch_stride``, ``patch_padding``,
``pool_kernel``, ``kv_stride``, ``q_stride``, ``mlp_ratio``):

- patch embedding: Conv3d (``cnn_backbone.conv_proj``), the tokens in
  (t, h, w) order, the class token (``pos_encoding.class_token``) in front;
- block i (``cnn_backbone.blocks.{i}``): xn = LN1(x) (eps 1e-6); qkv
  (``attn.qkv``) split into heads of ``embed_dim``; q, k and v each pooled:
  the class token split off, the rest through a depthwise Conv3d over the
  head width (``attn.pool_{q,k,v}.pool``, kernel 3, padding 1, no bias),
  the class token put back, LayerNorm over the head width on every row
  (``attn.pool_{q,k,v}.norm_act.0``); A = (q·d^-1/2)·kᵀ, and to its
  spatial rows and columns q·R_t + q·R_h + q·R_w with R_a =
  ``attn.rel_pos_a``[idx_a], idx_a = i·max(k/q, 1) - (j + 1 - k)·max(q/k,
  1) truncated (q and k that axis's pooled sides); softmax, ·v, q added to
  the spatial rows (residual pooling), ``attn.project.0``. The skip: x, or
  ``project`` of xn where the width changes, max-pooled (kernel (1, 3, 3),
  stride (1, 2, 2), padding (0, 1, 1), the class token passing) where q is
  strided; x = skip + attn, then x + ``mlp.3``(GELU(``mlp.0``(LN2(x)))).
  The width and heads double and q is strided at the first block of each
  later stage; k and v are strided at ``kv_stride`` divided by every q
  stride so far;
- the output: the last block's spatial tokens, the class token dropped,
  no final norm, (N, T', H', W', C').

The head is the flagship's (``xprotonet.py``'s functions: add-on,
occurrence, ROI cosine, readout with the abstain logit), composed over
channels-last features as ``swin_xprotonet.py`` composes them, so the three
configurations share one yardstick for the head.

Departures from the published code: the relative-position tables are
sized for this configuration's clips (2·max(q, k) - 1 rows an axis, the
pooled sides of 32x112x112 clips) and read without interpolation, which
the published code does only when a table's size differs; stochastic depth
(0.3) is a training-time regulariser and is never applied here; the
attention is computed in blocks of ``QUERY_ROWS`` query rows, so the check
of a whole served batch fits on the card.

``make_weights`` draws every tensor from the seed. Its scales are the
benchmark's, not torchvision's initialisation (trunc-normal 0.02 for the
Linears, the tables and the class token, which leaves each residual branch
~1% of the stream and the positional terms at ~1/40 of a logit, so a check
could not see a broken mechanism): Linear and conv weights N(0, 1/fan_in),
so each branch adds about as much as the stream holds and each pooling
conv keeps its input's scale (fan_in 27, its kernel); biases N(0, 0.1);
LayerNorm weights U(0.75, 1.25) and shifts N(0, 0.1), the pooling norms
too, so the normed q and k give logits of order one; the positional tables
N(0, 1/d), so each q·R term (q normed, d = 96 wide) is of order one, as a
logit is; the class token N(0, 1), the scale of the patch embedding's
tokens, so the class token's row and column weigh as a patch's do.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.swin_xprotonet import _head
from perfbench.reference.xprotonet import (fp8_e4m3, gray_to_input,
                                           parse_shape)

__all__ = ["QUERY_ROWS", "schedule", "param_spec", "make_weights",
           "gray_to_input", "forward", "occurrence_map", "fp8_e4m3",
           "head_shape", "serve_flops", "trunk"]

QUERY_ROWS = 2048
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
Weights = Dict[str, torch.Tensor]
TRUNK = "cnn_backbone."
EPS_LN = 1e-6


def _conv_out(size, kernel, stride, padding) -> Tuple[int, ...]:
    return tuple((s + 2 * p - k) // st + 1
                 for s, k, st, p in zip(size, kernel, stride, padding))


def schedule(cfg) -> List[Dict]:
    """Each kept block's widths, heads, strides and token sides, from the
    configuration's keys and its clips (``frames``, ``img_size``)."""
    depths = [int(d) for d in cfg["depths"]]
    cut = int(cfg.get("backbone_last_layer_num", -3))
    if cut not in (-3, -2):
        raise ValueError(f"an MViT trunk is cut at -3 or -2, not {cut}")
    kernel = [int(k) for k in cfg["pool_kernel"]]
    pad = [k // 2 for k in kernel]
    thw = _conv_out((int(cfg["frames"]), int(cfg["img_size"]),
                     int(cfg["img_size"])), cfg["patch_kernel"],
                    cfg["patch_stride"], cfg["patch_padding"])
    starts = [sum(depths[:i]) for i in range(1, len(depths))]
    kv = [int(s) for s in cfg["kv_stride"]]
    dim, heads = int(cfg["embed_dim"]), int(cfg["num_heads"])
    out = []
    for i in range(sum(depths[:len(depths) + cut + 2])):
        dim_in = dim
        sq = [1, 1, 1]
        if i in starts:
            sq = [int(s) for s in cfg["q_stride"]]
            kv = [max(a // b, 1) for a, b in zip(kv, sq)]
            dim, heads = dim * 2, heads * 2
        q_thw = _conv_out(thw, kernel, sq, pad)
        kv_thw = _conv_out(thw, kernel, kv, pad)
        out.append({"dim_in": dim_in, "dim_out": dim, "heads": heads,
                    "head_dim": dim // heads, "stride_q": sq,
                    "stride_kv": list(kv), "thw": thw, "q_thw": q_thw,
                    "kv_thw": kv_thw})
        thw = q_thw
    return out


# --- the state_dict's layout -------------------------------------------------

def _ln(name: str, c: int):
    return [(f"{name}.weight", (c,), "ln_weight"),
            (f"{name}.bias", (c,), "ln_bias")]


def _linear(name: str, cout: int, cin: int):
    return [(f"{name}.weight", (cout, cin), "linear"),
            (f"{name}.bias", (cout,), "bias")]


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every tensor of the upstream state_dict."""
    c = int(cfg["embed_dim"])
    spec = [(TRUNK + "conv_proj.weight",
             (c, 3, *[int(k) for k in cfg["patch_kernel"]]), "linear"),
            (TRUNK + "conv_proj.bias", (c,), "bias"),
            (TRUNK + "pos_encoding.class_token", (c,), "token")]
    sched = schedule(cfg)
    kernel = tuple(int(k) for k in cfg["pool_kernel"])
    for i, s in enumerate(sched):
        b = f"{TRUNK}blocks.{i}."
        din, dout, d = s["dim_in"], s["dim_out"], s["head_dim"]
        hidden = int(dout * float(cfg["mlp_ratio"]))
        spec += _ln(b + "norm1", din)
        spec += _linear(b + "attn.qkv", 3 * dout, din)
        spec += _linear(b + "attn.project.0", dout, dout)
        for x in "qkv":
            spec += [(f"{b}attn.pool_{x}.pool.weight", (d, 1, *kernel),
                      "linear")]
            spec += _ln(f"{b}attn.pool_{x}.norm_act.0", d)
        (qt, qh, qw), (kt, kh, kw) = s["q_thw"], s["kv_thw"]
        spec += [(b + "attn.rel_pos_h", (2 * max(qh, kh) - 1, d), "table"),
                 (b + "attn.rel_pos_w", (2 * max(qw, kw) - 1, d), "table"),
                 (b + "attn.rel_pos_t", (2 * max(qt, kt) - 1, d), "table")]
        spec += _ln(b + "norm2", dout)
        spec += _linear(b + "mlp.0", hidden, dout)
        spec += _linear(b + "mlp.3", dout, hidden)
        if din != dout:
            spec += _linear(b + "project", dout, din)
    out_c = sched[-1]["dim_out"]
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
            out[name] = z / math.sqrt(shape[1])
        elif init == "token":
            out[name] = z.clone()
        elif init == "conv":
            out[name] = z * math.sqrt(2.0 / (shape[0]
                                             * math.prod(shape[2:])))
        elif init == "head_bias":
            out[name] = z * 0.01
        elif init == "uniform01":
            out[name] = u.clone()
        elif init == "readout":
            out[name] = z.clone()
        else:
            raise ValueError(init)
    return out


# --- forward -----------------------------------------------------------------

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
                        w[name + ".bias"], EPS_LN)


def _pool(w: Weights, name: str, x, thw, stride, quant: Quant):
    """x (B, heads, 1 + S, d) -> pooled and normed, and its new sides."""
    b, heads, _, d = x.shape
    cls, sp = x[:, :, :1], x[:, :, 1:]
    sp = sp.transpose(2, 3).reshape(b * heads, d, *thw)
    weight = w[name + ".pool.weight"]
    sp = F.conv3d(_q(sp, quant), _q(weight, quant), None, stride,
                  [k // 2 for k in weight.shape[2:]], 1, d)
    new = tuple(sp.shape[2:])
    sp = sp.reshape(b, heads, d, -1).transpose(2, 3)
    return _layer_norm(w, name + ".norm_act.0", torch.cat([cls, sp], 2)), new


def _rel_index(q: int, k: int, device) -> torch.Tensor:
    q_ratio, k_ratio = max(k / q, 1.0), max(q / k, 1.0)
    dist = (torch.arange(q, device=device)[:, None] * q_ratio
            - (torch.arange(k, device=device)[None, :] + (1.0 - k))
            * k_ratio)
    return dist.long()


def _rel_terms(w: Weights, p: str, q, q_thw, k_thw, quant: Quant):
    """The per-axis terms q·R_t, q·R_h, q·R_w of the spatial queries:
    (B, heads, Sq, k_t), (.., k_h), (.., k_w)."""
    b, heads, _, d = q.shape
    (qt, qh, qw), (kt, kh, kw) = q_thw, k_thw
    dev = q.device
    r_t = w[p + "rel_pos_t"][_rel_index(qt, kt, dev)]
    r_h = w[p + "rel_pos_h"][_rel_index(qh, kh, dev)]
    r_w = w[p + "rel_pos_w"][_rel_index(qw, kw, dev)]
    rq = _q(q[:, :, 1:].reshape(b, heads, qt, qh, qw, d), quant)
    t = torch.einsum("bythwc,tkc->bythwk", rq, _q(r_t, quant))
    h = torch.einsum("bythwc,hkc->bythwk", rq, _q(r_h, quant))
    x = torch.einsum("bythwc,wkc->bythwk", rq, _q(r_w, quant))
    return (t.reshape(b, heads, -1, kt), h.reshape(b, heads, -1, kh),
            x.reshape(b, heads, -1, kw))


def _attention(w: Weights, p: str, x, s, quant: Quant):
    b, n, _ = x.shape
    heads, d = s["heads"], s["head_dim"]
    qkv = _lin(w, p + "qkv", x, quant).reshape(b, n, 3, heads, d)
    q, k, v = qkv.transpose(1, 3).unbind(2)  # (B, heads, n, d) each
    k, k_thw = _pool(w, p + "pool_k", k, s["thw"], s["stride_kv"], quant)
    v, _ = _pool(w, p + "pool_v", v, s["thw"], s["stride_kv"], quant)
    q, q_thw = _pool(w, p + "pool_q", q, s["thw"], s["stride_q"], quant)
    rel = _rel_terms(w, p, q, q_thw, k_thw, quant)
    kt, kh, kw = k_thw
    lq = q.shape[2]
    outs = []
    for lo in range(0, lq, QUERY_ROWS):
        hi = min(lq, lo + QUERY_ROWS)
        attn = _q(q[:, :, lo:hi] * d ** -0.5, quant) @ _q(
            k, quant).transpose(2, 3)
        # the positional terms of the spatial rows among lo..hi, on the
        # spatial columns; the class token's row and column get none
        s0, s1 = max(lo, 1) - 1, hi - 1
        if s1 > s0:
            pos = (rel[0][:, :, s0:s1, :, None, None]
                   + rel[1][:, :, s0:s1, None, :, None]
                   + rel[2][:, :, s0:s1, None, None, :]).reshape(
                       b, heads, s1 - s0, kt * kh * kw)
            attn[:, :, hi - (s1 - s0) - lo:, 1:] += pos
        attn = F.softmax(attn, dim=-1)
        o = _q(attn, quant) @ _q(v, quant)
        # residual pooling: q added to the spatial rows
        o[:, :, max(lo, 1) - lo:] += q[:, :, max(lo, 1):hi]
        outs.append(o)
    o = torch.cat(outs, 2).transpose(1, 2).reshape(b, lq, heads * d)
    return _lin(w, p + "project.0", o, quant)


def _max_pool_skip(x, thw, stride):
    b, _, c = x.shape
    kernel = [st + 1 if st > 1 else st for st in stride]
    sp = x[:, 1:].transpose(1, 2).reshape(b, c, *thw)
    sp = F.max_pool3d(sp, kernel, stride, [k // 2 for k in kernel])
    return torch.cat([x[:, :1], sp.reshape(b, c, -1).transpose(1, 2)], 1)


def trunk(w: Weights, cfg, x, train: bool = False, quant: Quant = None):
    """(N, T, H, W, 3) -> the trunk's channels-last features (N, T', H',
    W', C'). ``train`` changes nothing (no BatchNorm, no stochastic
    depth); it is taken for the flagship reference's signature."""
    sched = schedule(cfg)
    h = F.conv3d(_q(x.permute(0, 4, 1, 2, 3), quant),
                 _q(w[TRUNK + "conv_proj.weight"], quant),
                 w[TRUNK + "conv_proj.bias"],
                 [int(s) for s in cfg["patch_stride"]],
                 [int(p) for p in cfg["patch_padding"]])
    b, c = h.shape[:2]
    h = h.flatten(2).transpose(1, 2)
    token = w[TRUNK + "pos_encoding.class_token"]
    h = torch.cat([token.expand(b, 1, c), h], 1)
    for i, s in enumerate(sched):
        p = f"{TRUNK}blocks.{i}."
        xn = _layer_norm(w, p + "norm1", h)
        attn = _attention(w, p + "attn.", xn, s, quant)
        skip = _lin(w, p + "project", xn, quant) if s["dim_in"] != s[
            "dim_out"] else h
        if math.prod(s["stride_q"]) > 1:
            skip = _max_pool_skip(skip, s["thw"], s["stride_q"])
        h = skip + attn
        y = F.gelu(_lin(w, p + "mlp.0", _layer_norm(w, p + "norm2", h),
                        quant))
        h = h + _lin(w, p + "mlp.3", y, quant)
    last = sched[-1]
    return h[:, 1:].reshape(b, *last["q_thw"], last["dim_out"])


def forward(w: Weights, cfg, x: torch.Tensor, train: bool = False,
            quant: Quant = None):
    """x (N, T, H, W, 3) float -> (logits (N, K), sim (N, P), occurrence
    (N, T', H', W', P))."""
    with _fp32():
        return _head(w, trunk(w, cfg, x, train, quant), quant)


def occurrence_map(w: Weights, cfg, x, train: bool = False,
                   quant: Quant = None):
    from perfbench.reference import xprotonet as _xp

    with _fp32():
        return _xp._occurrence(w, trunk(w, cfg, x, train, quant), quant)


# --- work counts -------------------------------------------------------------

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
