"""The Video Swin trunk (``models/backbones/swin3d.py``) and its window
attention (``ops/window_attn.py``, ``ops/window_attn_cuda.py``) against
the benchmark's plain reference (``perfbench/reference/swin_xprotonet.py``).

On the CPU, at a tiny Swin (C=16, depths (2, 2, 2) kept of (2, 2, 2, 2),
heads (1, 2, 4), window (4, 3, 3)) built as ``swin3d_b`` with its widths
patched, from the reference's seeded weights handed through the importer:
- fp32 logits, similarities and occurrence maps within 1e-5 of the
  largest (sums in another order), and the bf16 served path (uint8 gray
  in) as the flagship's test holds it, at clips that shift every side,
  pad to whole windows and cut a window to a side not larger than it (the
  bias read as ``index[:N, :N]``);
- the plain window attention against a loop over one window's pairs;
- the kernel's addressing (its index tables: each window's tokens in the
  rolled volume, the bias at c0 + pos[i] - pos[j], the region labels)
  emulated in torch against the plain route;
- the importer's key map both ways; the port's ``swin3d_b`` against the
  configuration file's widths; the cut;
- one train micro-step (float64, stochastic depth 0): its loss and every
  gradient against autograd through the reference;
- the kernel's backward (the plain route recomputed in fp32, a few clips
  at a time) against autograd through the plain route; the kernel's
  shared memory, three blocks an SM at the served windows;
- int8, the push and the local explanation of a Swin model refused; the
  counters ``swin.window_attn(.plain)``, one a block's attention.
On the card (``cuda`` marker): the kernel against the plain route at the
cell's three stage shapes in bf16 and fp32, shifted and not; its shared
memory against the source's; ``WindowAttnFunction``'s gradients against
float64 autograd; one train micro-step of a Swin with 32-wide heads on the
card (the kernel forward and backward) against the float64 reference.
"""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.reference import swin_xprotonet as ref
from perfbench.reference import xprotonet as xp_ref
from protoasnet_tpu_torch.models.backbones import swin3d
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.migrate import (convert_reference_state_dict,
                                                 export_reference_state_dict)
from protoasnet_tpu_torch.ops import window_attn
from protoasnet_tpu_torch.ops.window_attn_cuda import (index_tables,
                                                      smem_bytes,
                                                      table_offset,
                                                      window_attn_cuda)
from protoasnet_tpu_torch.utils import profiling
from torch_port_isolation import isolated

_isolated = isolated(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "perfbench/configs/swin3d/protoasnet_video_swin3d_b.json"
TINY = {"patch_size": (2, 4, 4), "embed_dim": 16, "depths": (2, 2, 2, 2),
        "num_heads": (1, 2, 4, 8), "window_size": (4, 3, 3),
        "mlp_ratio": 4.0, "stochastic_depth_prob": 0.0}
CFG = {"name": "Video_XProtoNet", "base_architecture": "swin3d_b",
       "backbone_last_layer_num": -3, "prototype_shape": "(8, 16, 1, 1, 1)",
       "num_classes": 4, "dtype": "float32", "img_size": 40, "frames": 16,
       "batch_size": 3, "accumulation_steps": 2,
       **{k: list(v) if isinstance(v, tuple) else v
          for k, v in TINY.items()},
       "criterion": {"CeLossAbstain": {"loss_weight": 1, "ab_weight": 0.3},
                     "ClusterRoiFeat": {"loss_weight": 0.8},
                     "SeparationRoiFeat": {"loss_weight": 0.08},
                     "OrthogonalityLoss": {"loss_weight": 0.01},
                     "Lnorm_occurrence": {"loss_weight": 0.01, "p": 2},
                     "trans_occurrence": {"loss_weight": 0.001},
                     "Lnorm_FC": {"loss_weight": 0.0001, "p": 1}}}
# (frames, side): 16x40 -> tokens 8x10x10: every side shifted (2, 1, 1),
# H and W padded to 12; stage 2 8x5x5 padded to 6; stage 3 8x3x3, H and W
# not larger than the window (cut to 3, shift 0), T shifted. 8x24 -> 4x6x6:
# T cut to 4 (no shift); stage 3 4x2x2, a 16-token window of the 36-token
# table's window. 7x26: the clip padded to whole patches (8x28 -> 4x7x7).
CLIPS = [(16, 40), (8, 24), (7, 26)]


@pytest.fixture
def tiny(monkeypatch):
    """``swin3d_b`` at the tiny widths for this test."""
    monkeypatch.setitem(swin3d.SWIN3D_SPECS, "swin3d_b", TINY)


def _cfg(frames, side, **kw):
    return dict(CFG, frames=frames, img_size=side, **kw)


def _port(cfg, w, dtype="float32"):
    mcfg = dict(cfg, dtype=dtype)
    model = build_model(mcfg, device="cpu")
    model.load_state_dict(convert_reference_state_dict(w, mcfg))
    return model


def _gray(n, frames, side, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, frames, side, side), generator=g,
                         dtype=torch.uint8)


@pytest.mark.parametrize("frames, side", CLIPS,
                         ids=[f"{f}x{s}" for f, s in CLIPS])
def test_forward_matches_reference(tiny, frames, side):
    cfg = _cfg(frames, side)
    w = ref.make_weights(cfg, 1234, "cpu")
    model = _port(cfg, w)
    gray = _gray(3, frames, side, 5)
    x = ref.gray_to_input(gray)
    with torch.no_grad():
        want = ref.forward(w, cfg, x)
        got = model(x.contiguous())
    for a, b in zip(got, want):  # fp32 sums in another order
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    # the served path: uint8 gray in, bf16 autocast, as the bundle runs it
    from protoasnet_tpu_torch.serve import make_serving_fn

    fn = make_serving_fn(_port(cfg, w, "bfloat16"), uint8_gray=True)
    served = torch.from_numpy(fn(gray.numpy()))
    assert (served - want[0]).abs().max() < 0.05 * want[0].abs().max()


def _volume(b, size, c, heads, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, *size, 3 * c), generator=g, dtype=dtype)
    return qkv


def _table(window, heads, seed):
    rows = math.prod(2 * k - 1 for k in window)
    return torch.randn((rows, heads), generator=torch.Generator()
                       .manual_seed(seed))


def test_plain_attention_matches_a_loop_over_one_window():
    """One shifted window with a region border and a cut window's bias:
    every (query, key) pair's logit written out by hand."""
    size, window, shift, full = (4, 6, 6), (4, 3, 3), (0, 1, 1), (4, 3, 3)
    heads, c = 2, 8
    qkv = _volume(1, size, c, heads, 1, torch.float64)
    table = _table(full, heads, 2).double()
    index = window_attn.relative_position_index(full)
    got = window_attn.window_attention_torch(qkv, table, index, heads,
                                             window, shift)
    # the last window (1, 1) in the rolled volume: rows 3..5 of H and W
    rolled = torch.roll(qkv, (-1, -1), dims=(2, 3))
    toks = [(t, h, w) for t in range(4) for h in range(3, 6)
            for w in range(3, 6)]
    region = [(int(h >= 5) * 3 + int(w >= 5)) for _, h, w in toks]
    hd = c // heads
    for head in range(heads):
        out = []
        for i, (ti, hi, wi) in enumerate(toks):
            q = rolled[0, ti, hi, wi, head * hd:(head + 1) * hd]
            logits = []
            for j, (tj, hj, wj) in enumerate(toks):
                k = rolled[0, tj, hj, wj, c + head * hd:c + (head + 1) * hd]
                rel = ((ti - tj + 3) * 5 + (hi - hj + 2)) * 5 + (wi - wj + 2)
                logit = float(q @ k) / math.sqrt(hd) + float(table[rel, head])
                logits.append(logit + (0.0 if region[i] == region[j]
                                       else -100.0))
            p = torch.softmax(torch.tensor(logits, dtype=torch.float64), 0)
            v = torch.stack([rolled[0, tj, hj, wj, 2 * c + head * hd:
                                    2 * c + (head + 1) * hd]
                             for tj, hj, wj in toks])
            out.append(p @ v)
        for (t, h, w), o in zip(toks, out):  # back where the token lay
            torch.testing.assert_close(
                got[0, t, (h + 1) % 6, (w + 1) % 6,
                    head * hd:(head + 1) * hd], o, rtol=1e-10, atol=1e-12)

def _kernel_emulated(qkv, table, heads, window, shift, full):
    """The kernel's arithmetic in torch over its index tables: each
    window's rows at ``clip + tok[w, j]``, the bias at ``c0 + pos[i] -
    pos[j]`` of the (heads, rows) table, the mask where ``lab`` differs."""
    b, t, h, w, c3 = qkv.shape
    c = c3 // 3
    hd = c // heads
    tok, pos, lab = index_tables((t, h, w), window, shift, full, "cpu")
    nw, n = tok.shape
    tbl = table.t().reshape(-1)
    flat = qkv.reshape(-1, c3)
    out = torch.empty(b * t * h * w, c, dtype=qkv.dtype)
    for bw in range(b * nw):
        wi = bw % nw
        rows = (bw // nw) * (t * h * w) + tok[wi].long()
        for head in range(heads):
            q = flat[rows, head * hd:(head + 1) * hd]
            k = flat[rows, c + head * hd:c + (head + 1) * hd]
            v = flat[rows, 2 * c + head * hd:2 * c + (head + 1) * hd]
            s = q @ k.t() * hd ** -0.5 + tbl[
                head * table.shape[0] + table_offset(full)
                + pos[:, None].long() - pos[None, :].long()]
            if any(shift):
                s = torch.where(lab[wi][:, None] == lab[wi][None, :], s,
                                s - 100.0)
            out[rows, head * hd:(head + 1) * hd] = torch.softmax(s, -1) @ v
    return out.reshape(b, t, h, w, c)


KERNEL_CASES = [((8, 12, 12), (4, 3, 3), (2, 1, 1), (4, 3, 3)),
                ((8, 6, 6), (4, 3, 3), (2, 1, 1), (4, 3, 3)),
                ((8, 3, 3), (4, 3, 3), (2, 0, 0), (4, 3, 3)),
                ((4, 2, 2), (4, 2, 2), (0, 0, 0), (4, 3, 3)),
                ((8, 6, 6), (4, 3, 3), (0, 0, 0), (4, 3, 3))]


@pytest.mark.parametrize("size, window, shift, full", KERNEL_CASES,
                         ids=["shifted", "shifted-small", "t-shift-only",
                              "cut-window", "unshifted"])
def test_kernel_addressing_matches_plain(size, window, shift, full):
    heads, c = 2, 8
    qkv = _volume(2, size, c, heads, 3, torch.float64)
    table = _table(full, heads, 4).double()
    want = window_attn.window_attention_torch(
        qkv, table, window_attn.relative_position_index(full), heads,
        window, shift)
    got = _kernel_emulated(qkv, table, heads, window, shift, full)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_window_rule():
    assert window_attn.window_and_shift((16, 7, 7), (8, 7, 7), (4, 3, 3)) \
        == ((8, 7, 7), (4, 0, 0))
    assert window_attn.window_and_shift((16, 28, 28), (8, 7, 7),
                                        (4, 3, 3)) == ((8, 7, 7), (4, 3, 3))
    assert window_attn.window_and_shift((4, 2, 2), (8, 7, 7), (0, 0, 0)) \
        == ((4, 2, 2), (0, 0, 0))


def test_importer_both_ways(tiny):
    cfg = _cfg(8, 24)
    w = ref.make_weights(cfg, 7, "cpu")
    sd = convert_reference_state_dict(w, cfg)
    model = build_model(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    # an upstream state_dict's relative_position_index is not carried
    extra = dict(w, **{"cnn_backbone.features.0.0.attn."
                       "relative_position_index": torch.zeros(1)})
    assert set(convert_reference_state_dict(extra, cfg)) == set(sd)
    back = export_reference_state_dict(sd, cfg)
    assert set(back) == set(w) | {"ones"}
    for k, v in w.items():
        assert torch.equal(torch.as_tensor(back[k]), v), k
    assert "cnn_backbone.patch_embed.proj.weight" in sd
    assert "cnn_backbone.features.1.reduction.weight" in sd
    assert "cnn_backbone.features.4.1.mlp.3.bias" in sd


def test_swin3d_b_is_the_configuration_files():
    cfg = json.loads(CONFIG.read_text())
    spec = swin3d.SWIN3D_SPECS["swin3d_b"]
    for key, value in spec.items():
        want = cfg[key]
        assert (list(value) if isinstance(value, tuple) else value) == want
    assert cfg["base_architecture"] == "swin3d_b"
    assert cfg["backbone_last_layer_num"] == -3


def test_the_cut():
    kw = dict(patch_size=(2, 4, 4), embed_dim=8, depths=(1, 1, 1, 1),
              num_heads=(1, 1, 2, 2), window_size=(2, 2, 2))
    three = swin3d.SwinTransformer3d(**kw, last_layer_num=-3)
    four = swin3d.SwinTransformer3d(**kw, last_layer_num=-2)
    assert (three.out_channels, len(three.features)) == (32, 5)
    assert (four.out_channels, len(four.features)) == (64, 7)
    x = torch.randn(1, 4, 32, 32, 3)
    with torch.no_grad():
        assert three(x).shape == (1, 2, 2, 2, 32)
        assert four(x).shape == (1, 2, 1, 1, 64)
    for bad in (-1, -4, 3):
        with pytest.raises(ValueError, match="cut"):
            swin3d.SwinTransformer3d(**kw, last_layer_num=bad)


def test_the_init_is_torchvisions(tiny):
    """Linears and bias tables N(0, 0.02) (torchvision's trunc_normal_ at
    its default cut, +-2 absolute), Linear biases 0, LayerNorms 1 and 0."""
    model = build_model(_cfg(8, 24), device="cpu", seed=3)
    trunk = model.cnn_backbone
    mods = list(trunk.modules())
    for kind, get in ((torch.nn.Linear, lambda m: m.weight),
                      (swin3d.ShiftedWindowAttention3d,
                       lambda m: m.relative_position_bias_table)):
        w = torch.cat([get(m).detach().reshape(-1) for m in mods
                       if isinstance(m, kind)])
        assert abs(float(w.std()) - 0.02) < 0.002 and float(w.abs().max()) < 2
    assert all(float(m.bias.detach().abs().max()) == 0 for m in mods
               if isinstance(m, torch.nn.Linear) and m.bias is not None)
    norms = [m for m in mods if isinstance(m, torch.nn.LayerNorm)]
    assert all(bool((m.weight == 1).all()) and bool((m.bias == 0).all())
               for m in norms)


def _micro_step(model, cfg, x, t, aff):
    """One micro-step of the port's train step (no update at accumulation
    2): its output, and the gradients in the reference's names."""
    from protoasnet_tpu_torch.losses.bundle import LossBundle
    from protoasnet_tpu_torch.train.optim import (GROUPS, GradAccumulator,
                                                  GroupAdam)
    from protoasnet_tpu_torch.train.steps import make_xprotonet_steps

    opt = GroupAdam(model)
    acc = GradAccumulator(opt.params, cfg["accumulation_steps"])
    step = make_xprotonet_steps(
        model, LossBundle(cfg["criterion"], 4, True), opt, acc)[0]
    got = step(x, t, torch.ones(len(t), dtype=torch.bool, device=x.device),
               {g: 1e-3 for g in GROUPS}, affine=aff)
    assert not got["applied"]
    grads = export_reference_state_dict(
        {n: p.grad for n, p in model.named_parameters()}, cfg)
    return got, grads


def _reference_step(w, cfg, x, t, aff, monkeypatch):
    """The loss and every weight's gradient, float64 autograd through the
    reference (its trunk under the flagship reference's objective)."""
    monkeypatch.setattr(xp_ref, "_trunk", ref.trunk)
    w64 = {k: v.double().requires_grad_(True) for k, v in w.items()}
    loss = sum(xp_ref.loss_terms(w64, cfg, x.double(), t, aff).values())
    names = list(w64)
    grads = torch.autograd.grad(loss, [w64[n] for n in names])
    return float(loss.detach()), dict(zip(names, grads))


def test_train_micro_step_matches_reference(tiny, monkeypatch):
    """One micro-step (no update at accumulation 2) in float64: the loss
    and every parameter's gradient against autograd through the reference
    (its trunk under the flagship reference's objective)."""
    cfg = _cfg(8, 24)
    w = ref.make_weights(cfg, 99, "cpu")
    model = _port(cfg, w).double()
    x = ref.gray_to_input(_gray(3, 8, 24, 10)).double().contiguous()
    t = torch.tensor([0, 1, 2])
    aff = (torch.tensor(7.0), torch.tensor(0.9))
    got, port = _micro_step(model, cfg, x, t, aff)
    want_loss, want = _reference_step(w, cfg, x, t, aff, monkeypatch)
    assert abs(float(got["loss_all"]) - want_loss) < 1e-9 * abs(want_loss)
    for name, g in want.items():
        torch.testing.assert_close(torch.as_tensor(port[name]).double(),
                                   g.reshape(port[name].shape), rtol=1e-7,
                                   atol=1e-10, msg=name)


@pytest.mark.parametrize("size, window, shift, full", KERNEL_CASES[:3],
                         ids=["shifted", "shifted-small", "t-shift-only"])
def test_kernel_backward_matches_autograd(size, window, shift, full,
                                          monkeypatch):
    """``window_attention_backward`` (the kernel's backward: the plain
    route recomputed in fp32, here one clip a run) against autograd
    through the plain route, float64 inputs."""
    heads, c = 2, 8
    qkv = _volume(3, size, c, heads, 7, torch.float64).requires_grad_(True)
    table = _table(full, heads, 8).double().requires_grad_(True)
    index = window_attn.relative_position_index(full)
    g = torch.randn((3, *size, c), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(9))
    out = window_attn.window_attention_torch(qkv, table, index, heads,
                                             window, shift)
    want = torch.autograd.grad(out, (qkv, table), g)
    monkeypatch.setattr(window_attn, "BACKWARD_BYTES", 1)
    got = window_attn.window_attention_backward(
        qkv.detach(), table.detach(), index, heads, window, shift, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_kernel_layout_fits_three_blocks_an_sm():
    """The served windows (392 tokens, the 2,535-row table) in bf16 leave
    room for three blocks on an H100 SM (228 KB, 1 KB reserved a block);
    fp32 within one block's 227 KB."""
    assert 3 * (smem_bytes(2, 392, 2535) + 1024) <= 228 * 1024
    assert smem_bytes(4, 392, 2535) <= 232448
    with pytest.raises(ValueError, match="CUDA"):
        window_attn_cuda(torch.zeros(1, 8, 7, 7, 96), torch.zeros(2535, 1),
                         window_attn.relative_position_index((8, 7, 7)), 1,
                         (8, 7, 7), (0, 0, 0), (8, 7, 7))


def test_int8_push_and_explain_are_refused(tiny):
    from protoasnet_tpu_torch.quant import (calibrate_act_scales,
                                            quantized_model)
    from protoasnet_tpu_torch.train.agents.xprotonet import \
        _XProtoNetAgentCommon

    model = build_model(_cfg(8, 24), device="cpu")
    x = torch.zeros(1, 8, 24, 24, 3)
    with pytest.raises(NotImplementedError, match="int8"):
        calibrate_act_scales(model, [x])
    with pytest.raises(NotImplementedError, match="int8"):
        quantized_model(model, {})
    stub = SimpleNamespace(model=model)
    with pytest.raises(NotImplementedError, match="push"):
        _XProtoNetAgentCommon.push(stub)
    with pytest.raises(NotImplementedError, match="explain"):
        _XProtoNetAgentCommon.explain_local(stub)


def test_each_blocks_attention_counts_once(tiny):
    model = build_model(_cfg(8, 24), device="cpu")
    x = torch.zeros(1, 8, 24, 24, 3)
    profiling.reset()
    with torch.no_grad():
        model(x)  # off: nothing recorded
        assert profiling.spans() == []
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("batcher.batch"):
                model(x)
    counts = [s["counts"] for s in profiling.spans()
              if s["name"] == "batcher.batch"]
    profiling.reset()
    assert counts == [{"swin.window_attn.plain": 6}]  # 2 + 2 + 2 blocks


def test_the_experiment_runs_on_the_cpu(capsys):
    """``experiments/window_attn.py --device cpu``: the library route's
    arithmetic (roll, partition, the broadcast bias) against the plain
    route at each stage's widths."""
    from protoasnet_tpu_torch.experiments import window_attn as exp

    assert exp.main(["--device", "cpu"]) == 0
    rows = [json.loads(line)
            for line in capsys.readouterr().out.splitlines()]
    assert [r["stage"] for r in rows] == [1, 2, 3]
    assert all(r["library_vs_plain"] < 1e-5 for r in rows)


# --- on the card ----------------------------------------------------------

# the cell's three stage shapes: (tokens, width, heads, shifted shift)
STAGES = [((16, 28, 28), 128, 4, (4, 3, 3)), ((16, 14, 14), 256, 8,
                                               (4, 3, 3)),
          ((16, 7, 7), 512, 16, (4, 0, 0))]
CARD = [(s, d, sh) for s in range(3) for d in ("bf16", "fp32")
        for sh in (False, True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused kernel is CUDA C++")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("stage, dtype, shifted", CARD,
                         ids=[f"stage{s + 1}-{d}-"
                              f"{'shifted' if sh else 'plain'}"
                              for s, d, sh in CARD])
def test_kernel_matches_plain_on_the_card(dev, stage, dtype, shifted):
    size, c, heads, shift = STAGES[stage]
    window = (8, 7, 7)
    shift = shift if shifted else (0, 0, 0)
    g = torch.Generator(device=dev).manual_seed(stage)
    qkv = torch.randn((2, *size, 3 * c), generator=g, device=dev)
    table = torch.randn((15 * 13 * 13, heads), generator=g, device=dev)
    index = window_attn.relative_position_index(window, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    exact = window_attn.window_attention_torch(qkv.double(), table.double(),
                                               index, heads, window, shift)
    if dtype == "fp32":
        got = window_attn_cuda(qkv, table, index, heads, window, shift,
                               window)
        assert (got.double() - exact).abs().max() < 1e-5 * exact.abs().max()
        return
    low = qkv.bfloat16()
    got = window_attn_cuda(low, table, index, heads, window, shift, window)
    torch.cuda.synchronize(dev)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        plain = window_attn.window_attention_torch(low, table, index, heads,
                                                   window, shift)
    # on the same bf16 inputs, the kernel is no further from float64 than
    # the plain route under autocast (its products and P in bf16)
    ref64 = window_attn.window_attention_torch(low.double(), table.double(),
                                               index, heads, window, shift)
    err = float((got.double() - ref64).abs().max())
    plain_err = float((plain.double() - ref64).abs().max())
    assert err <= max(2.0 * plain_err, 1e-2 * float(ref64.abs().max())), (
        err, plain_err)
    assert np.isfinite(err)


@pytest.mark.cuda
def test_kernel_shared_memory_is_the_sources(dev):
    from protoasnet_tpu_torch.ops import window_attn_cuda as mod

    lib = mod._lib()
    for elem in (2, 4):
        for n in (392, 36, 16):
            assert lib.window_attn_smem_bytes(int(elem == 2), n, 2535) == \
                smem_bytes(elem, n, 2535)


@pytest.mark.cuda
@pytest.mark.parametrize("size, window, shift, full", KERNEL_CASES,
                         ids=["shifted", "shifted-small", "t-shift-only",
                              "cut-window", "unshifted"])
def test_kernel_function_gradients_on_the_card(dev, size, window, shift,
                                               full):
    """``WindowAttnFunction`` at 32-wide heads, fp32: the output and both
    gradients against float64 autograd through the plain route."""
    from protoasnet_tpu_torch.ops import window_attn_cuda as mod

    heads, c = 2, 64
    qkv = _volume(2, size, c, heads, 3).to(dev).requires_grad_(True)
    table = _table(full, heads, 4).to(dev).requires_grad_(True)
    index = window_attn.relative_position_index(full, dev)
    g = torch.randn((2, *size, c), generator=torch.Generator()
                    .manual_seed(5)).to(dev)
    launches, calls = mod.window_attn_cuda.launches, \
        mod.window_attn_cuda.backward_calls
    torch.backends.cuda.matmul.allow_tf32 = False
    out = window_attn.window_attention(qkv, table, index, heads, window,
                                       shift, full)
    got = torch.autograd.grad(out, (qkv, table), g)
    assert mod.window_attn_cuda.launches == launches + 1
    assert mod.window_attn_cuda.backward_calls == calls + 1
    q64, t64 = (x.detach().double().requires_grad_(True)
                for x in (qkv, table))
    o64 = window_attn.window_attention_torch(q64, t64, index, heads, window,
                                             shift)
    want = torch.autograd.grad(o64, (q64, t64), g.double())
    assert (out.double() - o64).abs().max() <= 1e-5 * o64.abs().max()
    for a, b in zip(got, want):
        assert (a.double() - b).abs().max() <= 1e-5 * b.abs().max()


TINY32 = dict(TINY, embed_dim=32)  # heads of 32 at every stage


@pytest.mark.cuda
def test_train_micro_step_on_the_card(dev, monkeypatch):
    """One fp32 micro-step of a Swin with 32-wide heads on the card, TF32
    off, its attention through the kernel and its Function's backward:
    the loss and every gradient against the float64 reference."""
    from protoasnet_tpu_torch.ops import window_attn_cuda as mod

    monkeypatch.setitem(swin3d.SWIN3D_SPECS, "swin3d_b", TINY32)
    cfg = _cfg(8, 24, embed_dim=32)
    w = ref.make_weights(cfg, 99, "cpu")
    model = _port(cfg, w).to(dev)
    x = ref.gray_to_input(_gray(3, 8, 24, 10)).contiguous()
    t = torch.tensor([0, 1, 2])
    aff = (torch.tensor(7.0), torch.tensor(0.9))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod.window_attn_cuda.launches = mod.window_attn_cuda.backward_calls = 0
    got, port = _micro_step(model, cfg, x.to(dev), t.to(dev),
                            tuple(a.to(dev) for a in aff))
    # 2 + 2 + 2 blocks, on the clips and on their affine copies
    # (TransformLoss's second forward), each through the Function
    assert mod.window_attn_cuda.launches == 12
    assert mod.window_attn_cuda.backward_calls == 12
    want_loss, want = _reference_step(w, cfg, x, t, aff, monkeypatch)
    assert abs(float(got["loss_all"]) - want_loss) < 1e-5 * abs(want_loss)
    for name, g in want.items():
        err = (torch.as_tensor(port[name]).double().cpu()
               - g.reshape(port[name].shape)).abs().max()
        assert err <= 1e-3 * g.abs().max() + 1e-9, (name, float(err))
