"""The MViTv2 trunk (``models/backbones/mvit.py``) and its pooling attention
(``ops/pool_attn.py``, ``ops/pool_attn_cuda.py``) against the benchmark's
plain reference (``perfbench/reference/mvit_xprotonet.py``).

On the CPU, at a tiny MViT (width 8, depths (1, 2, 2) kept of (1, 2, 2, 1),
k and v pooled at (1, 4, 4) in stage 1, clips of 8x56x56: tokens 4x14x14,
so k sides of 4 against q sides of 14 and 7, ratios of 3.5 and 1.75, and a
stage-3 q side of 4 against k sides of 7) built as ``mvit_v2_b`` with its
spec patched, from the reference's seeded weights handed through the
importer:
- the plain pooling attention against a loop over every (query, key) pair
  at fractional side ratios (q 7 against k 4, and k 7 against q 4): the
  class token's row and column, the positional terms, the residual pooling;
- the kernel's arithmetic (the tables times d^1/2 in a row, the index
  table, the table products gathered into 32 more columns of q, the keys'
  one-hot columns) emulated in torch against the plain route;
- fp32 logits, similarities and occurrence maps within 1e-5 of the
  largest (sums in another order); the bf16 served path (uint8 gray in);
- the trunk's shapes at the published widths on 32x112x112 clips, on meta
  tensors (the table of the configuration's blocks);
- the importer's key map both ways; ``mvit_v2_b`` against the
  configuration file; the cut; the init; a clip of another size refused;
- one train micro-step (float64, stochastic depth 0): its loss and every
  gradient against autograd through the reference; the kernel's backward
  (the plain route recomputed in fp32, a clip at a time) against autograd;
- int8, the push and the local explanation refused on both transformer
  trunks; the counters ``mvit.pool_attn(.plain)``, one a block.
On the card (``cuda`` marker): the kernel against float64 at the five call
shapes of the served trunk at batch 128, bf16 (fp32 and bf16 inputs) and
fp32; ``smem_bytes`` against the library's own number; the wrapper's
refusals; the launch counter; ``PoolAttnFunction``'s gradients; one served
batch through ``make_serving_fn`` counting ``mvit.pool_attn`` 21 times;
the kernel's, the plain route's and the library's times beside the bound;
one fp32 train micro-step on the card against the float64 reference.
"""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.reference import mvit_xprotonet as ref
from perfbench.reference import xprotonet as xp_ref
from protoasnet_tpu_torch.models.backbones import mvit, swin3d
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.migrate import (convert_reference_state_dict,
                                                 export_reference_state_dict)
from protoasnet_tpu_torch.ops import pool_attn
from protoasnet_tpu_torch.ops.pool_attn_cuda import (index_table,
                                                    kernel_tables,
                                                    pool_attn_cuda,
                                                    smem_bytes)
from protoasnet_tpu_torch.utils import profiling
from torch_port_isolation import isolated

_isolated = isolated(2)

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "perfbench/configs/mvit/protoasnet_video_mvitv2_b.json"
FULL = json.loads(CONFIG.read_text())
TINY = dict(mvit.MVIT_SPECS["mvit_v2_b"], embed_dim=8, depths=(1, 2, 2, 1),
            kv_stride=(1, 4, 4), stochastic_depth_prob=0.0,
            input_size=(8, 56, 56))
CFG = {"name": "Video_XProtoNet", "base_architecture": "mvit_v2_b",
       "backbone_last_layer_num": -3, "prototype_shape": "(8, 16, 1, 1, 1)",
       "num_classes": 4, "dtype": "float32", "img_size": 56, "frames": 8,
       "batch_size": 3, "accumulation_steps": 2,
       **{k: list(v) if isinstance(v, tuple) else v
          for k, v in TINY.items() if k != "input_size"},
       "criterion": {"CeLossAbstain": {"loss_weight": 1, "ab_weight": 0.3},
                     "ClusterRoiFeat": {"loss_weight": 0.8},
                     "SeparationRoiFeat": {"loss_weight": 0.08},
                     "OrthogonalityLoss": {"loss_weight": 0.01},
                     "Lnorm_occurrence": {"loss_weight": 0.01, "p": 2},
                     "trans_occurrence": {"loss_weight": 0.001},
                     "Lnorm_FC": {"loss_weight": 0.0001, "p": 1}}}
# (Lq, Lk, width, heads) of each block at 32x112x112 (the configuration)
SERVED = ([(12545, 257, 96, 1)] * 2 + [(3137, 785, 192, 2)]
          + [(3137, 257, 192, 2)] * 2 + [(785, 785, 384, 4)]
          + [(785, 257, 384, 4)] * 15)


@pytest.fixture
def tiny(monkeypatch):
    """``mvit_v2_b`` at the tiny widths for this test."""
    monkeypatch.setitem(mvit.MVIT_SPECS, "mvit_v2_b", TINY)


def _port(cfg, w, dtype="float32"):
    mcfg = dict(cfg, dtype=dtype)
    model = build_model(mcfg, device="cpu")
    model.load_state_dict(convert_reference_state_dict(w, mcfg))
    return model


def _gray(n, frames, side, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, frames, side, side), generator=g,
                         dtype=torch.uint8)


def _attn_inputs(n, q_thw, k_thw, d, seed, dtype=torch.float64,
                 device="cpu"):
    """Class and spatial tokens of q, k, v and the three tables."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64).to(
            device=device, dtype=dtype)

    toks = [rand(n, d), rand(n, *q_thw, d), rand(n, d), rand(n, *k_thw, d),
            rand(n, d), rand(n, *k_thw, d)]
    tables = [rand(pool_attn.table_rows(q, k), d) / math.sqrt(d)
              for q, k in zip(q_thw, k_thw)]
    return toks, tables


# (q sides, k sides): q 7 against k 4 (ratio 1.75) and q 4 against k 7
RATIOS = [((2, 7, 7), (2, 4, 4)), ((3, 4, 4), (2, 7, 7))]


@pytest.mark.parametrize("q_thw, k_thw", RATIOS, ids=["q7-k4", "q4-k7"])
def test_plain_attention_matches_a_loop(q_thw, k_thw):
    """Every pair's logit written out: q·k/√d, plus, between spatial
    tokens, q·R_a[idx] per axis with idx = floor(i·max(k/q, 1) - j·max(q/k,
    1) + (k - 1)·max(q/k, 1)); softmax; ·v; q added to the spatial rows."""
    heads, d = 2, 4
    toks, tables = _attn_inputs(2 * heads, q_thw, k_thw, d, 1)
    got = pool_attn.pool_attention_torch(*toks, *tables, heads)
    q_cls, q_sp, k_cls, k_sp, v_cls, v_sp = toks

    def coords(size):
        return [None] + [(t, h, w) for t in range(size[0])
                         for h in range(size[1]) for w in range(size[2])]

    def idx(i, j, q, k):
        return math.floor(i * max(k / q, 1) - j * max(q / k, 1)
                          + (k - 1) * max(q / k, 1))

    qc, kc = coords(q_thw), coords(k_thw)
    for row in range(2 * heads):
        qs = [q_cls[row]] + [q_sp[row][c] for c in qc[1:]]
        ks = [k_cls[row]] + [k_sp[row][c] for c in kc[1:]]
        vs = torch.stack([v_cls[row]] + [v_sp[row][c] for c in kc[1:]])
        for i, qi in enumerate(qs):
            logits = []
            for j, kj in enumerate(ks):
                logit = float(qi @ kj) / math.sqrt(d)
                if i and j:
                    for ax in range(3):
                        r = idx(qc[i][ax], kc[j][ax], q_thw[ax], k_thw[ax])
                        logit += float(qi @ tables[ax][r])
                logits.append(logit)
            o = torch.softmax(torch.tensor(logits, dtype=torch.float64),
                              0) @ vs
            if i:
                o = o + qi
            b, head = divmod(row, heads)
            torch.testing.assert_close(got[b, i, head * d:(head + 1) * d], o,
                                       rtol=1e-10, atol=1e-12)


def _kernel_emulated(toks, tables, heads):
    """The kernel's arithmetic in torch: the tables times d^1/2 in a row
    (each axis rounded up to 8 rows), the tile's products with them, the
    index table's gather into 32 more columns of q, each key's one-hot of
    its coordinates in 32 more columns of k, the product of the two over
    128 columns times d^-1/2, softmax, ·v, the residual."""
    q_cls, q_sp, k_cls, k_sp, v_cls, v_sp = toks
    n, qt, qh, qw, d = q_sp.shape
    kt, kh, kw = k_sp.shape[1:4]
    tab = kernel_tables(*tables, torch.float64)
    idx = index_table((qt, qh, qw), (kt, kh, kw), "cpu").long()
    rows = [t.shape[0] for t in tables]
    offs = [0, -(-rows[0] // 8) * 8]
    offs.append(offs[1] + -(-rows[1] // 8) * 8)
    i_offs = [0, qt * kt, qt * kt + qh * kh]
    ksz, qsz = (kt, kh, kw), (qt, qh, qw)
    lq, lk = 1 + qt * qh * qw, 1 + kt * kh * kw
    out = torch.empty(n // heads, lq, heads * d, dtype=q_sp.dtype)
    for row in range(n):
        q = torch.cat([q_cls[row][None], q_sp[row].reshape(-1, d)])
        prod = q @ tab.t()  # (Lq, every table row)
        rel = torch.zeros(lq, 32, dtype=q.dtype)
        for i in range(1, lq):
            s = i - 1
            c3 = (s // (qh * qw), (s // qw) % qh, s % qw)
            col = 0
            for ax in range(3):
                for k in range(ksz[ax]):
                    r = idx[i_offs[ax] + c3[ax] * ksz[ax] + k]
                    rel[i, col + k] = prod[i, offs[ax] + r]
                col += ksz[ax]
        hot = torch.zeros(lk, 32, dtype=q.dtype)
        for j in range(1, lk):
            s = j - 1
            for c in (s // (kh * kw), kt + (s // kw) % kh,
                      kt + kh + s % kw):
                hot[j, c] = 1.0
        k = torch.cat([torch.cat([k_cls[row][None],
                                  k_sp[row].reshape(-1, d)]), hot], 1)
        v = torch.cat([v_cls[row][None], v_sp[row].reshape(-1, d)])
        logits = torch.cat([q, rel], 1) @ k.t() * d ** -0.5
        o = torch.softmax(logits, -1) @ v
        o[1:] += q[1:]
        b, head = divmod(row, heads)
        out[b, :, head * d:(head + 1) * d] = o
    return out


@pytest.mark.parametrize("q_thw, k_thw",
                         RATIOS + [((4, 14, 14), (4, 4, 4))],
                         ids=["q7-k4", "q4-k7", "q14-k4"])
def test_kernel_arithmetic_matches_plain(q_thw, k_thw):
    heads, d = 2, 96
    toks, tables = _attn_inputs(2 * heads, q_thw, k_thw, d, 3)
    want = pool_attn.pool_attention_torch(*toks, *tables, heads)
    got = _kernel_emulated(toks, tables, heads)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_index_rule():
    assert pool_attn.rel_index(28, 4).tolist()[0] == [21, 14, 7, 0]
    assert pool_attn.rel_index(28, 4).max() == 48  # 55 rows: 2·28 - 1
    # q 7 against k 4: i - 1.75 j + 5.25, truncated
    assert pool_attn.rel_index(7, 4)[:, 0].tolist() == [5, 6, 7, 8, 9, 10,
                                                        11]
    assert pool_attn.rel_index(7, 4)[0].tolist() == [5, 3, 1, 0]
    assert pool_attn.rel_index(16, 16)[0].tolist() == list(range(15, -1, -1))
    got = index_table((16, 28, 28), (16, 4, 4), "cpu")
    assert got.dtype == torch.int32 and got.numel() == 16 * 16 + 2 * 28 * 4


def test_trunk_shapes_at_the_published_widths():
    """MViTv2-B cut after stage 3, on 32x112x112 clips, on meta tensors:
    each block's query and key lengths, width and heads, and the output."""
    trunk = mvit.MViT(**mvit.MVIT_SPECS["mvit_v2_b"]).to("meta")
    seen = []

    def hook(module, args, out):
        (q_cls, q_sp, k_cls, k_sp, *_), heads = args[:10], args[9]
        seen.append((1 + math.prod(q_sp.shape[1:4]),
                     1 + math.prod(k_sp.shape[1:4]), out.shape[-1], heads))
        return out

    orig = mvit.pool_attention
    try:
        mvit.pool_attention = lambda *a: hook(None, a, orig(*a))
        out = trunk(torch.empty(2, 32, 112, 112, 3, device="meta"))
    finally:
        mvit.pool_attention = orig
    assert seen == SERVED
    assert tuple(out.shape) == (2, 16, 7, 7, 384)
    assert trunk.out_channels == 384
    assert all(b.attn.head_dim == 96 for b in trunk.blocks)


@pytest.mark.parametrize("batch", [2, 3])
def test_forward_matches_reference(tiny, batch):
    cfg = dict(CFG)
    w = ref.make_weights(cfg, 1234, "cpu")
    model = _port(cfg, w)
    gray = _gray(batch, 8, 56, 5)
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


def test_importer_both_ways(tiny):
    w = ref.make_weights(CFG, 7, "cpu")
    sd = convert_reference_state_dict(w, CFG)
    model = build_model(CFG, device="cpu")
    assert set(sd) == set(model.state_dict())
    back = export_reference_state_dict(sd, CFG)
    assert set(back) == set(w) | {"ones"}  # as for every Video_XProtoNet
    for k, v in w.items():
        assert torch.equal(torch.as_tensor(back[k]), v), k
    for key in ("conv_proj.weight", "pos_encoding.class_token",
                "blocks.0.attn.pool_q.pool.weight",
                "blocks.0.attn.pool_k.norm_act.0.bias",
                "blocks.1.attn.rel_pos_t", "blocks.1.attn.project.0.weight",
                "blocks.1.project.weight", "blocks.4.mlp.3.bias"):
        assert "cnn_backbone." + key in sd, key


def test_mvit_v2_b_is_the_configuration_files():
    spec = mvit.MVIT_SPECS["mvit_v2_b"]
    for key, value in spec.items():
        if key == "input_size":
            assert list(value) == [FULL["frames"], FULL["img_size"],
                                   FULL["img_size"]]
            continue
        assert (list(value) if isinstance(value, tuple) else value) == \
            FULL[key], key
    assert FULL["base_architecture"] == "mvit_v2_b"
    assert FULL["backbone_last_layer_num"] == -3
    trunk = mvit.MViT(**spec).to("meta")
    norms = [m for m in trunk.modules() if isinstance(m, torch.nn.LayerNorm)]
    assert {m.eps for m in norms} == {FULL["layer_norm_eps"]}
    assert all(b.attn.qkv.bias is not None for b in trunk.blocks)


def test_the_cut():
    three = mvit.MViT(**TINY, last_layer_num=-3)
    four = mvit.MViT(**TINY, last_layer_num=-2)
    assert (three.out_channels, len(three.blocks)) == (32, 5)
    assert (four.out_channels, len(four.blocks)) == (64, 6)
    x = torch.randn(1, 8, 56, 56, 3)
    with torch.no_grad():
        assert three(x).shape == (1, 4, 4, 4, 32)
        assert four(x).shape == (1, 4, 2, 2, 64)
    for bad in (-1, -4, 3):
        with pytest.raises(ValueError, match="cut"):
            mvit.MViT(**TINY, last_layer_num=bad)
    with pytest.raises(ValueError, match="sized for clips"):
        three(torch.zeros(1, 8, 64, 64, 3))


def test_the_init_is_torchvisions(tiny):
    """Linears, positional tables and the class token N(0, 0.02)
    (trunc-normal at its default cut, +-2 absolute), Linear biases 0,
    LayerNorms 1 and 0."""
    model = build_model(CFG, device="cpu", seed=3)
    trunk = model.cnn_backbone
    lin = torch.cat([m.weight.detach().reshape(-1) for m in trunk.modules()
                     if isinstance(m, torch.nn.Linear)])
    tabs = torch.cat([p.detach().reshape(-1) for n, p in
                      trunk.named_parameters() if ".rel_pos_" in n]
                     + [trunk.pos_encoding.class_token.detach()])
    for w in (lin, tabs):
        assert abs(float(w.std()) - 0.02) < 0.003 and float(w.abs().max()) < 2
    mods = list(trunk.modules())
    assert all(float(m.bias.detach().abs().max()) == 0 for m in mods
               if isinstance(m, torch.nn.Linear))
    assert all(bool((m.weight == 1).all()) and bool((m.bias == 0).all())
               for m in mods if isinstance(m, torch.nn.LayerNorm))


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
    w = ref.make_weights(CFG, 99, "cpu")
    model = _port(CFG, w).double()
    x = ref.gray_to_input(_gray(3, 8, 56, 10)).double().contiguous()
    t = torch.tensor([0, 1, 2])
    aff = (torch.tensor(7.0), torch.tensor(0.9))
    got, port = _micro_step(model, CFG, x, t, aff)
    want_loss, want = _reference_step(w, CFG, x, t, aff, monkeypatch)
    assert abs(float(got["loss_all"]) - want_loss) < 1e-9 * abs(want_loss)
    for name, g in want.items():
        torch.testing.assert_close(torch.as_tensor(port[name]).double(),
                                   g.reshape(port[name].shape), rtol=1e-7,
                                   atol=1e-10, msg=name)


def test_kernel_backward_matches_autograd(monkeypatch):
    """``pool_attention_backward`` (the kernel's backward: the plain route
    recomputed in fp32, here one clip a run) against autograd through the
    plain route, float64 inputs."""
    heads = 2
    toks, tables = _attn_inputs(3 * heads, (2, 7, 7), (2, 4, 4), 8, 7)
    inputs = [t.requires_grad_(True) for t in toks + tables]
    g = torch.randn((3, 1 + 2 * 49, heads * 8), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(9))
    out = pool_attn.pool_attention_torch(*inputs, heads)
    want = torch.autograd.grad(out, inputs, g)
    monkeypatch.setattr(pool_attn, "BACKWARD_BYTES", 1)
    got = pool_attn.pool_attention_backward(
        [t.detach() for t in inputs], heads, g)
    assert len(got) == 9
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_kernel_limits_and_refusal_off_the_card():
    """The served shapes fit the kernel: keys' sides sum to at most 32,
    tables of at most 64 rows; shared memory within a block's 227 KB; a CPU
    tensor is refused (the plain route is the CPU's)."""
    for s in mvit.block_schedule(**mvit.MVIT_SPECS["mvit_v2_b"], stages=4):
        assert sum(s["kv_thw"]) <= 32
        assert max(pool_attn.table_rows(q, k)
                   for q, k in zip(s["q_thw"], s["kv_thw"])) <= 64
    assert smem_bytes(2) <= 232448 and smem_bytes(4) <= 232448
    toks, tables = _attn_inputs(1, (2, 2, 2), (2, 2, 2), 96, 0,
                                torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        pool_attn_cuda(*toks, *tables, 1)


def test_int8_push_and_explain_are_refused(tiny, monkeypatch):
    """One refusal for both transformer trunks, each naming its trunk and
    what it refuses."""
    from protoasnet_tpu_torch.quant import (calibrate_act_scales,
                                            quantized_model)
    from protoasnet_tpu_torch.train.agents.xprotonet import \
        _XProtoNetAgentCommon

    monkeypatch.setitem(swin3d.SWIN3D_SPECS, "swin3d_b", dict(
        patch_size=(2, 4, 4), embed_dim=8, depths=(1, 1, 1, 1),
        num_heads=(1, 1, 2, 2), window_size=(2, 2, 2)))
    for arch, name in (("mvit_v2_b", "MViTv2 trunk (mvit_v2_b)"),
                       ("swin3d_b", "Swin3D trunk (swin3d_b)")):
        model = build_model(dict(CFG, base_architecture=arch), device="cpu")
        x = torch.zeros(1, 8, 56, 56, 3)
        with pytest.raises(NotImplementedError, match=r"int8.*" + name[:6]):
            calibrate_act_scales(model, [x])
        with pytest.raises(NotImplementedError, match="int8"):
            quantized_model(model, {})
        stub = SimpleNamespace(model=model)
        with pytest.raises(NotImplementedError, match=r"push.*" + name[:6]):
            _XProtoNetAgentCommon.push(stub)
        with pytest.raises(NotImplementedError, match="explain"):
            _XProtoNetAgentCommon.explain_local(stub)


def test_each_blocks_attention_counts_once(tiny):
    model = build_model(CFG, device="cpu")
    x = torch.zeros(1, 8, 56, 56, 3)
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
    assert counts == [{"mvit.pool_attn.plain": 5}]  # 1 + 2 + 2 blocks


# --- on the card ----------------------------------------------------------

# the five call shapes of the served trunk: (q sides, k sides, heads)
CALLS = [((16, 28, 28), (16, 4, 4), 1), ((16, 14, 14), (16, 7, 7), 2),
         ((16, 14, 14), (16, 4, 4), 2), ((16, 7, 7), (16, 7, 7), 4),
         ((16, 7, 7), (16, 4, 4), 4)]
# compute, input: fp32 (3xTF32), bf16 from fp32 input (the served trunk
# under autocast), bf16 from bf16 input
KINDS = [("fp32", torch.float32), ("bf16", torch.float32),
         ("bf16", torch.bfloat16)]
CARD_BATCH = 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused kernel is CUDA C++")
    return torch.device("cuda:0")


def _card_inputs(dev, call, seed, dtype, batch=CARD_BATCH):
    q_thw, k_thw, heads = call
    toks, tables = _attn_inputs(batch * heads, q_thw, k_thw, 96, seed,
                                torch.float32, dev)
    toks = [t.to(dtype) for t in toks]
    return toks, tables, heads


def _float64(toks, tables, heads):
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        return pool_attn.pool_attention_torch(
            *[t.double() for t in toks], *[t.double() for t in tables], heads)


@pytest.mark.cuda
@pytest.mark.parametrize("call", range(5))
@pytest.mark.parametrize("kind", range(3), ids=["fp32", "bf16-from-fp32",
                                                 "bf16"])
def test_kernel_matches_float64_on_the_card(dev, call, kind):
    """At each served call shape at batch 128, every clip: fp32 within
    1e-5 of the largest |reference| (3xTF32 keeps ~fp32 products; the sums
    in another order); bf16 no further from float64 than the plain route
    under autocast on the same inputs (its products, its positional terms
    and P in bf16), and within 1e-2 of the largest |reference|."""
    compute, dtype = KINDS[kind]
    toks, tables, heads = _card_inputs(dev, CALLS[call], call, dtype)
    exact = _float64(toks, tables, heads)
    scale = float(exact.abs().max())
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16,
                                         enabled=compute == "bf16"):
        got = pool_attn_cuda(*toks, *tables, heads)
        want_dtype = torch.float32 if compute == "fp32" else torch.bfloat16
        assert got.dtype == want_dtype
        torch.cuda.synchronize(dev)
        err = float((got.double() - exact).abs().max())
        if compute == "fp32":
            assert err < 1e-5 * scale, err
            return
        plain = pool_attn.pool_attention_torch(*toks, *tables, heads)
    plain_err = float((plain.double() - exact).abs().max())
    assert err <= max(2.0 * plain_err, 1e-3 * scale), (err, plain_err)
    assert err < 1e-2 * scale, err


@pytest.mark.cuda
def test_kernel_shared_memory_is_the_sources(dev):
    """``smem_bytes`` mirrors the source's layout: the library's own
    number for bf16 and fp32."""
    from protoasnet_tpu_torch.ops import pool_attn_cuda as mod

    lib = mod._lib()
    for elem in (2, 4):
        assert lib.pool_attn_smem_bytes(int(elem == 2)) == smem_bytes(elem)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(dev):
    toks, tables, heads = _card_inputs(dev, CALLS[4], 0, torch.float32, 2)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        pool_attn_cuda(*[t.half() for t in toks], *tables, heads)
    with pytest.raises(ValueError, match="96 wide"):
        pool_attn_cuda(*[t[..., :64] for t in toks],
                       *[t[:, :64] for t in tables], heads)
    with pytest.raises(ValueError, match="table"):
        pool_attn_cuda(*toks, tables[0][:-1], *tables[1:], heads)
    with pytest.raises(ValueError, match="heads"):
        pool_attn_cuda(*toks, *tables, 3)
    big, big_tables = _attn_inputs(1, (2, 2, 2), (2, 20, 20), 96, 0,
                                   torch.float32, dev)
    with pytest.raises(ValueError, match="limits"):
        pool_attn_cuda(*big, *big_tables, 1)


@pytest.mark.cuda
def test_launch_counter_and_gradients(dev):
    """One launch a call; ``PoolAttnFunction``'s output and every gradient
    against float64 autograd through the plain route (fp32, TF32 off)."""
    from protoasnet_tpu_torch.ops import pool_attn_cuda as mod

    toks, tables, heads = _card_inputs(dev, CALLS[4], 5, torch.float32, 3)
    inputs = [t.requires_grad_(True) for t in toks + tables]
    g = torch.randn((3, 785, 4 * 96), device=dev)
    launches, calls = mod.pool_attn_cuda.launches, \
        mod.pool_attn_cuda.backward_calls
    torch.backends.cuda.matmul.allow_tf32 = False
    out = pool_attn.pool_attention(*inputs, heads)
    got = torch.autograd.grad(out, inputs, g)
    assert mod.pool_attn_cuda.launches == launches + 1
    assert mod.pool_attn_cuda.backward_calls == calls + 1
    x64 = [t.detach().double().requires_grad_(True) for t in inputs]
    o64 = pool_attn.pool_attention_torch(*x64, heads)
    want = torch.autograd.grad(o64, x64, g.double())
    assert (out.double() - o64).abs().max() <= 1e-5 * o64.abs().max()
    for a, b in zip(got, want):
        assert (a.double() - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.cuda
def test_a_served_batch_counts_21_fused_attentions(dev):
    """The configuration's model (random init) served through
    ``make_serving_fn``: one batch, 21 blocks' attention through the kernel
    and none through the plain route, counted on the open span."""
    import numpy as np

    from protoasnet_tpu_torch.ops import pool_attn_cuda as mod
    from protoasnet_tpu_torch.serve import make_serving_fn

    model = build_model(FULL, device="cpu", seed=1).to(dev)
    fn = make_serving_fn(model, uint8_gray=True)
    x = np.random.default_rng(0).integers(0, 256, (2, 32, 112, 112),
                                          dtype=np.uint8)
    launches = mod.pool_attn_cuda.launches
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("batcher.batch"):
            out = fn(x)
    counts = [s["counts"] for s in profiling.spans()
              if s["name"] == "batcher.batch"]
    profiling.reset()
    assert out.shape == (2, 4) and np.isfinite(out).all()
    assert counts == [{"mvit.pool_attn": 21}]
    assert mod.pool_attn_cuda.launches == launches + 21


def _time_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.cuda
@pytest.mark.parametrize("call", range(5))
def test_kernel_times_beside_its_bound(dev, call, capsys):
    """Batch 128, bf16 from fp32 inputs as the served trunk calls it (CUDA
    events, 10 calls): the kernel, the plain route under autocast, and the
    library's attention (``F.scaled_dot_product_attention``) with the
    positional terms as a materialised (N, Lq, Lk) bf16 bias, its class
    tokens put back and its residual added, beside the bound of
    ``perfbench/kernels/pool_attn.py``. Prints one JSON line a shape; the
    kernel must come out faster than the plain route."""
    import torch.nn.functional as F

    from perfbench.kernels import pool_attn as work

    toks, tables, heads = _card_inputs(dev, CALLS[call], call,
                                       torch.float32)
    q_cls, q_sp, k_cls, k_sp, v_cls, v_sp = toks
    n, d = q_cls.shape

    def library():
        q = pool_attn._tokens(q_cls, q_sp)
        bias = F.pad(pool_attn.decomposed_rel_pos(
            q_sp, k_sp.shape[1:4], *tables), (1, 0, 1, 0))
        o = F.scaled_dot_product_attention(
            q[:, None], pool_attn._tokens(k_cls, k_sp)[:, None],
            pool_attn._tokens(v_cls, v_sp)[:, None], attn_mask=bias[:, None])
        return o[:, 0] + F.pad(q[:, 1:], (0, 0, 1, 0))

    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        kernel_ms = _time_ms(lambda: pool_attn_cuda(*toks, *tables, heads))
        plain_ms = _time_ms(lambda: pool_attn.pool_attention_torch(
            *toks, *tables, heads), 3)
        library_ms = _time_ms(library, 3)
    q_thw, k_thw, _ = CALLS[call]
    peak = {"hbm_bytes_per_s": 3.35e12, "bf16_flops_per_s": 989.4e12}
    bound_ms = 1e3 * work.call_bound_s(
        CARD_BATCH, work.call_of(q_thw, k_thw, heads, 96), 4, 2, peak)
    with capsys.disabled():
        print(json.dumps({"call": list(CALLS[call][:2]), "heads": heads,
                          "batch": CARD_BATCH, "kernel_ms": kernel_ms,
                          "plain_ms": plain_ms, "library_ms": library_ms,
                          "bound_ms": bound_ms,
                          "device": torch.cuda.get_device_name(dev)}))
    assert kernel_ms < plain_ms


TINY96 = dict(TINY, embed_dim=96)  # heads of 96 at every stage


@pytest.mark.cuda
def test_train_micro_step_on_the_card(dev, monkeypatch):
    """One fp32 micro-step of an MViT with 96-wide heads on the card, TF32
    off, its attention through the kernel and its Function's backward:
    the loss and every gradient against the float64 reference."""
    from protoasnet_tpu_torch.ops import pool_attn_cuda as mod

    monkeypatch.setitem(mvit.MVIT_SPECS, "mvit_v2_b", TINY96)
    cfg = dict(CFG, embed_dim=96)
    w = ref.make_weights(cfg, 99, "cpu")
    model = _port(cfg, w).to(dev)
    x = ref.gray_to_input(_gray(3, 8, 56, 10)).contiguous()
    t = torch.tensor([0, 1, 2])
    aff = (torch.tensor(7.0), torch.tensor(0.9))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mod.pool_attn_cuda.launches = mod.pool_attn_cuda.backward_calls = 0
    got, port = _micro_step(model, cfg, x.to(dev), t.to(dev),
                            tuple(a.to(dev) for a in aff))
    # 1 + 2 + 2 blocks, on the clips and on their affine copies
    # (TransformLoss's second forward), each through the Function
    assert mod.pool_attn_cuda.launches == 10
    assert mod.pool_attn_cuda.backward_calls == 10
    want_loss, want = _reference_step(w, cfg, x, t, aff, monkeypatch)
    assert abs(float(got["loss_all"]) - want_loss) < 1e-5 * abs(want_loss)
    for name, g in want.items():
        err = (torch.as_tensor(port[name]).double().cpu()
               - g.reshape(port[name].shape)).abs().max()
        scale = g.abs().max()
        if name.endswith("pool_k.norm_act.0.bias"):
            # zero in exact arithmetic (a shift of every key moves every
            # logit of a row alike, and the softmax ignores it): fp32 leaves
            # rounding of the size of the terms that cancel, which the
            # norm's weight's gradient has
            scale = want[name[:-len("bias")] + "weight"].abs().max()
            assert err <= 1e-5 * scale, (name, float(err))
            continue
        assert err <= 1e-3 * scale + 1e-9, (name, float(err))
