"""The port's w8a8 quantisation (``protoasnet_tpu_torch/quant.py``,
``ops/int8_conv.py``) against the JAX package's ``quant.py``.

- The int8 conv at every geometry of the trunks (3-D (1,3,3) and (3,1,1)
  at stride 1 and 2, (1,1,1) at stride 2, (3,3,3) at stride 1 and 2, R3D's
  (3,7,7) stem; 2-D 7x7 stride 2, 3x3 and 1x1), with K and N off
  multiples of 8: the plain version's int32 sums bit-equal to
  ``lax.conv_general_dilated(int8, int8, preferred_element_type=int32)``
  on the same codes, and the card's algorithm (im2col GEMMs, run here on
  the CPU's ``torch._int_mm``, chunked and not) bit-equal to the plain
  version.
- A tiny flagship (8 frames of 32x32, P=8, D=64), trained 4 steps by the
  JAX package as ``tests/test_quant.py`` trains it, carried over by
  ``models/from_jax.py``: ``calibrate_act_scales`` on the same two batches
  gives the JAX keys (no ``stem_spatial``, > 20 convs) and scales within
  rtol 1e-5; ``build_qstate`` from the JAX scales gives bit-equal ``w_q``
  and ``w_scale`` and ``fold_m``/``fold_b`` within rtol 1e-6 (and 1e-6
  of each array's largest entry, where ``fold_b`` cancels to near 0);
  ``apply_quantized`` at the JAX qstate, both packages in float64, within
  1e-5 of max |logit|, folded and unfolded; at fp32 the fidelity limits of
  ``tests/test_quant.py`` against the port's own float forward; an empty
  qstate gives the float forward bit for bit.
- The golden single-conv math and the golden Conv2Plus1D fold of
  ``tests/test_quant.py``, on the port.
- The 2-D trunks (ResNet-18 XProtoNet, VGG-11 PPNet with a filter that
  takes its ``features``) quantise and match the JAX package in float64.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from torch import nn

from protoasnet_tpu import quant as jq
from protoasnet_tpu.models.builder import build_model as jax_build_model
from protoasnet_tpu.models.builder import init_model
from protoasnet_tpu_torch.models.builder import build_model
from protoasnet_tpu_torch.models.from_jax import load_jax_variables
from protoasnet_tpu_torch.ops import int8_conv as ic
from protoasnet_tpu_torch.quant import (apply_quantized, build_qstate,
                                        calibrate_act_scales,
                                        qstate_from_arrays, qstate_to_arrays,
                                        quantized_model)

torch.set_num_threads(1)

# (C, O, kernel, stride, padding, spatial): every int8 conv geometry of
# the trunks, channel counts off multiples of 8 among them
GEOMETRIES = {
    "spatial_s1": (45, 144, (1, 3, 3), (1, 1, 1), (0, 1, 1), (4, 9, 9)),
    "spatial_s2": (13, 230, (1, 3, 3), (1, 2, 2), (0, 1, 1), (4, 9, 9)),
    "temporal_s1": (45, 64, (3, 1, 1), (1, 1, 1), (1, 0, 0), (5, 6, 6)),
    "temporal_s2": (230, 12, (3, 1, 1), (2, 1, 1), (1, 0, 0), (5, 6, 6)),
    "downsample": (16, 24, (1, 1, 1), (2, 2, 2), (0, 0, 0), (5, 6, 7)),
    "full3d_s1": (9, 12, (3, 3, 3), (1, 1, 1), (1, 1, 1), (4, 6, 6)),
    "full3d_s2": (9, 20, (3, 3, 3), (2, 2, 2), (1, 1, 1), (5, 7, 6)),
    "r3d_stem": (3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), (4, 12, 12)),
    "stem_2d": (3, 64, (7, 7), (2, 2), (3, 3), (15, 15)),
    "conv3x3": (3, 27, (3, 3), (1, 1), (1, 1), (7, 7)),
    "conv1x1": (21, 32, (1, 1), (1, 1), (0, 0), (5, 5)),
}
_DN = {2: ("NHWC", "HWIO", "NHWC"), 3: ("NDHWC", "DHWIO", "NDHWC")}


def _codes(geom, seed=0):
    c, o, k, _, _, sp = geom
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, size=(3, c, *sp)).astype(np.int8)
    w = rng.integers(-127, 128, size=(o, c, *k)).astype(np.int8)
    return x, w


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_int8_conv_plain_is_lax_int32(name):
    geom = GEOMETRIES[name]
    _, _, _, stride, pad, _ = geom
    x, w = _codes(geom)
    nd = x.ndim - 2
    got = ic.int8_conv_torch(torch.from_numpy(x), torch.from_numpy(w),
                             stride, pad)
    xl = np.moveaxis(x, 1, -1)
    wl = np.transpose(w, (*range(2, 2 + nd), 1, 0))
    want = lax.conv_general_dilated(
        jnp.asarray(xl), jnp.asarray(wl), stride, [(p, p) for p in pad],
        dimension_numbers=lax.conv_dimension_numbers(xl.shape, wl.shape,
                                                     _DN[nd]),
        preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 1, -1),
                                  np.asarray(want))


@pytest.mark.parametrize("chunk", ["whole", "chunked"])
@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_int8_gemm_route_is_the_plain_version(name, chunk, monkeypatch):
    """The card version's algorithm (padding, im2col, chunks, epilogue)
    on the CPU's ``torch._int_mm``."""
    if chunk == "chunked":  # one sample a chunk
        monkeypatch.setattr(ic, "CHUNK_BYTES", 1)
    geom = GEOMETRIES[name]
    x, w = (torch.from_numpy(a) for a in _codes(geom, 1))
    stride, pad = geom[3], geom[4]
    want = ic.int8_conv_torch(x, w, stride, pad)
    before = ic.LAUNCHES
    got = ic._gemm_conv(x, w, stride, pad, None)
    assert torch.equal(got, want)
    assert ic.LAUNCHES - before == (3 if chunk == "chunked" else 1)
    scale = torch.rand(geom[1])
    assert torch.equal(ic._gemm_conv(x, w, stride, pad, lambda y: y * scale),
                       ic.int8_conv(x, w, stride, pad, lambda y: y * scale))


def test_int8_conv_refuses_what_it_cannot_compute():
    x = torch.zeros(2, 8, 5, 5, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        ic.int8_conv(x.float(), torch.zeros(8, 8, 3, 3, dtype=torch.int8),
                     1, 1)
    with pytest.raises(ValueError, match="groups"):
        ic.int8_conv(x, torch.zeros(8, 4, 3, 3, dtype=torch.int8), 1, 1)
    with pytest.raises(ValueError, match="exact"):
        ic.int8_conv(torch.zeros(1, 20000, 3, 3, dtype=torch.int8),
                     torch.zeros(8, 20000, 3, 3, dtype=torch.int8), 1, 1)
    with pytest.raises(ValueError, match="multiples of 8"):
        ic.int_mm(torch.zeros(32, 27, dtype=torch.int8),
                  torch.zeros(27, 8, dtype=torch.int8))
    with pytest.raises(RuntimeError, match="CUDA"):
        ic.int8_conv_cuda(x, torch.zeros(8, 8, 3, 3, dtype=torch.int8), 1,
                          1)


def test_single_conv_golden_math():
    """The quantised conv == quantise -> int conv -> dequantise, as
    ``tests/test_quant.py`` holds it for the JAX package."""
    torch.manual_seed(0)
    conv = nn.Conv2d(4, 5, 3, padding=1, bias=True)
    with torch.no_grad():
        conv.bias.normal_()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 4, 8, 8)).astype(np.float32))
    scales = calibrate_act_scales(conv, [x], path_filter=lambda p: True)
    assert set(scales) == {""}
    np.testing.assert_allclose(float(scales[""]),
                               float(x.abs().max()) / 127.0, rtol=1e-6)
    qstate = build_qstate(conv, scales)
    got = apply_quantized(conv, qstate, x)
    w = conv.weight.detach().double().numpy()
    w_scale = np.maximum(np.abs(w).max(axis=(1, 2, 3)), 1e-8) / 127.0
    w_q = np.clip(np.round(w / w_scale[:, None, None, None]), -127, 127)
    a = float(scales[""])
    x_q = np.clip(np.round(x.double().numpy() / a), -127, 127)
    acc = nn.functional.conv2d(torch.from_numpy(x_q), torch.from_numpy(w_q),
                               padding=1).numpy()
    want = acc * (a * w_scale)[None, :, None, None] + \
        conv.bias.detach().double().numpy()[None, :, None, None]
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    with torch.no_grad():
        fp = conv(x)
    assert float((fp - got).abs().max()) < 0.05 * float(fp.abs().max())


# -- the tiny trained flagship ---------------------------------------------

CFG = {"name": "Video_XProtoNet", "base_architecture": "resnet2p1d_18",
       "backbone_last_layer_num": -3, "prototype_shape": (8, 64, 1, 1, 1),
       "num_classes": 4, "img_size": 32}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def trained():
    """The JAX tiny flagship of ``tests/test_quant.py``, trained 4 steps,
    with two calibration batches; its port twin."""
    from protoasnet_tpu.losses.bundle import LossBundle
    from protoasnet_tpu.train.optim import make_adam
    from protoasnet_tpu.train.steps import TrainState, make_xprotonet_steps

    model = jax_build_model(CFG)
    params, batch_stats = init_model(model, jnp.zeros((2, 8, 32, 32, 3)),
                                     seed=0)
    criterion = {"CeLossAbstain": {"loss_weight": 1, "ab_weight": 0.3,
                                   "ab_logitpath": "joined",
                                   "reduction": "mean"},
                 "ClusterRoiFeat": {"loss_weight": 0.8, "reduction": "mean"}}
    groups = ("backbone", "add_on", "occurrence", "last_layer")
    tx = make_adam(weight_decay_by_group={g: 1e-3 for g in groups},
                   params=params)
    state = TrainState.create(params, batch_stats, tx)
    train_step, _, _ = make_xprotonet_steps(
        model, LossBundle(criterion, num_classes=4, abstain_class=True), tx,
        accumulation_steps=1, stage="all", donate=False)
    lrs = {g: jnp.float32(3e-3) for g in
           ("backbone", "add_on", "occurrence", "prototypes", "last_layer")}
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)
    for _ in range(4):
        xb = rng.uniform(-0.5, 2.0, size=(4, 8, 32, 32, 3)).astype(np.float32)
        yb = rng.integers(0, 3, size=4).astype(np.int32)
        xb += yb[:, None, None, None, None] * 0.5
        key, sub = jax.random.split(key)
        state, _ = train_step(state, jnp.asarray(xb), jnp.asarray(yb),
                              jnp.ones(4, jnp.bool_), sub, lrs)
    variables = {"params": _np_tree(state.params),
                 "batch_stats": _np_tree(state.batch_stats)}
    batches = []
    for _ in range(2):
        xb = rng.uniform(-0.5, 2.0, size=(4, 8, 32, 32, 3)).astype(np.float32)
        xb += rng.integers(0, 3, size=4)[:, None, None, None, None] * 0.5
        batches.append(xb)
    tm = build_model(CFG, device="cpu")
    load_jax_variables(tm, variables["params"], variables["batch_stats"])
    jscales = jq.calibrate_act_scales(model, variables,
                                      [jnp.asarray(b) for b in batches])
    return dict(jm=model, variables=variables, batches=batches, tm=tm,
                jscales={k: np.asarray(v) for k, v in jscales.items()})


def test_calibration_matches_jax(trained):
    scales = calibrate_act_scales(
        trained["tm"], [torch.from_numpy(b) for b in trained["batches"]])
    jscales = trained["jscales"]
    assert set(scales) == set(jscales)
    assert len(scales) > 20
    assert all(k.split("/")[0] == "cnn_backbone" for k in scales)
    assert not any("stem_spatial" in k for k in scales)
    for k, v in jscales.items():
        assert scales[k].dtype == torch.float32
        np.testing.assert_allclose(float(scales[k]), float(v), rtol=1e-5,
                                   err_msg=k)


def _jax_qstate(trained, **kw):
    return jax.tree_util.tree_map(np.asarray, jq.build_qstate(
        trained["variables"], trained["jscales"], **kw))


def test_build_qstate_matches_jax(trained):
    jqs = _jax_qstate(trained, fold_conv2plus1d=True, fold_min_channels=0)
    tqs = build_qstate(trained["tm"], {k: torch.tensor(v) for k, v in
                                       trained["jscales"].items()},
                       fold_conv2plus1d=True, fold_min_channels=0)
    assert set(tqs) == set(jqs)
    assert sum("fold_m" in q for q in tqs.values()) >= 8
    for key, want in jqs.items():
        got = tqs[key]
        assert set(got) == set(want), key
        np.testing.assert_array_equal(got["w_q"].numpy(), want["w_q"])
        np.testing.assert_array_equal(got["w_scale"].numpy(),
                                      want["w_scale"])
        np.testing.assert_array_equal(got["a_scale"].numpy(),
                                      want["a_scale"])
        for f in ("fold_m", "fold_b"):
            if f in want:
                # fold_b = (bias - mean) * inv_std + beta cancels to
                # near 0 in some channels: fp32 rounding of its terms
                # (1e-6 of the array's largest) bounds those
                np.testing.assert_allclose(got[f].numpy(), want[f],
                                           rtol=1e-6, atol=1e-6 * np.abs(
                                               want[f]).max(), err_msg=key)
    # the npz form round-trips
    back = qstate_from_arrays(qstate_to_arrays(tqs))
    for key, entry in tqs.items():
        for f, v in entry.items():
            assert torch.equal(back[key][f], v), (key, f)


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.mark.parametrize("fold", [False, True])
def test_apply_quantized_matches_jax_in_float64(trained, fold):
    qstate = _jax_qstate(trained, fold_conv2plus1d=fold,
                         fold_min_channels=0)
    assert any("fold_m" in q for q in qstate.values()) == fold
    x = trained["batches"][1].astype(np.float64)
    with jax.enable_x64(True):
        jm = jax_build_model(CFG, dtype=jnp.float64)
        want = np.asarray(jq.apply_quantized(
            jm, _f64(trained["variables"]), qstate, jnp.asarray(x))[0])
    got = apply_quantized(_double(trained["tm"]), qstate,
                          torch.from_numpy(x))[0]
    assert got.dtype == torch.float64
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def _double(tm):
    return copy.deepcopy(tm).double()


def _fidelity(fp, q):
    rel = np.abs(fp - q).max() / (np.abs(fp).max() + 1e-9)
    cos = (fp * q).sum() / (np.linalg.norm(fp) * np.linalg.norm(q) + 1e-12)
    agree = (fp.argmax(axis=1) == q.argmax(axis=1)).mean()
    return rel, cos, agree


def test_quantized_logits_faithful(trained):
    """The default (unfolded) qstate at fp32 against the port's own float
    forward, at the limits of ``tests/test_quant.py``."""
    tm = trained["tm"]
    scales = calibrate_act_scales(
        tm, [torch.from_numpy(b) for b in trained["batches"]])
    qstate = build_qstate(tm, scales)
    assert not any("fold_m" in q for q in qstate.values())
    folded = build_qstate(tm, scales, fold_conv2plus1d=True,
                          fold_min_channels=0)
    assert all(("fold_m" in q) == k.endswith("/spatial")
               for k, q in folded.items())
    x = torch.from_numpy(trained["batches"][1])
    with torch.no_grad():
        fp = tm(x)[0].double().numpy()
    for qs in (qstate, folded):
        q = apply_quantized(tm, qs, x)[0].double().numpy()
        rel, cos, agree = _fidelity(fp, q)
        assert rel < 0.08, rel
        assert cos > 0.995, cos
        assert agree >= 0.75, agree


def test_empty_qstate_is_the_float_forward(trained):
    tm = trained["tm"]
    x = torch.from_numpy(trained["batches"][1])
    with torch.no_grad():
        want = tm(x)[0]
    assert torch.equal(apply_quantized(tm, {}, x)[0], want)


def test_quantized_model_leaves_the_model_alone(trained):
    tm = trained["tm"]
    qm = quantized_model(tm, _jax_qstate(trained))
    assert isinstance(tm.cnn_backbone.layer1_0.conv1.spatial, nn.Conv3d)
    assert type(qm.cnn_backbone.layer1_0.conv1.spatial).__name__ == \
        "QuantConv"
    # the stem's space-to-depth conv (JAX) stays a float conv
    assert isinstance(qm.cnn_backbone.stem_spatial, nn.Conv3d)


def test_conv2plus1d_fold_golden():
    """The folded int8-resident pair == quantise(relu(bn(spatial(x))))
    fed to the quantised temporal conv, as ``tests/test_quant.py`` holds
    it for the JAX package."""
    from protoasnet_tpu_torch.models.norm import BatchNorm

    class Pair(nn.Module):
        def __init__(self):
            super().__init__()
            self.spatial = nn.Conv3d(3, 6, (1, 3, 3), padding=(0, 1, 1),
                                     bias=False)
            self.bn_mid = BatchNorm(6)
            self.temporal = nn.Conv3d(6, 8, (3, 1, 1), padding=(1, 0, 0),
                                      bias=False)

        def forward(self, x):
            return self.temporal(torch.relu(self.bn_mid(self.spatial(x))))

    rng = np.random.default_rng(5)
    torch.manual_seed(1)
    m = Pair().eval()
    with torch.no_grad():
        m.bn_mid.running_mean.copy_(torch.from_numpy(
            rng.normal(size=6) * 0.3))
        m.bn_mid.running_var.copy_(torch.from_numpy(
            rng.uniform(0.5, 2.0, size=6)))
        m.bn_mid.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, size=6)))
        m.bn_mid.bias.copy_(torch.from_numpy(rng.normal(size=6) * 0.2))
    x = torch.from_numpy(rng.normal(size=(2, 3, 4, 6, 6)).astype(np.float32))
    scales = calibrate_act_scales(m, [x], path_filter=lambda p: True)
    qstate = build_qstate(m, scales, fold_conv2plus1d=True,
                          fold_min_channels=0)
    assert "fold_m" in qstate["spatial"]
    assert "fold_m" not in qstate["temporal"]
    got = apply_quantized(m, qstate, x).double().numpy()

    qs, qt = qstate["spatial"], qstate["temporal"]
    ws = torch.from_numpy(np.transpose(qs["w_q"].numpy(), (4, 3, 0, 1, 2)))
    wt = torch.from_numpy(np.transpose(qt["w_q"].numpy(), (4, 3, 0, 1, 2)))
    f = nn.functional
    xq = torch.clamp(torch.round(x.double() / float(qs["a_scale"])), -127,
                     127)
    y = f.conv3d(xq, ws.double(), padding=(0, 1, 1)) * (
        qs["a_scale"] * qs["w_scale"]).double().view(1, -1, 1, 1, 1)
    bn = m.bn_mid
    y = (y - bn.running_mean.double().view(1, -1, 1, 1, 1)) / torch.sqrt(
        bn.running_var.double().view(1, -1, 1, 1, 1) + 1e-5)
    y = y * bn.weight.detach().double().view(1, -1, 1, 1, 1) + \
        bn.bias.detach().double().view(1, -1, 1, 1, 1)
    y8 = torch.clamp(torch.round(torch.clamp_min(y, 0.0)
                                 / float(qt["a_scale"])), 0, 127)
    want = (f.conv3d(y8, wt.double(), padding=(1, 0, 0)) * (
        qt["a_scale"] * qt["w_scale"]).double().view(1, -1, 1, 1, 1)).numpy()
    step = np.abs(qt["w_q"].numpy().astype(np.float64)).sum() * float(
        qt["a_scale"] * qt["w_scale"].max())
    np.testing.assert_allclose(got, want, atol=step * 0.02 + 1e-6)
    with torch.no_grad():
        fp = m(x).double().numpy()
    assert np.abs(fp - got).max() < 0.1 * np.abs(fp).max()


# -- the 2-D trunks -----------------------------------------------------------

TWO_D = {
    "resnet18": ({"name": "XProtoNet", "base_architecture": "resnet18",
                  "prototype_shape": (6, 32, 1, 1), "num_classes": 4,
                  "img_size": 64}, "cnn_backbone"),
    "vgg11": ({"name": "ProtoPNet", "base_architecture": "vgg11",
               "prototype_shape": (6, 32, 1, 1), "num_classes": 3,
               "img_size": 64}, "features"),
}


@pytest.mark.parametrize("arch", sorted(TWO_D))
def test_2d_trunks_quantise_and_match_jax(arch):
    cfg, trunk = TWO_D[arch]
    rng = np.random.default_rng(2)
    xs = [rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
          for _ in range(2)]
    jm = jax_build_model(cfg)
    params, stats = init_model(jm, jnp.asarray(xs[0][:1]), seed=0)
    params, stats = _np_tree(params), _np_tree(stats)
    stats = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
        stats)
    variables = {"params": params, "batch_stats": stats}

    def keep(p):
        return len(p) > 0 and p[0] == trunk

    jscales = {k: np.asarray(v) for k, v in jq.calibrate_act_scales(
        jm, variables, [jnp.asarray(x) for x in xs],
        path_filter=keep).items()}
    tm = build_model(cfg, device="cpu")
    load_jax_variables(tm, params, stats)
    scales = calibrate_act_scales(tm, [torch.from_numpy(x) for x in xs],
                                  path_filter=keep)
    assert set(scales) == set(jscales) and len(scales) >= 8
    for k, v in jscales.items():
        np.testing.assert_allclose(float(scales[k]), float(v), rtol=1e-5)
    qstate = jax.tree_util.tree_map(
        np.asarray, jq.build_qstate(variables, jscales))
    x = xs[1].astype(np.float64)
    with jax.enable_x64(True):
        jm64 = jax_build_model(cfg, dtype=jnp.float64)
        want = np.asarray(jq.apply_quantized(jm64, _f64(variables), qstate,
                                             jnp.asarray(x))[0])
    got = apply_quantized(_double(tm), qstate, torch.from_numpy(x))[0]
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
