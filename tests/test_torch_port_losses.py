"""The port's warps, losses and loss bundle against the JAX package's.

Inputs are made with numpy from seeds and go through both packages.
Tolerances: the warps within 1e-5 absolute on values of order 1 (fp32
products of at most three banded weights, in another summation order);
each loss term and the bundle's total within rtol 1e-5 (fp32 reductions
of a few hundred terms). The gradient of the warps is checked in float64
against finite differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.losses import bundle as jax_bundle
from protoasnet_tpu.losses import losses as JL
from protoasnet_tpu.ops import affine_fast as JA
from protoasnet_tpu_torch.losses import losses as TL
from protoasnet_tpu_torch.losses.bundle import LossBundle
from protoasnet_tpu_torch.ops import affine_fast as TA
from torch_port_isolation import isolated

_isolated = isolated(1)

N, P, K = 5, 8, 4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(port, ref, rtol=1e-5, atol=1e-6, name=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol, err_msg=name)


# ---------------- warps ----------------

WARPS = {
    "scale_about_center": (lambda m, v: m.scale_about_center(v, 1.3),
                           lambda m, v: m.scale_about_center(v, 0.7)),
    "crop_resize_video": (
        lambda m, v: m.crop_resize_video(v, 2.5, 1.25, 11.0, 13.5, (12, 10)),
        lambda m, v: m.crop_resize_video(v, 0.0, 3.0, 16.0, 9.0, (16, 16))),
    "rotate_video": (lambda m, v: m.rotate_video(v, 17.0),
                     lambda m, v: m.rotate_video(v, -9.5)),
    "rotate_scale_video": (lambda m, v: m.rotate_scale_video(v, -20.0, 1.5),
                           lambda m, v: m.rotate_scale_video(v, 4.0, 0.6)),
}


@pytest.mark.parametrize("name", sorted(WARPS))
@pytest.mark.parametrize("shape", [(3, 16, 14), (2, 16, 14, 3)])
def test_warps_match_jax(name, shape):
    rng = np.random.default_rng(0)
    v = rng.uniform(0, 1, size=shape).astype(np.float32)
    for fn in WARPS[name]:
        ref = fn(JA, jnp.asarray(v))
        got = fn(TA, _t(v))
        assert got.shape == ref.shape and got.dtype == torch.float32
        _close(got, ref, rtol=0, atol=1e-5, name=name)


@pytest.mark.parametrize("shape", [(2, 3, 16, 14, 4), (4, 16, 14, 4)])
def test_affine_batch_matches_jax(shape):
    """Clips (N, T, H, W, C) and images (N, H, W, C); bf16 input is
    promoted to fp32."""
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, size=shape).astype(np.float32)
    ref = JL.affine_batch(jnp.asarray(x), jnp.float32(-13.0),
                          jnp.float32(1.2))
    got = TL.affine_batch(_t(x), -13.0, 1.2)
    _close(got, ref, rtol=0, atol=1e-5)
    bf = TL.affine_batch(_t(x).bfloat16(), -13.0, 1.2)
    assert bf.dtype == torch.float32


def test_warp_gradient_float64():
    """Linear in the clip: the analytic gradient equals finite differences
    (float64 weights, float64 clip)."""
    v = torch.rand((2, 6, 5, 2), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: TA.rotate_scale_video(t, 11.0, 1.2), (v,))
    assert torch.autograd.gradcheck(
        lambda t: TA.crop_resize_video(t, 1.5, 0.5, 4.0, 3.0, (4, 4)), (v,))


def test_affine_draw_ranges():
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([torch.stack(TL.sample_affine_params(g))
                         for _ in range(500)])
    assert draws[:, 0].min() >= -20 and draws[:, 0].max() <= 20
    assert draws[:, 1].min() >= 0.6 and draws[:, 1].max() <= 1.5
    assert draws[:, 0].std() > 10  # spread over the range, not constant
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(torch.stack(TL.sample_affine_params(g2)), draws[0])


# ---------------- loss terms ----------------

@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    return dict(
        logits=rng.normal(size=(N, K)).astype(np.float32) * 2,
        sim=rng.uniform(0, 1, size=(N, P)).astype(np.float32),
        dist=rng.uniform(0, 3, size=(N, P)).astype(np.float32),
        target=np.array([0, 1, 2, 1, 0], np.int32),
        valid=np.array([True, True, False, True, True]),
        occ=np.abs(rng.normal(size=(N, 2, 4, 4, P))).astype(np.float32),
        occ_t=np.abs(rng.normal(size=(N, 2, 4, 4, P))).astype(np.float32),
        protos=rng.uniform(0, 1, size=(P, 16)).astype(np.float32),
        kernel=rng.normal(size=(P, K)).astype(np.float32),
        ident=np.eye(K, dtype=np.float32).repeat(P // K, axis=0),
    )


def _both(fn_name, d, keys, **kw):
    j = getattr(JL, fn_name)(*(jnp.asarray(d[k]) for k in keys), **kw)
    t = getattr(TL, fn_name)(*(_t(d[k]) for k in keys), **kw)
    return t, j


CASES = [
    ("mse_loss", ("sim", "dist"), {}),
    ("ce_loss", ("logits", "target"), {}),
    ("ce_loss", ("logits", "target"), {"reduction": "sum"}),
    ("ce_loss_abstain", ("logits", "target"), {}),
    ("ce_loss_abstain", ("logits", "target"),
     {"ab_logitpath": "separate", "reduction": "sum"}),
    ("cluster_roi", ("sim", "target"), {"num_classes": K}),
    ("separation_roi", ("sim", "target"), {"num_classes": K}),
    ("separation_roi", ("sim", "target"),
     {"num_classes": K, "abstain_class": True}),
    ("cluster_patch", ("dist", "target"), {"num_classes": K}),
    ("separation_patch", ("dist", "target"),
     {"num_classes": K, "reduction": "sum"}),
    ("orthogonality_loss", ("protos",), {"num_classes": K}),
    ("orthogonality_loss", ("protos",), {"num_classes": K, "mode": "all"}),
    ("l_norm", ("kernel",), {"p": 1}),
    ("l_norm", ("kernel",), {"p": 3, "axis": 1, "reduction": "mean"}),
    ("l_norm_occurrence", ("occ",), {}),
    ("l_norm_occurrence", ("occ",), {"p": 1, "reduction": "sum"}),
    ("l_norm_fc", ("kernel", "ident"), {}),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[2]}")
def test_loss_term_matches_jax(data, case):
    name, keys, kw = case
    t, j = _both(name, data, keys, **kw)
    _close(t.numpy(), j)


@pytest.mark.parametrize("name", ["ce_loss", "ce_loss_abstain",
                                  "cluster_roi", "separation_roi"])
def test_valid_mask_matches_jax(data, name):
    kw = {"num_classes": K} if "roi" in name else {}
    src = "sim" if "roi" in name else "logits"
    j = getattr(JL, name)(jnp.asarray(data[src]), jnp.asarray(data["target"]),
                          valid=jnp.asarray(data["valid"]), **kw)
    t = getattr(TL, name)(_t(data[src]), _t(data["target"]),
                          valid=_t(data["valid"]), **kw)
    _close(t.numpy(), j)


def test_transform_loss_from_pair_matches_jax(data):
    j = JL.transform_loss_from_pair(jnp.asarray(data["occ_t"]),
                                    jnp.asarray(data["occ"]),
                                    jnp.float32(12.0), jnp.float32(0.8))
    t = TL.transform_loss_from_pair(_t(data["occ_t"]), _t(data["occ"]),
                                    12.0, 0.8)
    _close(t.numpy(), j)


CRITERION = {
    "CeLossAbstain": {"loss_weight": 1, "ab_weight": 0.3,
                      "ab_logitpath": "joined", "reduction": "mean"},
    "ClusterRoiFeat": {"loss_weight": 0.8, "reduction": "mean"},
    "SeparationRoiFeat": {"loss_weight": 0.08, "reduction": "mean"},
    "OrthogonalityLoss": {"loss_weight": 0.0, "mode": "per_class"},
    "Lnorm_occurrence": {"p": 2, "loss_weight": 0.0, "reduction": "mean"},
    "trans_occurrence": {"loss_weight": 0.001, "reduction": "mean"},
    "Lnorm_FC": {"p": 1, "loss_weight": 0.0001},
}


@pytest.mark.parametrize("gate", ["flagship", "all_on", "no_transform"])
def test_bundle_terms_and_zero_weight_gating(data, gate):
    """The 7 terms and the total as the JAX bundle gives them; a term of
    weight 0 is reported as 0 and never computed (its second forward is
    not called)."""
    crit = {k: dict(v) for k, v in CRITERION.items()}
    if gate == "all_on":
        crit["OrthogonalityLoss"]["loss_weight"] = 0.01
        crit["Lnorm_occurrence"]["loss_weight"] = 0.002
    elif gate == "no_transform":
        crit["trans_occurrence"]["loss_weight"] = 0.0
    jb = jax_bundle.LossBundle(crit, num_classes=K, abstain_class=True)
    tb = LossBundle(crit, num_classes=K, abstain_class=True)
    assert tb.transform_enabled == jb.transform_enabled
    occ_t = data["occ_t"]
    jtot, jterms = jb.xprotonet_terms(
        jnp.asarray(data["logits"]), jnp.asarray(data["sim"]),
        jnp.asarray(data["occ"]), jnp.asarray(data["target"]),
        jnp.asarray(data["protos"]), jnp.asarray(data["kernel"]),
        jnp.asarray(data["ident"]), valid=jnp.asarray(data["valid"]),
        occ_transformed=jnp.asarray(occ_t),
        affine_params=(jnp.float32(-7.0), jnp.float32(1.1)))

    def occ_fn(x):  # the two-pass form: must not run when disabled
        assert tb.transform_enabled
        return _t(occ_t)

    x = torch.zeros((N, 2, 4, 4, 3))
    ttot, tterms = tb.xprotonet_terms(
        _t(data["logits"]), _t(data["sim"]), _t(data["occ"]),
        _t(data["target"]), _t(data["protos"]), _t(data["kernel"]),
        _t(data["ident"]), valid=_t(data["valid"]), x=x, occ_fn=occ_fn,
        affine_params=(-7.0, 1.1))
    assert set(tterms) == set(jterms)
    for k in jterms:
        _close(tterms[k].numpy(), jterms[k], name=k)
        if k in ("loss_Ortho", "loss_RoiNorm") and gate != "all_on":
            assert float(tterms[k]) == 0.0
    _close(ttot.numpy(), jtot)
    if gate == "no_transform":
        assert float(tterms["loss_RoiTrans"]) == 0.0


def test_protopnet_bundle_matches_jax(data):
    crit = {"CeLoss": {"loss_weight": 1}, "ClusterPatch": {"loss_weight": 0.8},
            "SeparationPatch": {"loss_weight": -0.08},
            "Lnorm_FC": {"loss_weight": 1e-4}}
    jb = jax_bundle.LossBundle(crit, num_classes=K, abstain_class=False,
                               variant="protopnet")
    tb = LossBundle(crit, num_classes=K, abstain_class=False)
    jtot, jterms = jb.protopnet_terms(
        jnp.asarray(data["logits"]), jnp.asarray(data["dist"]),
        jnp.asarray(data["target"]), jnp.asarray(data["kernel"]),
        jnp.asarray(data["ident"]))
    ttot, tterms = tb.protopnet_terms(
        _t(data["logits"]), _t(data["dist"]), _t(data["target"]),
        _t(data["kernel"]), _t(data["ident"]))
    for k in jterms:
        _close(tterms[k].numpy(), jterms[k], name=k)
    _close(ttot.numpy(), jtot)
