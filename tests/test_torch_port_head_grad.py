"""The ROI-cosine head's gradient: ``roi_cosine_backward`` against the JAX
package's custom VJP (``pallas_roi._bwd``), against the autodiff of its
XLA head and of the Pallas head in interpret mode, and the
``torch.autograd.Function`` that wraps the CUDA forward.

The Function's forward launches the CUDA kernel, which has no CPU mode;
here its launch is replaced by the plain forward, so the CPU tests reach
the Function's autograd wiring and its backward (the kernel itself is held
on the card by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``).

Tolerances: fp32 gradients within 1e-5 of max |ref| (fp32 sums of S=96
products in another order); bf16 inputs: the cotangents come back in the
primals' dtypes (bf16 occ and feat, fp32 prototypes) and agree with the
JAX ones within one bf16 step of max |ref| (2^-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.ops import pallas_roi
from protoasnet_tpu.ops.roi_cosine import roi_cosine_head as jax_head
from protoasnet_tpu_torch.ops import roi_cosine_cuda as roi_mod
from protoasnet_tpu_torch.ops.roi_cosine import (roi_cosine_backward,
                                                 roi_cosine_torch)
from torch_port_isolation import isolated

_isolated = isolated(1)

N, S, P, D = 3, 96, 8, 32


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return dict(
        occ=np.abs(rng.normal(size=(N, S, P))).astype(np.float32) * 0.1,
        feat=rng.normal(size=(N, S, D)).astype(np.float32),
        protos=rng.uniform(0, 1, size=(P, D)).astype(np.float32),
        g_roi=rng.normal(size=(N, P, D)).astype(np.float32) * 0.01,
        g_sim=rng.normal(size=(N, P)).astype(np.float32))


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _jax_bwd(d, dtype=jnp.float32):
    occ = jnp.asarray(d["occ"], dtype)
    feat = jnp.asarray(d["feat"], dtype)
    protos = jnp.asarray(d["protos"])
    roi, _ = pallas_roi._forward(occ, feat, protos, True)
    return roi, pallas_roi._bwd(True, (occ, feat, protos, roi),
                                (jnp.asarray(d["g_roi"]),
                                 jnp.asarray(d["g_sim"])))


def _port_bwd(d, roi, dtype=torch.float32, g_roi=True, g_sim=True):
    return roi_cosine_backward(
        torch.from_numpy(d["occ"]).to(dtype),
        torch.from_numpy(d["feat"]).to(dtype),
        torch.from_numpy(d["protos"]), torch.from_numpy(np.array(roi)),
        torch.from_numpy(d["g_roi"]) if g_roi else None,
        torch.from_numpy(d["g_sim"]) if g_sim else None)


def test_backward_matches_pallas_bwd_fp32(data):
    roi, ref = _jax_bwd(data)
    got = _port_bwd(data, roi)
    for name, g, r in zip(("occ", "feat", "protos"), got, ref):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), r) < 1e-5, name


def test_backward_bf16_cotangent_dtypes(data):
    """bf16 occ/feat (the flagship): g_occ and g_feat bf16, g_protos fp32,
    as ``_bwd`` returns them."""
    roi, ref = _jax_bwd(data, jnp.bfloat16)
    got = _port_bwd(data, roi, torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    assert [r.dtype for r in ref] == [jnp.bfloat16, jnp.bfloat16,
                                      jnp.float32]
    for name, g, r in zip(("occ", "feat", "protos"), got, ref):
        assert _rel(g.float().numpy(), np.asarray(r, np.float32)) \
            < 2 ** -8, name


def test_backward_matches_xla_and_pallas_autodiff(data):
    """The head's vjp in JAX (XLA head: autodiff; Pallas head in interpret
    mode: its custom VJP) against the port's closed form, fp32."""
    occ, feat = jnp.asarray(data["occ"]), jnp.asarray(data["feat"])
    protos = jnp.asarray(data["protos"])
    cot = (jnp.asarray(data["g_roi"]), jnp.asarray(data["g_sim"]))
    for impl in ("xla", "pallas"):
        if impl == "xla":
            fn = lambda o, f, p: jax_head(o, f, p, impl="xla")  # noqa: E731
        else:
            fn = lambda o, f, p: pallas_roi.roi_cosine_pallas(  # noqa: E731
                o, f, p, interpret=True)
        (roi, _), vjp = jax.vjp(fn, occ, feat, protos)
        ref = vjp(cot)
        got = _port_bwd(data, roi)
        for name, g, r in zip(("occ", "feat", "protos"), got, ref):
            assert _rel(g.numpy(), r) < 1e-5, (impl, name)


@pytest.mark.parametrize("which", ["both", "sim_only", "roi_only"])
def test_backward_matches_plain_head_autograd(data, which):
    """Against torch's autograd of the plain head (float64), also with one
    output unused (its cotangent None)."""
    occ = torch.from_numpy(data["occ"]).double().requires_grad_(True)
    feat = torch.from_numpy(data["feat"]).double().requires_grad_(True)
    protos = torch.from_numpy(data["protos"]).double().requires_grad_(True)
    roi, sim = roi_cosine_torch(occ, feat, protos)
    g_roi = torch.from_numpy(data["g_roi"]).double()
    g_sim = torch.from_numpy(data["g_sim"]).double()
    outs, cots = [], []
    if which in ("both", "roi_only"):
        outs.append(roi)
        cots.append(g_roi)
    if which in ("both", "sim_only"):
        outs.append(sim)
        cots.append(g_sim)
    ref = torch.autograd.grad(outs, (occ, feat, protos), cots,
                              allow_unused=True, materialize_grads=True)
    got = roi_cosine_backward(
        occ.detach(), feat.detach(), protos.detach(), roi.detach(),
        g_roi if which != "sim_only" else None,
        g_sim if which != "roi_only" else None)
    for name, g, r in zip(("occ", "feat", "protos"), got, ref):
        assert g.dtype == torch.float64
        assert _rel(g.numpy(), r.numpy()) < 1e-12, (which, name)


def test_function_wiring_with_the_plain_forward(data, monkeypatch):
    """``roi_cosine_cuda``'s Function: the forward's outputs and the
    gradients of all three inputs through ``roi_cosine_backward`` (one
    backward call counted), against the plain head's autograd."""
    def plain_launch(occ2, feat2, prototypes):
        with torch.no_grad():
            return roi_cosine_torch(occ2, feat2, prototypes)

    monkeypatch.setattr(roi_mod, "_launch", plain_launch)
    calls = roi_mod.roi_cosine_cuda.backward_calls
    leaves = [torch.from_numpy(data[k]).requires_grad_(True)
              for k in ("occ", "feat", "protos")]
    roi, sim = roi_mod.RoiCosineFunction.apply(*leaves)
    loss = (roi * torch.from_numpy(data["g_roi"])).sum() \
        + (sim * torch.from_numpy(data["g_sim"])).sum()
    loss.backward()
    assert roi_mod.roi_cosine_cuda.backward_calls == calls + 1
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    r_roi, r_sim = roi_cosine_torch(*ref_leaves)
    ((r_roi * torch.from_numpy(data["g_roi"])).sum()
     + (r_sim * torch.from_numpy(data["g_sim"])).sum()).backward()
    assert torch.allclose(roi, r_roi) and torch.allclose(sim, r_sim)
    for t, r in zip(leaves, ref_leaves):
        assert _rel(t.grad.numpy(), r.grad.numpy()) < 1e-5
