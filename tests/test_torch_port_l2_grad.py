"""The L2 + min head's gradient: ``l2_min_backward`` against the JAX
package's custom VJP of ``pallas_l2.l2_min_pallas`` (``_bwd``, reached by
``jax.vjp`` of the Pallas head in interpret mode), the plain head's torch
autograd against JAX's "xla" head, and the ``torch.autograd.Function``
that wraps the CUDA forward.

The two JAX heads part on ties: ``_bwd`` gives a tied minimum's whole
cotangent to its first position (a ``cumsum``), ``jnp.min`` splits it
evenly, as torch's ``amin`` does. The port's Function follows ``_bwd`` (it
replaces that kernel); its plain head keeps torch's autograd (it matches
the xla head). Each is held against its own reference, also on inputs
with planted ties and with prototypes equal to patches (distance exactly
0, where the relu gate stops the gradient): features on a grid of
quarters, so that every sum is exact in fp32 and ties are exact.

The Function's forward launches the CUDA kernel, which has no CPU mode;
here its launch is replaced by the plain forward, so the CPU tests reach
the Function's wiring and its backward (the kernel itself is held on the
card by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``).

Tolerances: fp32 cotangents within 1e-6 of max |ref| (fp32 sums of S*P
and S*N products in another order; the reference computes in fp32 also for
float64 primals, which the port computes in float64); bf16 x: the
cotangents come back in the primals' dtypes (bf16 g_x, fp32 g_w), g_x
within one bf16 step of max |ref| (2^-8); torch against torch in float64:
1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.ops.l2conv import l2_patch_distances as jax_l2
from protoasnet_tpu.ops.pallas_l2 import l2_min_pallas
from protoasnet_tpu_torch.ops import l2_min_cuda as l2_mod
from protoasnet_tpu_torch.ops.l2_min import l2_min_backward, l2_min_torch
from torch_port_isolation import isolated

_isolated = isolated(1)

# a reduced ProtoPNet head: N=3 samples of 5x5 positions, P=7, D=40
N, H, W, P, D = 3, 5, 5, 7, 40
S = H * W


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _data(kind, seed=0):
    """x (N, H, W, D), w (P, 1, 1, D), g_dist (N, H, W, P), g_min (N, P).

    "smooth": sigmoid-range features and U(0,1) prototypes (no ties);
    "ties": features on a grid of quarters with positions copied within a
    sample (tied minima) and prototypes copied from patches (distance 0).
    """
    rng = np.random.default_rng(seed)
    if kind == "smooth":
        x = 1.0 / (1.0 + np.exp(-rng.normal(size=(N, H, W, D))))
        w = rng.uniform(size=(P, 1, 1, D))
    else:
        x = rng.integers(0, 5, size=(N, H, W, D)) / 4.0
        w = rng.integers(0, 5, size=(P, 1, 1, D)) / 4.0
        xf = x.reshape(N, S, D)
        xf[:, 7] = xf[:, 2]  # every sample: position 7 ties position 2
        xf[1, 20] = xf[1, 3]
        w[0, 0, 0] = xf[0, 4]  # distance 0 at (0, 4)
        w[3, 0, 0] = xf[2, 9]  # distance 0 at (2, 9) ...
        xf[2, 15] = xf[2, 9]  # ... tied with (2, 15)
        w[5, 0, 0] = xf[1, 2] + 0.25  # a tie at (1, 2), (1, 7), not 0
        x = xf.reshape(N, H, W, D)
    g_dist = rng.normal(size=(N, H, W, P))
    g_min = rng.normal(size=(N, P))
    return [a.astype(np.float32) for a in (x, w, g_dist, g_min)]


def _jax_pallas_vjp(x, w, g_dist, g_min):
    (dist, min_d), vjp = jax.vjp(
        lambda a, b: l2_min_pallas(a, b, interpret=True),
        jnp.asarray(x), jnp.asarray(w))
    g_x, g_w = vjp((jnp.asarray(g_dist), jnp.asarray(g_min)))
    return np.asarray(dist), np.asarray(min_d), g_x, g_w


def _port_bwd(x, w, dist, g_dist, g_min):
    """``l2_min_backward`` on (N, S, D) / (P, D) views, back in the head's
    shapes."""
    g_x, g_w = l2_min_backward(
        x.reshape(N, S, D), w.reshape(P, D),
        torch.from_numpy(np.array(dist, np.float32)).reshape(N, S, P),
        None if g_dist is None else g_dist.reshape(N, S, P), g_min)
    return g_x.reshape(x.shape), g_w.reshape(w.shape)


@pytest.mark.parametrize("kind", ["smooth", "ties"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backward_matches_pallas_vjp(kind, dtype):
    """Against ``_bwd`` on the same residuals (the Pallas forward's
    distances): fp32 and float64 primals (the head's outputs and their
    cotangents are fp32 either way), cotangents in the primals' dtype."""
    x, w, g_dist, g_min = _data(kind)
    with jax.enable_x64(dtype == torch.float64):
        jdt = np.float64 if dtype == torch.float64 else np.float32
        dist, _, ref_x, ref_w = _jax_pallas_vjp(
            x.astype(jdt), w.astype(jdt), g_dist, g_min)
        assert ref_x.dtype == ref_w.dtype == jdt
    g_x, g_w = _port_bwd(torch.from_numpy(x).to(dtype),
                         torch.from_numpy(w).to(dtype), dist,
                         torch.from_numpy(g_dist), torch.from_numpy(g_min))
    assert g_x.dtype == g_w.dtype == dtype
    assert _rel(g_x, ref_x) < 1e-6
    assert _rel(g_w, ref_w) < 1e-6


def test_ties_route_to_the_first_minimum_and_zero_distances_are_gated():
    """On the planted ties the whole of g_min goes to the first tied
    position; at a distance of exactly 0 nothing passes the relu gate."""
    x, w, _, g_min = _data("ties")
    xt, wt = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    dist, min_d = l2_min_torch(xt, wt)
    dist = dist.reshape(N, S, P)
    assert float(dist[0, 4, 0]) == 0.0 and float(dist[2, 9, 3]) == 0.0
    assert float(dist[1, 2, 5]) == float(dist[1, 7, 5]) == float(
        min_d[1, 5]) > 0.0
    g = torch.from_numpy(g_min).double()
    # only g_min: the gradient of x is that of the routed positions alone
    g_x, _ = _port_bwd(xt, wt, dist, None, g)
    g_x = g_x.reshape(N, S, D)
    wf = wt.reshape(P, D)
    first = dist.argmin(1)  # torch.argmin: the first minimal position
    ref = torch.zeros_like(g_x)
    for n in range(N):
        for p in range(P):
            s = int(first[n, p])
            if dist[n, s, p] > 0:
                ref[n, s] += 2.0 * g[n, p] * (xt.reshape(N, S, D)[n, s]
                                              - wf[p])
    assert int(first[1, 5]) == 2
    assert _rel(g_x, ref) < 1e-12
    assert not g_x[1, 7].any()  # the second tied position gets nothing


def test_bf16_cotangent_dtypes():
    """bf16 features, fp32 prototypes (the bf16 model's head): g_x bf16,
    g_w fp32, as ``_bwd`` returns them, against it within a bf16 step."""
    x, w, g_dist, g_min = _data("smooth", seed=3)
    xb = torch.from_numpy(x).bfloat16()
    dist, _, ref_x, ref_w = _jax_pallas_vjp(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), w, g_dist, g_min)
    assert ref_x.dtype == jnp.bfloat16 and ref_w.dtype == jnp.float32
    g_x, g_w = _port_bwd(xb, torch.from_numpy(w), dist,
                         torch.from_numpy(g_dist), torch.from_numpy(g_min))
    assert g_x.dtype == torch.bfloat16 and g_w.dtype == torch.float32
    assert _rel(g_x.float(), np.asarray(ref_x, np.float32)) < 2.0 ** -8
    assert _rel(g_w, ref_w) < 1e-6


@pytest.mark.parametrize("kind", ["smooth", "ties"])
def test_plain_head_autograd_matches_xla_head(kind):
    """The plain head (the CPU path of the model) under torch's autograd
    against ``jax.vjp`` of the JAX package's default head (the distances
    and ``jnp.min``): both split a tie evenly."""
    x, w, g_dist, g_min = _data(kind, seed=1)

    def xla_head(a, b):
        dist = jax_l2(a, b)
        return dist, jnp.min(dist, axis=(1, 2))

    _, vjp = jax.vjp(xla_head, jnp.asarray(x), jnp.asarray(w))
    ref_x, ref_w = vjp((jnp.asarray(g_dist), jnp.asarray(g_min)))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    dist, min_d = l2_min_torch(xt, wt)
    ((dist * torch.from_numpy(g_dist)).sum()
     + (min_d * torch.from_numpy(g_min)).sum()).backward()
    assert _rel(xt.grad, ref_x) < 1e-6
    assert _rel(wt.grad, ref_w) < 1e-6


def _plain_launch(x3, prototypes):
    with torch.no_grad():
        p, d = prototypes.shape[0], x3.shape[-1]
        return l2_min_torch(x3, prototypes.reshape(p, d))


@pytest.mark.parametrize("outputs", ["both", "min_only", "dist_only"])
def test_function_wiring_with_the_plain_forward(monkeypatch, outputs):
    """``L2MinFunction``: the forward keeps the distances it returned, the
    backward is ``l2_min_backward`` (one call counted) for each output
    used, the prototypes' gradient in their (P, 1, 1, D) shape; on
    tie-free inputs it equals the plain head's autograd."""
    monkeypatch.setattr(l2_mod, "_launch", _plain_launch)
    x, w, g_dist, g_min = _data("smooth", seed=2)
    calls = l2_mod.l2_min_cuda.backward_calls
    xt = torch.from_numpy(x).reshape(N, S, D).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    dist, min_d = l2_mod.L2MinFunction.apply(xt, wt)
    gd = torch.from_numpy(g_dist).reshape(N, S, P)
    gm = torch.from_numpy(g_min)
    loss = 0.0
    if outputs != "min_only":
        loss = loss + (dist * gd).sum()
    if outputs != "dist_only":
        loss = loss + (min_d * gm).sum()
    loss.backward()
    assert l2_mod.l2_min_cuda.backward_calls == calls + 1
    assert wt.grad.shape == (P, 1, 1, D)
    want_x, want_w = l2_min_backward(
        xt.detach(), wt.detach().reshape(P, D), dist.detach(),
        gd if outputs != "min_only" else None,
        gm if outputs != "dist_only" else None)
    assert torch.equal(xt.grad, want_x)
    assert torch.equal(wt.grad, want_w.reshape(P, 1, 1, D))
    rx = xt.detach().clone().requires_grad_(True)
    rw = wt.detach().clone().requires_grad_(True)
    r_dist, r_min = l2_min_torch(rx, rw)
    r_loss = 0.0
    if outputs != "min_only":
        r_loss = r_loss + (r_dist * gd).sum()
    if outputs != "dist_only":
        r_loss = r_loss + (r_min * gm).sum()
    r_loss.backward()
    assert torch.equal(dist, r_dist) and torch.equal(min_d, r_min)
    assert _rel(xt.grad, rx.grad) < 1e-6
    assert _rel(wt.grad, rw.grad) < 1e-6
