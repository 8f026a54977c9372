"""Port's L2 prototype ops against the JAX package's.

The same features and prototypes (numpy, seeded) go through
``protoasnet_tpu_torch.ops.l2_min`` / ``ops.l2conv`` and through the JAX
``l2_min_pallas(interpret=True)`` and ``l2_patch_distances``, at rtol and
atol 1e-4. Inputs are sigmoid-range features and U(0,1) prototypes, as
ProtoPNet's "regular" add-on and its init produce, at ProtoPNet's head
shape (S=7*7, P=30, D=512) and at odd sizes. The CUDA kernel itself runs
only on the card (tests/test_torch_port_cuda.py); on the CPU its wrapper
takes the plain version because the tensors lie on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.ops.l2conv import l2_patch_distances as jax_l2
from protoasnet_tpu.ops.pallas_l2 import l2_min_pallas
from protoasnet_tpu_torch.ops.l2_min import l2_min_head, l2_min_torch
from protoasnet_tpu_torch.ops.l2_min_cuda import l2_min_cuda
from protoasnet_tpu_torch.ops.l2conv import l2_patch_distances

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
# (n, h, w, d, p): ProtoPNet's head at batch 2, odd sizes (S, P, D off
# the kernel's tiles), one position, D=1
SHAPES = [(2, 7, 7, 512, 30), (3, 5, 3, 63, 7), (1, 1, 1, 16, 33),
          (2, 3, 4, 1, 5)]


def _data(shape, seed=0, kh=1, kw=1):
    n, h, w, d, p = shape
    rng = np.random.default_rng(seed)
    x = 1.0 / (1.0 + np.exp(-rng.normal(size=(n, h, w, d))))
    protos = rng.uniform(size=(p, kh, kw, d))
    return x.astype(np.float32), protos.astype(np.float32)


def _close(port_t, ref, name):
    np.testing.assert_allclose(port_t.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_l2_min_matches_pallas_and_xla(shape):
    x, protos = _data(shape)
    dist_p, min_p = l2_min_pallas(jnp.asarray(x), jnp.asarray(protos),
                                  interpret=True)
    dist_x = jax_l2(jnp.asarray(x), jnp.asarray(protos))
    dist_t, min_t = l2_min_torch(torch.from_numpy(x),
                                 torch.from_numpy(protos))
    assert dist_t.dtype == min_t.dtype == torch.float32
    assert tuple(dist_t.shape) == shape[:3] + (shape[4],)
    _close(dist_t, dist_p, "dist vs pallas")
    _close(min_t, min_p, "min vs pallas")
    _close(dist_t, dist_x, "dist vs l2_patch_distances")
    _close(min_t, jnp.min(dist_x, axis=(1, 2)), "min vs xla min")
    # the minimum of exactly the distances returned
    assert torch.equal(min_t, dist_t.reshape(shape[0], -1, shape[4]).amin(1))


@pytest.mark.parametrize("khw", [(1, 1), (2, 2), (3, 2)])
def test_l2_patch_distances_matches_jax(khw):
    """1x1 is one product; 2x2 and 3x2 take the general conv path."""
    x, protos = _data((2, 5, 6, 24, 7), seed=1, kh=khw[0], kw=khw[1])
    ref = jax_l2(jnp.asarray(x), jnp.asarray(protos))
    out = l2_patch_distances(torch.from_numpy(x), torch.from_numpy(protos))
    assert tuple(out.shape) == (2, 6 - khw[0], 7 - khw[1], 7)
    _close(out, ref, f"l2_patch_distances {khw}")


def test_general_path_is_the_patch_distance():
    """The conv path's cancellation formula equals sum (x_patch - w)^2,
    written out in float64."""
    x, protos = _data((1, 4, 4, 5, 3), seed=2, kh=2, kw=2)
    out = l2_patch_distances(torch.from_numpy(x).double(),
                             torch.from_numpy(protos).double())
    assert out.dtype == torch.float64  # never downcast
    ref = np.zeros((1, 3, 3, 3))
    for i in range(3):
        for j in range(3):
            patch = x[0, i:i + 2, j:j + 2].astype(np.float64)
            ref[0, i, j] = ((patch[None] - protos) ** 2).sum(axis=(1, 2, 3))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_channels_last_ranks_and_2d_prototypes():
    """x of rank 3 (N, S, D) or 5 (N, T, H, W, D); prototypes (P, D) or
    (P, 1, 1, D)."""
    x, protos = _data((2, 4, 3, 8, 5), seed=3)
    d4, m4 = l2_min_torch(torch.from_numpy(x), torch.from_numpy(protos))
    d3, m3 = l2_min_torch(torch.from_numpy(x).reshape(2, 12, 8),
                          torch.from_numpy(protos).reshape(5, 8))
    d5, m5 = l2_min_torch(torch.from_numpy(x).reshape(2, 2, 2, 3, 8),
                          torch.from_numpy(protos))
    assert tuple(d3.shape) == (2, 12, 5) and tuple(d5.shape) == (2, 2, 2, 3, 5)
    torch.testing.assert_close(d3, d4.reshape(2, 12, 5), rtol=0, atol=0)
    torch.testing.assert_close(d5, d4.reshape(2, 2, 2, 3, 5), rtol=0, atol=0)
    torch.testing.assert_close(m3, m4, rtol=0, atol=0)
    torch.testing.assert_close(m5, m4, rtol=0, atol=0)


def test_default_impl_on_cpu_is_the_plain_version():
    """impl=None sends CPU tensors through the kernel's wrapper, which runs
    the plain version there and counts no launch."""
    x, protos = (torch.from_numpy(a) for a in _data(SHAPES[1], seed=4))
    before = l2_min_cuda.launches
    dist_a, min_a = l2_min_head(x, protos)
    dist_b, min_b = l2_min_head(x, protos, impl="torch")
    dist_c, min_c = l2_min_cuda(x, protos)
    assert l2_min_cuda.launches == before
    for a, b in ((dist_a, dist_b), (min_a, min_b), (dist_c, dist_b),
                 (min_c, min_b)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown head impl"):
        l2_min_head(x, protos, impl="pallas")


def test_bf16_inputs_compute_in_fp32():
    x, protos = _data(SHAPES[0], seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    dist, min_d = l2_min_torch(xb, torch.from_numpy(protos))
    assert dist.dtype == min_d.dtype == torch.float32
    ref_dist, ref_min = l2_min_torch(xb.double(),
                                     torch.from_numpy(protos).double())
    # fp32 cancellation error follows |x|^2 + |w|^2 (~350 here), not dist
    scale = float((xb.double() ** 2).sum(-1).max()
                  + (torch.from_numpy(protos).double() ** 2).sum(-1).max())
    np.testing.assert_allclose(dist.numpy(), ref_dist.numpy(), rtol=0,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(min_d.numpy(), ref_min.numpy(), rtol=0,
                               atol=1e-6 * scale)


def test_empty_batch():
    """N=0 gives empty outputs of the right shapes (the positions are
    counted from the shape, not inferred from the element count)."""
    x, protos = (torch.from_numpy(a) for a in _data((1, 7, 7, 16, 5)))
    dist, min_d = l2_min_head(x[:0], protos)
    assert tuple(dist.shape) == (0, 7, 7, 5) and tuple(min_d.shape) == (0, 5)
    from protoasnet_tpu_torch.ops.roi_cosine import roi_cosine_torch

    roi, sim = roi_cosine_torch(torch.zeros(0, 7, 7, 5), x[:0],
                                protos[:, 0, 0])
    assert tuple(roi.shape) == (0, 5, 16) and tuple(sim.shape) == (0, 5)
