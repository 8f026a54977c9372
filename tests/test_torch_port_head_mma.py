"""The two head kernels' arithmetic and launch plans, on the CPU.

The kernels (``csrc/roi_cosine.cu``, ``csrc/l2_min.cu``) run only on the
card (tests/test_torch_port_cuda.py). Here their accumulation orders are
emulated in plain torch and held against float64 at the smoke's limits and
against the JAX package's Pallas kernels (interpret mode):

- ROI-cosine: roi^T = feat^T @ occ on the tensor cores, each k-step's
  product summed from zero and added to the running fp32 sums; bf16 inputs
  one m16n8k16 product a k16 step (exact in fp32), fp32 inputs 3xTF32 (lo *
  hi + hi * lo + hi * hi a k8 step); the sim's three sums per 128-wide d
  tile, added over the cluster's blocks in rank order;
- L2 + min: fp32 dot products, |x|^2 and |w|^2 per block's d range, added
  over the cluster's blocks in rank order, then relu and the minimum.

Also the wrappers' launch plans (cluster size, blocks, shared memory) at
the three served head shapes and the choice of the staging path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protoasnet_tpu.ops.pallas_l2 import l2_min_pallas
from protoasnet_tpu.ops.pallas_roi import roi_cosine_pallas
from protoasnet_tpu_torch.ops import l2_min_cuda as l2_mod
from protoasnet_tpu_torch.ops import roi_cosine_cuda as roi_mod
from protoasnet_tpu_torch.ops.fused_c2p1d_cuda import H100_SMEM, H100_SMS
from protoasnet_tpu_torch.ops.temporal_conv import split_tf32
from torch_port_isolation import isolated

_isolated = isolated(1)

LIMIT = 1e-5  # chip_smoke.py phase 2: roi rel. to max |roi|, sim absolute
H100_SM_SMEM = 233472  # shared memory of one SM (228 KB)
BLOCK_RESERVED = 1024  # shared memory the runtime keeps per block
# the served heads at the server's largest bucket (chip_smoke.py)
VIDEO_HEAD = (128, 8 * 14 * 14, 40, 256)
IMAGE_HEAD = (128, 7 * 7, 40, 512)
L2_HEAD = (128, 7 * 7, 30, 512)


def _roi_data(n, s, p, d, seed, scale=0.05):
    """occ U(0, scale) and unit-normal feat, as chip_smoke.py draws them;
    U(0, 1) prototypes, as the model's init."""
    rng = np.random.default_rng(seed)
    occ = rng.uniform(0, scale, size=(n, s, p)).astype(np.float32)
    feat = rng.standard_normal((n, s, d)).astype(np.float32)
    protos = rng.uniform(size=(p, d)).astype(np.float32)
    return occ, feat, protos


def _steps(occ, feat, step):
    """(K / step, N, P, D) float64 partial products of each k-step, K
    padded with zeros to whole steps (the kernel stages zeros past S)."""
    n, s, p = occ.shape
    pad = -s % step
    occ = torch.nn.functional.pad(occ.double(), (0, 0, 0, pad))
    feat = torch.nn.functional.pad(feat.double(), (0, 0, 0, pad))
    k = (s + pad) // step
    o = occ.reshape(n, k, step, p)
    f = feat.reshape(n, k, step, -1)
    return torch.einsum("nksp,nksd->knpd", o, f)


def _running_fp32(parts):
    """Each step's product rounded to fp32 (the tensor cores' sum of one
    step, started from zero) and added to the running fp32 sums in order."""
    acc = torch.zeros(parts.shape[1:], dtype=torch.float32)
    for q in parts:
        acc = acc + q.float()
    return acc


def emulate_roi(occ, feat, protos):
    """The kernel's roi and sim for occ, feat (N, S, P/D) of one dtype and
    fp32 protos (P, D): bf16 one product a k16 step, fp32 3xTF32 a k8
    step; sim from per-block (128 d) fp32 sums added in rank order."""
    if occ.dtype == torch.bfloat16:
        roi = _running_fp32(_steps(occ, feat, 16))
    else:
        oh, ol = split_tf32(occ)
        fh, fl = split_tf32(feat)
        roi = _running_fp32(_steps(ol, fh, 8) + _steps(oh, fl, 8)
                            + _steps(oh, fh, 8))
    d = feat.shape[-1]
    c = roi_mod.plan(1, 1, 1, d, 2).cluster
    sums = torch.zeros((3,) + roi.shape[:2], dtype=torch.float32)
    for rank in range(c):
        part = torch.zeros_like(sums)
        for d0 in range(rank * roi_mod.D_BLOCK, d, c * roi_mod.D_BLOCK):
            r = roi[..., d0:d0 + roi_mod.D_BLOCK].double()
            w = protos[None, :, d0:d0 + roi_mod.D_BLOCK].double()
            part += torch.stack([(r * w).sum(-1), (r * r).sum(-1),
                                 (w * w).sum(-1).expand_as(r[..., 0])]
                                ).float()
        sums += part
    dot, nrm, pp = sums
    cos = dot / (nrm.sqrt().clamp_min(1e-8) * pp.sqrt().clamp_min(1e-8))
    return roi, (cos + 1) / 2


def _rel(out, ref):
    return ((out.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("s", [VIDEO_HEAD[1], IMAGE_HEAD[1]])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_accumulation_keeps_the_smoke_limit(s, dtype):
    """At K = S = 1568 (video) and 49 (image), the kernel's accumulation
    order stays within the smoke's 1e-5 of max |roi| and 1e-5 absolute of
    sim against float64 of the same inputs, in both dtypes."""
    occ, feat, protos = (torch.from_numpy(a) for a in
                         _roi_data(2, s, 40, 256, seed=s))
    occ, feat = occ.to(dtype), feat.to(dtype)
    roi, sim = emulate_roi(occ, feat, protos)
    ref_roi = torch.einsum("nsp,nsd->npd", occ.double(), feat.double())
    p64 = protos.double()
    ref_cos = (ref_roi * p64).sum(-1) / (ref_roi.norm(dim=-1)
                                         * p64.norm(dim=-1))
    assert _rel(roi, ref_roi) <= LIMIT / 5
    assert (sim.double() - (ref_cos + 1) / 2).abs().max().item() <= LIMIT
    if dtype == torch.float32 and s > 1000:
        # one TF32 product alone misses the limit: the split is what holds
        oh, _ = split_tf32(occ)
        fh, _ = split_tf32(feat)
        assert _rel(_running_fp32(_steps(oh, fh, 8)), ref_roi) > LIMIT


# (n, s, p, d): S off the 64/32-position stage (70), P over one block's
# 40 (45: two prototype groups) and pruned (6), D over one 128-wide tile
# (200: a cluster of two) and off 16 bytes (65)
ROI_SHAPES = [(2, 70, 45, 200), (1, 33, 6, 65), (2, 49, 40, 256)]


@pytest.mark.parametrize("shape", ROI_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_roi_emulation_matches_pallas(shape, dtype):
    """The emulated kernel against the JAX Pallas kernel (interpret mode)
    on the same inputs (bf16 inputs rounded first, fp32 in both)."""
    occ, feat, protos = _roi_data(*shape, seed=sum(shape), scale=1.0)
    occ_t = torch.from_numpy(occ).to(dtype)
    feat_t = torch.from_numpy(feat).to(dtype)
    roi, sim = emulate_roi(occ_t, feat_t, torch.from_numpy(protos))
    roi_j, sim_j = roi_cosine_pallas(jnp.asarray(occ_t.float().numpy()),
                                     jnp.asarray(feat_t.float().numpy()),
                                     jnp.asarray(protos), interpret=True)
    np.testing.assert_allclose(roi.numpy(), np.asarray(roi_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sim.numpy(), np.asarray(sim_j), rtol=1e-5,
                               atol=1e-5)


def emulate_l2(x, w):
    """The kernel's dist and min_d for fp32 x (N, S, D), w (P, D): each
    block's d range gives fp32 partial dot products, |x|^2 and |w|^2, added
    over the cluster's blocks in rank order; relu, then the minimum."""
    d = x.shape[-1]
    plan = l2_mod.plan(1, 1, d)
    dot = torch.zeros(x.shape[:2] + w.shape[:1], dtype=torch.float32)
    x2 = torch.zeros(x.shape[:2], dtype=torch.float32)
    p2 = torch.zeros(w.shape[:1], dtype=torch.float32)
    for rank in range(plan.cluster):
        sl = slice(rank * plan.d_range, (rank + 1) * plan.d_range)
        xs, ws = x[..., sl], w[:, sl]
        dot = dot + torch.einsum("nsd,pd->nsp", xs.double(),
                                 ws.double()).float()
        x2 = x2 + (xs.double() ** 2).sum(-1).float()
        p2 = p2 + (ws.double() ** 2).sum(-1).float()
    dist = torch.relu((x2[..., None] - 2 * dot) + p2)
    return dist, dist.amin(1)


def _l2_data(n, s, p, d, seed):
    rng = np.random.default_rng(seed)
    x = 1.0 / (1.0 + np.exp(-rng.standard_normal((n, s, d))))
    w = rng.uniform(size=(p, d))
    return x.astype(np.float32), w.astype(np.float32)


# ProtoPNet's head at batch 2 (a cluster of 2 blocks of 256 d), D off one
# 256-wide range (100: one block, partial), D = 1, D = 1000 (a cluster of
# 4, the last range partial) and D past 8 * 256 (2100: a cluster of 5 with
# ranges of 512)
@pytest.mark.parametrize("shape", [(2, 49, 30, 512), (2, 70, 7, 100),
                                   (1, 5, 33, 1), (1, 9, 3, 1000),
                                   (1, 9, 3, 2100)])
def test_l2_emulation_matches_pallas_and_float64(shape):
    n, s, p, d = shape
    x, w = _l2_data(*shape, seed=d)
    dist, min_d = emulate_l2(torch.from_numpy(x), torch.from_numpy(w))
    dist_j, min_j = l2_min_pallas(jnp.asarray(x.reshape(n, s, 1, d)),
                                  jnp.asarray(w.reshape(p, 1, 1, d)),
                                  interpret=True)
    np.testing.assert_allclose(dist.numpy(), np.asarray(dist_j).reshape(
        n, s, p), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(min_d.numpy(), np.asarray(min_j), rtol=1e-4,
                               atol=1e-4)
    x64, w64 = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    ref = ((x64 ** 2).sum(-1)[..., None] - 2 * x64 @ w64.T
           + (w64 ** 2).sum(-1)).clamp_min(0)
    scale = ((x64 ** 2).sum(-1).max() + (w64 ** 2).sum(-1).max()).item()
    assert (dist.double() - ref).abs().max().item() <= LIMIT * scale


def _by_smem(smem, static):
    """Blocks of one kernel an SM holds at once by shared memory."""
    return H100_SM_SMEM // (smem + static + BLOCK_RESERVED)


@pytest.mark.parametrize("shape, waves", [(VIDEO_HEAD, 1), (IMAGE_HEAD, 2)])
@pytest.mark.parametrize("elem", [2, 4])
def test_roi_plan_fills_the_card(shape, waves, elem):
    """At the two served ROI heads: at least 132 blocks, clusters of at
    most 8 covering D, shared memory within a block's 227 KB; by shared
    memory and the launch bounds' three blocks an SM, the video head's
    blocks are all resident at once and the image head's within two
    waves."""
    n, s, p, d = shape
    pl = roi_mod.plan(n, s, p, d, elem)
    assert pl.blocks >= H100_SMS
    assert pl.cluster <= roi_mod.MAX_CLUSTER
    assert pl.cluster * roi_mod.D_BLOCK >= d
    assert pl.blocks == pl.cluster * n * -(-p // roi_mod.P_BLOCK)
    assert pl.smem == roi_mod.smem_bytes(elem, s) <= H100_SMEM
    static = (4 + 8) * 3 * roi_mod.P_BLOCK * 4  # red + recv
    per_sm = min(_by_smem(pl.smem, static), 3)
    assert per_sm * H100_SMS * waves >= pl.blocks


def test_roi_ring_stages():
    """Stages of 64 (bf16) / 32 (fp32) positions, 22,528 bytes each: the
    video head fills four, the image head what its S=49 needs."""
    assert roi_mod.smem_bytes(2, VIDEO_HEAD[1]) == 4 * 22528
    assert roi_mod.smem_bytes(4, VIDEO_HEAD[1]) == 4 * 22528
    assert roi_mod.smem_bytes(2, IMAGE_HEAD[1]) == 1 * 22528
    assert roi_mod.smem_bytes(4, IMAGE_HEAD[1]) == 2 * 22528
    assert roi_mod.smem_bytes(2, 1) == 22528


def test_l2_plan_fills_the_card_in_one_wave():
    """ProtoPNet's head: clusters of 2 blocks of 256 d, 256 blocks, two an
    SM by shared memory: all resident at once (and the block's warps
    cover its d range in one 32-wide stage each)."""
    n, s, p, d = L2_HEAD
    pl = l2_mod.plan(n, p, d)
    assert (pl.cluster, pl.d_range) == (2, 256)
    assert pl.d_range == l2_mod.WARPS * l2_mod.D_CHUNK
    assert pl.blocks == 256 >= H100_SMS
    assert pl.smem == l2_mod.SMEM <= H100_SMEM
    static = (8 + 8) * l2_mod.P_BLOCK * 4  # mins + recv_min
    assert _by_smem(pl.smem, static) * H100_SMS >= pl.blocks


@pytest.mark.parametrize("d", [1, 63, 64, 65, 100, 512, 513, 1000, 2048,
                               2049, 2100, 3584, 3585, 4096, 5000])
def test_l2_plan_covers_any_d(d):
    """Clusters of at most 8 blocks cover D, and every block has d."""
    pl = l2_mod.plan(3, 5, d)
    assert 1 <= pl.cluster <= l2_mod.MAX_CLUSTER
    assert pl.d_range % (l2_mod.WARPS * l2_mod.D_CHUNK) == 0
    assert pl.cluster * pl.d_range >= d > (pl.cluster - 1) * pl.d_range


# (elem, p, d, pointers, cp.async?): the served heads; bf16 P=6 (12-byte
# occ rows) and P=13; D=65; fp32 P=6 (24 bytes); a view 2 bytes off
ROI_STAGING = [(2, 40, 256, (0, 256), True), (4, 40, 512, (0, 256), True),
               (2, 6, 256, (0, 256), False), (2, 13, 256, (0, 256), False),
               (2, 40, 65, (0, 256), False), (4, 6, 256, (0, 256), False),
               (4, 8, 256, (0, 256), True), (2, 40, 256, (2, 256), False)]


@pytest.mark.parametrize("elem, p, d, ptrs, aligned", ROI_STAGING)
def test_roi_staging_path_choice(elem, p, d, ptrs, aligned):
    assert roi_mod.staging_aligned(elem, p, d, *ptrs) is aligned


@pytest.mark.parametrize("d, ptrs, aligned", [(512, (0, 256), True),
                                              (63, (0, 256), False),
                                              (1, (0, 256), False),
                                              (512, (4, 256), False)])
def test_l2_staging_path_choice(d, ptrs, aligned):
    assert l2_mod.staging_aligned(d, *ptrs) is aligned
