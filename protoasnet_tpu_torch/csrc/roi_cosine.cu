// Fused occurrence-weighted ROI pooling + prototype cosine head, forward,
// on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel protoasnet_tpu/ops/pallas_roi.py
// (roi_cosine_pallas -> _forward/_kernel). Per sample n and prototype p:
//
//   roi[n,p,:] = sum_s occ[n,s,p] * feat[n,s,:]                 (fp32 sums)
//   sim[n,p]   = (dot(roi,proto[p]) / (max(|roi|,eps) * pnorm[p]) + 1) / 2
//
// with pnorm[p] = max(|proto[p]|, eps) computed here too, so that a call
// is one launch. occ and feat are both fp32 or both bf16; protos, roi and
// sim are fp32.
//
// What bounds it on an H100: at the flagship head shape (N=128, S=1568,
// P=40, D=256) the function must move ~124 MB with bf16 inputs and ~243 MB
// with fp32 inputs (feat dominates: 0.8 / 1.6 MB a sample) and do 2*N*S*P*D
// = 4.1 GFLOP. On the tensor cores that is bound by bytes in both dtypes:
// ~37 us (bf16) and ~73 us (fp32) at 3.35 TB/s. So the design is about
// reading each sample's feat once, with enough bytes in flight, and keeping
// the products off the issue slots.
//
// Products, on the tensor cores with mma.sync, as roi^T = feat^T @ occ
// (M = d, N = p, K = s), so that P=40 is five n8 tiles without padding:
//  - bf16: mma.m16n8k16 fed by ldmatrix.trans from the staged [s][d] and
//    [s][p] rows. A bf16 product is exact in fp32;
//  - fp32: 3xTF32 on mma.m16n8k8: each operand v is split into hi =
//    rna.tf32(v) and lo = rna.tf32(v - hi) in registers, and lo*hi + hi*lo
//    + hi*hi is summed; the dropped lo*lo is ~2^-22 of a product, so the
//    result keeps fp32 accuracy, where one TF32 product would not;
//  - in both, the tensor cores truncate when they accumulate, which over
//    K = 1568 can drift past the 1e-5 limit: each k-step's product (or
//    three products) starts from zero and is added to the running sums by
//    fp32 adds (round to nearest). tests/test_torch_port_head_mma.py
//    emulates both orders against float64.
//
// Design:
//  - a block of 4 warps takes one sample, 128 d (32 per warp: two m16
//    tiles) and up to 40 prototypes (five n8 tiles, 40 fp32 sums a
//    thread). A sample's d tiles form one thread-block cluster of C =
//    ceil(D/128) blocks (at most 8; past 1024, each block walks every C-th
//    d tile): grid (C*N, ceil(P/40)). So each feat element is read from
//    device memory by one block, once; occ (a fifth of feat's bytes at
//    D=256) by each block of the cluster, the second time mostly from L2;
//  - the positions stream through a ring of up to 4 stages of 64 (bf16)
//    or 32 (fp32) positions, 22 KB each, filled by 16-byte cp.async: all
//    stages are issued before the first product, so each block keeps up to
//    90 KB in flight. The ring has what S needs, at most 4 stages, so a
//    short S (the image head, S=49) takes 22-45 KB and more blocks fit an
//    SM. A long ring leaves room for two blocks an SM, which then get up
//    to 255 registers; a short one gets 168 (three blocks by registers):
//    both measured faster than the other budgets (scripts/
//    head_kernels_probe.py). The video head's 128 clusters of 2 are all
//    resident at once; the image head's clusters of 4 take two waves;
//  - rows of feat and occ that are not 16-byte multiples (D=65, bf16
//    P=6) or views off a 16-byte boundary take an element-wise staging
//    path into the same ring. Positions past S are zeros;
//  - shared-memory rows are 136 (feat) and 40 (occ) elements, which keeps
//    ldmatrix and the fp32 fragment loads free of bank conflicts;
//  - epilogue: the block's prototype slice (fp32, rows of 132) is staged
//    into a free ring slot while the last stage is multiplied; each thread
//    writes its roi elements and sums roi*proto, roi^2 and proto^2 over
//    its d; warp shuffles, then shared memory, give the block's sums per
//    prototype, which each block stores into the cluster's first block
//    through distributed shared memory (stores, no round trips); after one
//    cluster barrier that block adds the C blocks' sums in rank order and
//    writes sim. The five n8 tiles are multiplied whatever P is (a block
//    with fewer prototypes multiplies zero columns). Every
//    block arrives at a relaxed cluster barrier on
//    entry and waits on it before its first store into another block's
//    memory, so that every block of the cluster has started (the wait
//    comes after the products, so it costs nothing in the ring's time).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWD = 32;            // d per warp: two m16 tiles
constexpr int kDB = kWarps * kWD;  // d per block
constexpr int kPG = 40;            // prototypes per block: five n8 tiles
constexpr int kNT = kPG / 8;
constexpr int kMaxStages = 4;
constexpr int kMaxCluster = 8;
// row pitches (elements): feat 272 B (bf16) / 544 B (fp32) and occ 80 B /
// 160 B, so 8 consecutive rows fall on 8 different 16-byte bank groups
// (ldmatrix) and fp32 fragment reads (t4 * pitch + g) on 32 banks
constexpr int kFP = kDB + 8;
constexpr int kOP = kPG;
// the prototype slice, fp32 rows of 132 (t4 * 8 + g on 32 banks), staged
// into one ring slot for the epilogue
constexpr int kPP = kDB + 4;
constexpr float kEps = 1e-8f;

template <typename In>
struct Layout {
  static constexpr int kKC = sizeof(In) == 2 ? 64 : 32;  // positions a stage
  static constexpr int kStep = sizeof(In) == 2 ? 16 : 8;  // mma k-step
  static constexpr int kFeatElems = kKC * kFP;
  static constexpr int kStageElems = kKC * (kFP + kOP);
  static constexpr int kStageBytes = kStageElems * static_cast<int>(sizeof(In));
  static_assert((kFeatElems * sizeof(In)) % 16 == 0 && kStageBytes % 16 == 0,
                "stages keep 16-byte alignment");
  static_assert(kKC % kStep == 0, "whole k-steps a stage");
  static_assert(kPG * kPP * 4 <= kStageBytes, "a slot holds the slice");
};

// stages of the ring for S positions: what S needs, at least 1, at most 4
template <typename In>
__host__ __device__ inline int ring_stages(int S) {
  const int nk = (S + Layout<In>::kKC - 1) / Layout<In>::kKC;
  return nk < 1 ? 1 : (nk > kMaxStages ? kMaxStages : nk);
}

template <typename In>
struct Params {
  const In* occ;
  const In* feat;
  const float* protos;
  float* roi;
  float* sim;
  int S, P, D;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// all but the newest `pending` groups have landed (pending = stages - 1)
__device__ __forceinline__ void cp_async_wait_ring(int pending) {
  if (pending >= 3) {
    cp_async_wait<3>();
  } else if (pending == 2) {
    cp_async_wait<2>();
  } else if (pending == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p)));
}

// d = a * b on the tensor cores (d starts from zero)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = hi + lo + O(2^-22 v), both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// every block of the cluster has started once all have arrived: arrive on
// entry (no memory ordering), wait before the first remote access
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename In>
__device__ __forceinline__ In zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Stage positions [k * kKC, (k + 1) * kKC) of the sample: feat's d columns
// [d0, d0 + kDB) and occ's np prototype columns from p0, into ring slot
// `slot`. Rows past S, columns past D and occ's columns past np are
// zeros.
template <typename In, bool kAligned>
__device__ __forceinline__ void stage(In* ring, int slot, const Params<In>& p,
                                      const In* occ_n, const In* feat_n,
                                      int k, int d0, int p0, int np) {
  using L = Layout<In>;
  In* const fs = ring + slot * L::kStageElems;
  In* const os = fs + L::kFeatElems;
  const int s0 = k * L::kKC;
  const int tid = threadIdx.x;
  if constexpr (kAligned) {
    constexpr int kPer = 16 / sizeof(In);  // elements per 16 bytes
    constexpr int kFRow = kDB / kPer;      // 16-byte pieces of a feat row
    static_assert((L::kKC * kFRow) % kThreads == 0, "whole passes");
#pragma unroll
    for (int e0 = 0; e0 < L::kKC * kFRow; e0 += kThreads) {
      const int e = e0 + tid;
      const int r = e / kFRow, c = e % kFRow * kPer;
      const bool ok = s0 + r < p.S && d0 + c < p.D;
      cp_async16(fs + r * kFP + c,
                 ok ? feat_n + static_cast<int64_t>(s0 + r) * p.D + d0 + c
                    : p.feat,
                 ok);
    }
    // rows of kPG columns, those past np zero-filled (np * sizeof(In) is a
    // multiple of 16): a width known at compile time keeps the divisions
    // out of the loop
    constexpr int kORow = kPG / kPer;
    for (int e = tid; e < L::kKC * kORow; e += kThreads) {
      const int r = e / kORow, c = e % kORow * kPer;
      const bool ok = s0 + r < p.S && c < np;
      cp_async16(os + r * kOP + c,
                 ok ? occ_n + static_cast<int64_t>(s0 + r) * p.P + p0 + c
                    : p.occ,
                 ok);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < L::kKC * kDB; e += kThreads) {
      const int r = e / kDB, c = e % kDB;
      const bool ok = s0 + r < p.S && d0 + c < p.D;
      fs[r * kFP + c] =
          ok ? feat_n[static_cast<int64_t>(s0 + r) * p.D + d0 + c] : zero<In>();
    }
    for (int e = tid; e < L::kKC * kPG; e += kThreads) {
      const int r = e / kPG, c = e % kPG;
      const bool ok = s0 + r < p.S && c < np;
      os[r * kOP + c] =
          ok ? occ_n[static_cast<int64_t>(s0 + r) * p.P + p0 + c] : zero<In>();
    }
  }
}

// acc[mt][j] += the warp's roi^T tile (d: two m16 tiles, p: n8 tile j < nt)
// over the kc staged positions at fs (feat rows) and os (occ rows).
template <typename In>
__device__ __forceinline__ void multiply(float (&acc)[2][kNT][4],
                                         const In* fs, const In* os, int kc,
                                         int nt, int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (sizeof(In) == 2) {
    // A = feat^T (rows d, k = s) from [s][d]: matrix q of ldmatrix.x4 is
    // (k rows (q >> 1) * 8.., d columns (q & 1) * 8..); B = occ (k = s,
    // n = p) from [s][p]: x4 gives two n8 tiles, x2 one
    const int q = lane >> 3, r = lane & 7;
    const In* const fa = fs + (r + (q >> 1) * 8) * kFP + warp * kWD + (q & 1) * 8;
    const In* const ob = os + (lane & 15) * kOP + (lane >> 4) * 8;
#pragma unroll 2
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4_trans(a[mt], fa + kk * kFP + mt * 16);
      uint32_t b[kNT][2];
#pragma unroll
      for (int jp = 0; jp < (kNT + 1) / 2; ++jp) {
        if (2 * jp + 1 < nt) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, ob + kk * kOP + jp * 16);
          b[2 * jp][0] = bb[0];
          b[2 * jp][1] = bb[1];
          b[2 * jp + 1][0] = bb[2];
          b[2 * jp + 1][1] = bb[3];
        } else if (2 * jp < nt) {
          ldmatrix_x2_trans(b[2 * jp][0], b[2 * jp][1],
                            os + (kk + (lane & 15)) * kOP + jp * 16);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nt) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(d, a[mt], b[j][0], b[j][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] += d[e];
        }
      }
    }
  } else {
    // A fragment (m = d, k = s): (g, t4), (g+8, t4), (g, t4+4), (g+8, t4+4);
    // B fragment (k = s, n = p): (t4, g), (t4+4, g)
    const float* const fa = reinterpret_cast<const float*>(fs) +
                            t4 * kFP + warp * kWD + g;
    const float* const ob = reinterpret_cast<const float*>(os) + t4 * kOP + g;
#pragma unroll 2
    for (int kk = 0; kk < kc; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* const x = fa + kk * kFP + mt * 16;
        split_tf32(x[0], ahi[mt][0], alo[mt][0]);
        split_tf32(x[8], ahi[mt][1], alo[mt][1]);
        split_tf32(x[4 * kFP], ahi[mt][2], alo[mt][2]);
        split_tf32(x[4 * kFP + 8], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j >= nt) continue;
        const float* const o = ob + kk * kOP + j * 8;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(o[0], bh0, bl0);
        split_tf32(o[4 * kOP], bh1, bl1);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(d, alo[mt], bh0, bh1);
          mma_tf32(d, ahi[mt], bl0, bl1);
          mma_tf32(d, ahi[mt], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][e] += d[e];
        }
      }
    }
  }
}

// Stage the block's prototype slice (np rows, d columns [d0, d0 + kDB)) as
// fp32 rows of kPP into ps: cp.async where the staging is aligned (then D
// is a multiple of 4 and protos starts on a 16-byte boundary).
template <bool kAligned>
__device__ __forceinline__ void stage_protos(float* ps, const float* protos,
                                             int p0, int np, int d0, int D) {
  const int tid = threadIdx.x;
  if constexpr (kAligned) {
    constexpr int kRow = kDB / 4;  // 16-byte pieces of a row
    for (int e = tid; e < np * kRow; e += kThreads) {
      const int r = e / kRow, c = e % kRow * 4;
      const bool ok = d0 + c < D;
      cp_async16(ps + r * kPP + c,
                 ok ? protos + static_cast<int64_t>(p0 + r) * D + d0 + c
                    : protos,
                 ok);
    }
  } else {
    for (int e = tid; e < np * kDB; e += kThreads) {
      const int r = e / kDB, c = e % kDB;
      ps[r * kPP + c] =
          d0 + c < D ? protos[static_cast<int64_t>(p0 + r) * D + d0 + c] : 0.f;
    }
  }
}

// kMinBlocks: blocks an SM must hold by registers; a ring of 3-4 stages
// leaves room for two by shared memory, and two get up to 255 registers; a
// shorter ring fits more, and three (168 registers) run faster there than
// two or four.
template <typename In, bool kAligned, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
roi_cosine_kernel(const Params<In> p, int C, int ns) {
  using L = Layout<In>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  In* const ring = reinterpret_cast<In*>(smem_raw);
  __shared__ float red[kWarps][3][kPG];
  // rank 0: the sums of each block of the cluster, stored there by each
  __shared__ float recv[kMaxCluster][3][kPG];

  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // blockIdx.x % C
  const int n = blockIdx.x / C;
  const int p0 = blockIdx.y * kPG;
  const int np = min(kPG, p.P - p0);
  // all five n8 tiles are multiplied, also past np (zero columns, never
  // stored): a count known at compile time lets the compiler schedule the
  // mma stream; one taken from P ran 12-30% slower at the served heads.
  const int nt = kNT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const In* const occ_n = p.occ + static_cast<int64_t>(n) * p.S * p.P;
  const In* const feat_n = p.feat + static_cast<int64_t>(n) * p.S * p.D;
  const int nk = (p.S + L::kKC - 1) / L::kKC;
  const int ntiles = (p.D + kDB - 1) / kDB;

  // each warp's sums of roi*proto, roi^2 and proto^2 over its d, per
  // prototype; lane (g = 0, t4) owns the prototypes j*8 + 2*t4 + {0, 1}
  for (int i = tid; i < kWarps * 3 * kPG; i += kThreads)
    (&red[0][0][0])[i] = 0.f;
  __syncthreads();

  for (int dt = rank; dt < ntiles; dt += C) {
    const int d0 = dt * kDB;
    float acc[2][kNT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

    // every slot filled before the first product; stage k + ns refills
    // slot k % ns once all warps are done with it. The prototype slice
    // goes into a free slot while the last stage is multiplied (or into
    // slot 0 after the loop when no slot is free).
    float* ps = nullptr;
    for (int k = 0; k < ns; ++k) {
      if (k < nk)
        stage<In, kAligned>(ring, k, p, occ_n, feat_n, k, d0, p0, np);
      cp_async_commit();
    }
    for (int k = 0; k < nk; ++k) {
      cp_async_wait_ring(ns - 1);  // stage k has landed (this thread's part)
      __syncthreads();             // ... everyone's
      if (k == nk - 1 && ns > 1) {
        ps = reinterpret_cast<float*>(ring + (k + 1) % ns * L::kStageElems);
        stage_protos<kAligned>(ps, p.protos, p0, np, d0, p.D);
      }
      const In* const fs = ring + (k % ns) * L::kStageElems;
      const int kc = min(L::kKC, p.S - k * L::kKC);
      multiply<In>(acc, fs, fs + L::kFeatElems, kc, nt, warp, lane);
      __syncthreads();  // slot k % ns is free
      if (k + ns < nk)
        stage<In, kAligned>(ring, k % ns, p, occ_n, feat_n, k + ns, d0, p0,
                            np);
      cp_async_commit();
    }
    if (ps == nullptr) {
      ps = reinterpret_cast<float*>(ring);
      stage_protos<kAligned>(ps, p.protos, p0, np, d0, p.D);
      cp_async_commit();  // wait_group waits for committed groups only
    }
    cp_async_wait<0>();
    __syncthreads();  // the prototype slice has landed

    // roi, and the tile's three sums: this thread's d, then a butterfly
    // over g (the 8 lanes of one t4 hold the same prototypes)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      if (j >= nt) break;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int pl = j * 8 + 2 * t4 + c;
        float sv[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int dl = warp * kWD + mt * 16 + g + h * 8;
            if (pl < np && d0 + dl < p.D) {
              const float v = acc[mt][j][2 * h + c];
              const float w = ps[pl * kPP + dl];
              p.roi[(static_cast<int64_t>(n) * p.P + p0 + pl) * p.D + d0 +
                    dl] = v;
              sv[0] = fmaf(v, w, sv[0]);
              sv[1] = fmaf(v, v, sv[1]);
              sv[2] = fmaf(w, w, sv[2]);
            }
          }
        }
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          float s = sv[v];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (g == 0) red[warp][v][pl] += s;
        }
      }
    }
    __syncthreads();  // the ring (and the slice in it) is free again
  }
  // the block's sums go to rank 0's `recv` (stores: no round trip), once
  // every block of the cluster has started
  cluster_wait();
  float* const dst = cluster.map_shared_rank(&recv[0][0][0], 0) +
                     rank * 3 * kPG;
  for (int i = tid; i < 3 * kPG; i += kThreads) {
    const int v = i / kPG, pl = i % kPG;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][v][pl];
    dst[i] = s;
  }
  cluster.sync();  // every block's sums are in rank 0's `recv`
  if (rank == 0 && tid < np) {
    float dot = 0.f, nrm = 0.f, pp = 0.f;
    for (int r = 0; r < C; ++r) {
      dot += recv[r][0][tid];
      nrm += recv[r][1][tid];
      pp += recv[r][2][tid];
    }
    const float rnorm = fmaxf(sqrtf(nrm), kEps);
    const float pnorm = fmaxf(sqrtf(pp), kEps);
    const float cosv = dot / (rnorm * pnorm);
    p.sim[static_cast<int64_t>(n) * p.P + p0 + tid] = (cosv + 1.f) * 0.5f;
  }
}

// Opt in to `bytes` of dynamic shared memory, and ask for the largest
// shared-memory carveout: left to the driver, an SM may keep less shared
// memory than the blocks that fit it by the table need.
template <typename Kernel>
cudaError_t set_attributes(Kernel kern, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The launch of the kernel for S positions: `clusters` clusters of C
// blocks along grid.x, `groups` rows of them (one a 40 prototypes) along
// grid.y.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int ns;  // ring stages

  template <typename In>
  void init(int S, int C, unsigned clusters, unsigned groups,
            cudaStream_t st) {
    ns = ring_stages<In>(S);
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(static_cast<unsigned>(C) * clusters, groups, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = ns * Layout<In>::kStageBytes;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// the register budget of the kernel for a ring of ns stages
constexpr int min_blocks(int ns) { return ns >= 3 ? 2 : 3; }

template <typename In, bool kAligned>
int launch(const Params<In>& p, int N, int C, cudaStream_t st) {
  Launch l;
  l.init<In>(p.S, C, N, (p.P + kPG - 1) / kPG, st);
  auto kern = l.ns >= 3
                  ? roi_cosine_kernel<In, kAligned, min_blocks(3)>
                  : roi_cosine_kernel<In, kAligned, min_blocks(1)>;
  cudaError_t e = set_attributes(kern, l.cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&l.cfg, kern, p, C, l.ns);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int active_clusters(int S, int C) {
  Launch l;
  l.init<In>(S, C, 1, 1, nullptr);
  auto kern = l.ns >= 3
                  ? roi_cosine_kernel<In, true, min_blocks(3)>
                  : roi_cosine_kernel<In, true, min_blocks(1)>;
  cudaError_t e = set_attributes(kern, l.cfg.dynamicSmemBytes);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kern, &l.cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace

// Dynamic shared memory of one block: the ring for S positions in bf16
// (bf16 != 0) or fp32.
extern "C" int roi_cosine_smem_bytes(int bf16, int S) {
  return bf16 ? ring_stages<__nv_bfloat16>(S) *
                    Layout<__nv_bfloat16>::kStageBytes
              : ring_stages<float>(S) * Layout<float>::kStageBytes;
}

// Clusters of C blocks the device holds at once for S positions in bf16
// (bf16 != 0) or fp32 (cudaOccupancyMaxActiveClusters); a negative
// cudaError_t if the query fails.
extern "C" int roi_cosine_active_clusters(int bf16, int S, int C) {
  return bf16 ? active_clusters<__nv_bfloat16>(S, C)
              : active_clusters<float>(S, C);
}

// Plain C interface (loaded with ctypes). occ (N,S,P) and feat (N,S,D) are
// contiguous and share one dtype: bf16 if `bf16` is 1, fp32 if 0. protos
// (P,D), roi (N,P,D) and sim (N,P) are contiguous fp32. C = ceil(D/128),
// at most 8, blocks per sample (one cluster). aligned != 0 only if rows of
// D and P elements are 16-byte multiples and occ and feat start on 16-byte
// boundaries, and D is a multiple of 4 and protos starts on a 16-byte
// boundary. N, P, C >= 1; ceil(P/40) <= 65535. Launches on `stream`
// without synchronising; returns the cudaError_t of the attribute call or
// the launch.
extern "C" int roi_cosine_forward(const void* occ, const void* feat,
                                  int bf16, const float* protos, float* roi,
                                  float* sim, int aligned, int N, int S,
                                  int P, int D, int C, void* stream) {
  if (C < 1 || C > kMaxCluster || N < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using B16 = __nv_bfloat16;
    const Params<B16> p{static_cast<const B16*>(occ),
                        static_cast<const B16*>(feat), protos, roi, sim, S, P,
                        D};
    return aligned ? launch<B16, true>(p, N, C, st)
                   : launch<B16, false>(p, N, C, st);
  }
  const Params<float> p{static_cast<const float*>(occ),
                        static_cast<const float*>(feat), protos, roi, sim, S,
                        P, D};
  return aligned ? launch<float, true>(p, N, C, st)
                 : launch<float, false>(p, N, C, st);
}

extern "C" const char* roi_cosine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
