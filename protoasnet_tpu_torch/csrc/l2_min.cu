// Fused squared-L2 distance map + global min pool (ProtoPNet's 1x1
// prototype head), forward.
//
// Replaces the Pallas TPU kernel protoasnet_tpu/ops/pallas_l2.py
// (l2_min_pallas -> _forward/_kernel). Per sample n, position s and
// prototype p:
//
//   dist[n,s,p] = max(x2[n,s] - 2*sum_d x[n,s,d]*w[p,d] + p2[p], 0)
//   min_d[n,p]  = min_s dist[n,s,p]
//
// x2[n,s] = sum_d x[n,s,d]^2 and p2[p] = |w[p]|^2 are computed here too,
// so that a call is one launch. All arithmetic is fp32 FMAs on the CUDA
// cores, never TF32 (the JAX kernel runs at Precision.HIGHEST). The relu
// and the min propagate NaN as torch.relu and torch.amin do, and min_d is
// the minimum of exactly the values written to dist.
//
// What bounds it on an H100: at ProtoPNet's shape (N=128, S=7*7=49, P=30,
// D=512) the function must move ~13.7 MB (x 12.8 MB, dist 0.75 MB) and do
// 2*N*S*(P+1)*D ~ 0.2 GFLOP: ~4.1 us at 3.35 TB/s against ~3.0 us at
// 67 TFLOP/s fp32. Both are short: the kernel has to put the whole of x in
// flight at once, in one wave of blocks over every SM, and keep the FMAs
// fed from registers.
//
// Design:
//  - a sample's D is split across a thread-block cluster of C = ceil(D/dr)
//    blocks (at most 8), each over a range of dr d: 256 up to D = 2048,
//    past it ceil(D/8) rounded up to a multiple of 256 (a warp then stages
//    its d in several 32-wide stages): grid (C*N, ceil(P/32)). Every block
//    has d to take (the wrapper's plan). At ProtoPNet's shape that is 128
//    clusters of 2 blocks of 8 warps, two blocks an SM, all resident at
//    once (clusters of 4 or 8 blocks would leave some for a second wave:
//    the card places at most 124 of them). Each x element is read by one
//    block, once;
//  - a block takes up to 56 positions (a tile; S > 56 loops over tiles) x
//    32 prototypes. Each warp takes an eighth of the block's d range (32 d
//    at D=512) and stages it, x rows then w rows, with 16-byte cp.async
//    into its own shared memory: all of x is in flight at once (staged
//    in two or four commit groups, multiplied as each lands, it ran
//    slower). Each row's
//    16-byte pieces are stored XOR-swizzled by the row, so the product
//    reads are free of bank conflicts without padding. Rows that are not
//    16-byte multiples (D % 4 != 0) or views off a 16-byte boundary are
//    staged element by element. Positions past S and prototypes past P are
//    zeros;
//  - a lane owns 7 positions x 8 prototypes (s = rg + 8i, p = pq + 4j): per
//    4 d it reads 8 + 7 float4s (x rows as 4-lane broadcasts) for 224
//    FMAs, so the shared-memory reads keep pace with the FMAs. Each lane
//    also sums x^2 of one or two positions and w^2 of one prototype. At the
//    128 registers that two blocks an SM leave, the kernel spills 24 bytes;
//    the builds that do not spill ran slower (scripts/head_kernels_probe.py);
//  - the eight warps' partials are added in order into the block's
//    partials; position s0 + row belongs to block row / R of the cluster
//    (R = ceil(56 / C)), and each block stores its partial dot products,
//    x2 and p2 into the owner's receive area (distributed shared memory,
//    16-byte stores of contiguous rows: a load from another SM costs a
//    round trip); after a cluster barrier each block adds the C partials
//    in rank order, writes dist and keeps the minimum; the minima go to
//    the cluster's first block. Every block arrives at a relaxed cluster
//    barrier on entry and waits on it before its first store into another
//    block's memory, so that every block of the cluster has started.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroups = 8;                 // warps, an eighth of d each
constexpr int kThreads = kGroups * 32;
constexpr int kPT = 32;                    // prototypes per block
constexpr int kRows = 7;                   // positions per thread
constexpr int kCols = 8;                   // prototypes per thread
constexpr int kST = 8 * kRows;             // 56 positions per tile
constexpr int kDC = 32;                    // d per stage
constexpr int kXR = kST + kPT;             // rows of a stage: x, then w
constexpr int kStage = kXR * kDC;          // floats: a warp's stage
constexpr int kMaxCluster = 8;
// after the products (floats): warp g's partial tile (rows of kTP, then its
// x2 and p2) over its own stage; the block's partials after the eight
// stages; then the partials the block receives: dot at [sender][slot][p],
// x2 at [sender][slot], p2 at [sender][p]
constexpr int kTP = kPT + 8;  // rows of 40: acc's stores spread over banks
constexpr int kTile = kST * kTP;
constexpr int kPart = kTile + kST + kPT;
constexpr int kBlk = kGroups * kStage;
constexpr int kRecv = kBlk + kPart;
constexpr int kRecvX2 = kRecv + 64 * kPT;  // C * ceil(56 / C) <= 63 slots
constexpr int kRecvP2 = kRecvX2 + 64;
constexpr int kSmemBytes = (kRecvP2 + kMaxCluster * kPT) * 4;

static_assert(kPart <= kStage && kRecv % 4 == 0,
              "the partials fit a stage; 16-byte rows to receive");
static_assert(kST % 8 == 0, "x and w rows share the swizzle by row & 7");

struct Params {
  const float* x;
  const float* w;
  float* dist;
  float* min_d;
  int S, P, D;
  int dr;  // d range per block of the cluster (a multiple of 256)
};

// running minimum that propagates NaN, as torch.amin does
__device__ __forceinline__ float nan_min(float m, float v) {
  return (v < m || v != v) ? v : m;
}

// every block of the cluster has started once all have arrived: arrive on
// entry (no memory ordering), wait before the first remote access
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// where 16-byte piece c of stage row r lives: pieces XOR-swizzled by r & 7
__device__ __forceinline__ int at(int r, int c) {
  return r * kDC + ((c ^ (r & 7)) << 2);
}

// Stage d [d0, d0 + kDC) (d < dend) of the positions s0.. of the sample
// (x_n) and of the prototypes p0.. into `buf`, by the warp's lane.
template <bool kAligned>
__device__ __forceinline__ void stage(float* buf, const Params& q,
                                      const float* x_n, int s0, int p0,
                                      int d0, int dend, int lane) {
  if constexpr (kAligned) {
    constexpr int kPieces = kDC / 4;
#pragma unroll 2
    for (int e = lane; e < kXR * kPieces; e += 32) {
      const int r = e / kPieces, c = e % kPieces;
      const bool d_ok = d0 + 4 * c < dend;
      const bool ok = d_ok && (r < kST ? s0 + r < q.S : p0 + r - kST < q.P);
      const float* const src =
          r < kST ? x_n + static_cast<int64_t>(s0 + r) * q.D
                  : q.w + static_cast<int64_t>(p0 + r - kST) * q.D;
      cp_async16(buf + at(r, c), ok ? src + d0 + 4 * c : q.x, ok);
    }
  } else {
#pragma unroll 4
    for (int e = lane; e < kXR * kDC; e += 32) {
      const int r = e / kDC, col = e % kDC;
      const bool d_ok = d0 + col < dend;
      float v = 0.f;
      if (r < kST) {
        if (d_ok && s0 + r < q.S)
          v = x_n[static_cast<int64_t>(s0 + r) * q.D + d0 + col];
      } else if (d_ok && p0 + r - kST < q.P) {
        v = q.w[static_cast<int64_t>(p0 + r - kST) * q.D + d0 + col];
      }
      buf[at(r, col >> 2) + (col & 3)] = v;
    }
  }
}

// acc[i][j] += x[rg + 8i] . w[pq + 4j] over the kDC d of one stage: per 4
// d, 8 + 7 float4 reads (x as 4-lane broadcasts) for 224 FMAs
__device__ __forceinline__ void products(float (&acc)[kRows][kCols],
                                         const float* buf, int pq, int rg) {
#pragma unroll 1
  for (int c = 0; c < kDC / 4; ++c) {
    float4 wv[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      wv[j] = *reinterpret_cast<const float4*>(buf + at(kST + pq + 4 * j, c));
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 xv =
          *reinterpret_cast<const float4*>(buf + at(rg + 8 * i, c));
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[i][j] = fmaf(xv.x, wv[j].x, acc[i][j]);
        acc[i][j] = fmaf(xv.y, wv[j].y, acc[i][j]);
        acc[i][j] = fmaf(xv.z, wv[j].z, acc[i][j]);
        acc[i][j] = fmaf(xv.w, wv[j].w, acc[i][j]);
      }
    }
  }
}

// the sum of squares of stage row r
__device__ __forceinline__ float row_sq(const float* buf, int r) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kDC / 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(buf + at(r, c));
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, 2)
l2_min_kernel(const Params q, int C) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float mins[kThreads / kPT][kPT];
  // the first block: each block's minima of its positions
  __shared__ float recv_min[kMaxCluster][kPT];

  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());  // blockIdx.x % C
  const int n = blockIdx.x / C;
  const int p0 = blockIdx.y * kPT;
  const int tid = threadIdx.x;
  const int g = tid >> 5, lane = tid & 31;
  const int pq = lane & 3;   // prototypes pq + 4j
  const int rg = lane >> 2;  // positions rg + 8i
  const int dg = q.dr / kGroups;
  const int dbeg = rank * q.dr + g * dg;
  const int dend = min(q.D, dbeg + dg);
  const int nc = dend > dbeg ? (dend - dbeg + kDC - 1) / kDC : 0;
  const int R = (kST + C - 1) / C;  // positions per block of the cluster
  const float* const x_n = q.x + static_cast<int64_t>(n) * q.S * q.D;
  float* const dist_n = q.dist + static_cast<int64_t>(n) * q.S * q.P;
  float* const buf = smem + g * kStage;
  // the cluster's first block, threads < kPT: min over the tiles so far
  float run_min = __int_as_float(0x7f800000);  // +inf

  for (int s0 = 0; s0 < q.S; s0 += kST) {
    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    // this warp's d: x2 of positions lane and lane + 32, p2 of prototype
    // lane
    float x2a = 0.f, x2b = 0.f, p2 = 0.f;
    for (int c = 0; c < nc; ++c) {
      stage<kAligned>(buf, q, x_n, s0, p0, dbeg + c * kDC, dend, lane);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();  // every lane's pieces have landed
      products(acc, buf, pq, rg);
      x2a += row_sq(buf, lane);
      if (lane + 32 < kST) x2b += row_sq(buf, lane + 32);
      p2 += row_sq(buf, kST + lane);
      __syncwarp();  // the stage is free
    }

    // the warp's partials over its own stage, then the block's
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        buf[(rg + 8 * i) * kTP + pq + 4 * j] = acc[i][j];
    buf[kTile + lane] = x2a;
    if (lane + 32 < kST) buf[kTile + lane + 32] = x2b;
    buf[kTile + kST + lane] = p2;
    __syncthreads();
    float* const blk = smem + kBlk;
    for (int e = tid; e < kST * kPT; e += kThreads) {
      const int r = e / kPT, pc = e % kPT;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < kGroups; ++k) v += smem[k * kStage + r * kTP + pc];
      blk[r * kTP + pc] = v;
    }
    if (tid < kST + kPT) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < kGroups; ++k) v += smem[k * kStage + kTile + tid];
      blk[kTile + tid] = v;
    }
    __syncthreads();

    // position row goes to block row / R as its slot row % R (the owners
    // read their previous tile's partials before the last cluster barrier;
    // before the first tile's, every block of the cluster has started)
    if (s0 == 0) cluster_wait();
    for (int f = tid; f < kST * (kPT / 4); f += kThreads) {
      const int row = f / (kPT / 4), c4 = f % (kPT / 4);
      float* const dst = cluster.map_shared_rank(smem, row / R) + kRecv +
                         (rank * R + row % R) * kPT + 4 * c4;
      *reinterpret_cast<float4*>(dst) =
          *reinterpret_cast<const float4*>(blk + row * kTP + 4 * c4);
    }
    if (tid < kST)
      cluster.map_shared_rank(smem, tid / R)[kRecvX2 + rank * R + tid % R] =
          blk[kTile + tid];
    if (tid < kPT)
      for (int r = 0; r < C; ++r)
        cluster.map_shared_rank(smem, r)[kRecvP2 + rank * kPT + tid] =
            blk[kTile + kST + tid];
    cluster.sync();  // every block's partials are with their owners

    // this block's positions rank * R + slot, adding the C partials in
    // rank order; eight lanes of slots
    const int pl = tid % kPT, sl = tid / kPT;
    float pp = 0.f;
    for (int r = 0; r < C; ++r) pp += smem[kRecvP2 + r * kPT + pl];
    const int rows = min(kST, q.S - s0);
    float mn = __int_as_float(0x7f800000);
    for (int slot = sl; slot < R && rank * R + slot < rows;
         slot += kThreads / kPT) {
      float dot = 0.f, xx = 0.f;
      for (int r = 0; r < C; ++r) {
        dot += smem[kRecv + (r * R + slot) * kPT + pl];
        xx += smem[kRecvX2 + r * R + slot];
      }
      float v = (xx - 2.f * dot) + pp;
      v = v < 0.f ? 0.f : v;  // relu; NaN passes through
      if (p0 + pl < q.P) {
        dist_n[static_cast<int64_t>(s0 + rank * R + slot) * q.P + p0 + pl] =
            v;
        mn = nan_min(mn, v);
      }
    }
    mins[sl][pl] = mn;
    __syncthreads();
    if (tid < kPT) {
      float m = mins[0][tid];
#pragma unroll
      for (int k = 1; k < kThreads / kPT; ++k) m = nan_min(m, mins[k][tid]);
      cluster.map_shared_rank(&recv_min[0][0], 0)[rank * kPT + tid] = m;
    }
    cluster.sync();  // every block's minima are with the first block, and
                     // no block reads its received partials any more
    if (rank == 0 && tid < kPT)
      for (int r = 0; r < C; ++r) run_min = nan_min(run_min, recv_min[r][tid]);
  }
  if (rank == 0 && tid < kPT && p0 + tid < q.P)
    q.min_d[static_cast<int64_t>(n) * q.P + p0 + tid] = run_min;
}

// Opt in to the dynamic shared memory, and ask for the largest
// shared-memory carveout: left to the driver, an SM may keep less shared
// memory than the blocks that fit it by the table need.
template <typename Kernel>
cudaError_t set_attributes(Kernel kern) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The launch: `clusters` clusters of C blocks along grid.x, `groups` rows
// of them (one a 32 prototypes) along grid.y.
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  void init(int C, unsigned clusters, unsigned groups, cudaStream_t st) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(static_cast<unsigned>(C) * clusters, groups, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <bool kAligned>
int launch(const Params& q, int N, int C, cudaStream_t st) {
  Launch l;
  l.init(C, N, (q.P + kPT - 1) / kPT, st);
  auto kern = l2_min_kernel<kAligned>;
  cudaError_t e = set_attributes(kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&l.cfg, kern, q, C);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of one block.
extern "C" int l2_min_smem_bytes() { return kSmemBytes; }

// Clusters of C blocks the device holds at once
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t if the query
// fails.
extern "C" int l2_min_active_clusters(int C) {
  Launch l;
  l.init(C, 1, 1, nullptr);
  auto kern = l2_min_kernel<true>;
  cudaError_t e = set_attributes(kern);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kern, &l.cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// Plain C interface (loaded with ctypes). x (N,S,D), w (P,D), dist (N,S,P)
// and min_d (N,P) are contiguous fp32; N, P, S >= 1. The C blocks of a
// sample (one cluster, 1 <= C <= 8) take d ranges of dr (a multiple of
// 256) each, with C * dr >= D. aligned != 0 only if D is a multiple of 4 and x
// and w start on 16-byte boundaries. ceil(P/32) <= 65535. Launches on
// `stream` without synchronising; returns the cudaError_t of the attribute
// call or the launch.
extern "C" int l2_min_forward(const float* x, const float* w, float* dist,
                              float* min_d, int aligned, int N, int S, int P,
                              int D, int C, int dr, void* stream) {
  if (C < 1 || C > kMaxCluster || N < 1 || S < 1 || P < 1 || dr < 1 ||
      dr % (kGroups * kDC) != 0 || static_cast<int64_t>(C) * dr < D)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params q{x, w, dist, min_d, S, P, D, dr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return aligned ? launch<true>(q, N, C, st) : launch<false>(q, N, C, st);
}

extern "C" const char* l2_min_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
