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
// x2[n,s] = sum_d x[n,s,d]^2 is computed here; p2[p] = |w[p]|^2 by the
// caller, as the Pallas wrapper does. All arithmetic is fp32 FMAs on the
// CUDA cores, never TF32 (the JAX kernel runs at Precision.HIGHEST). The
// relu and the min propagate NaN as torch.relu and torch.amin do, and
// min_d is the minimum of exactly the values written to dist.
//
// What bounds it on an H100: at ProtoPNet's shape (N=128, S=7*7=49, P=30,
// D=512) the function must move ~13.7 MB (x 12.8 MB, dist 0.75 MB) and do
// 2*N*S*(P+1)*D ~ 0.2 GFLOP: ~4.1 us at 3.35 TB/s against ~3.0 us at
// 67 TFLOP/s fp32, so it is bound by bytes, near the ridge. At that size
// the launch itself takes about as long as the work.
//
// Design (simple first, no TMA/cp.async/tensor cores yet):
//  - one block per (sample, tile of 32 prototypes): grid (N, ceil(P/32)),
//    so the flagship shape gives 128 blocks, about one per SM;
//  - 256 threads = 32 lanes over p x 8 warps over s. A thread owns one
//    prototype and 8 rows (s = warp + 8*i) of a 64-row s tile, so its 8
//    partial dot products stay in registers;
//  - per 64-wide d chunk, the tile's x rows and w rows are staged in
//    shared memory; x is read back as float4 broadcasts (every lane of a
//    warp reads the same row), w is stored transposed with a 33-float
//    pitch so that both its store and its per-lane read are free of bank
//    conflicts;
//  - x2 falls out of the staging: the thread that loads x[s,d] adds its
//    square, and a butterfly shuffle sums the 32 lanes (every lane gets the
//    same bits, since a+b == b+a);
//  - S > 64 loops over s tiles inside the block with the running min in a
//    register; the 8 warps' minima are combined through shared memory.
//    Any N, S, P and D is handled by masking: staging fills zeros outside
//    the arrays and nothing is written outside them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPTile = 32;                 // prototypes per block: one lane each
constexpr int kWarps = kThreads / kPTile;  // 8
constexpr int kRows = 8;                   // s rows per thread
constexpr int kSTile = kWarps * kRows;     // 64
constexpr int kDChunk = 64;
constexpr int kHalves = kDChunk / kPTile;  // x columns each lane stages

static_assert(kDChunk % 4 == 0, "float4 reads of the x rows");

// running minimum that propagates NaN, as torch.amin does
__device__ __forceinline__ float nan_min(float m, float v) {
  return (v < m || v != v) ? v : m;
}

__global__ void __launch_bounds__(kThreads)
l2_min_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ p2, float* __restrict__ dist,
              float* __restrict__ min_d, int S, int P, int D) {
  __shared__ __align__(16) float xs[kSTile][kDChunk];
  __shared__ float ws[kDChunk][kPTile + 1];
  __shared__ float mins[kWarps][kPTile];

  const int n = blockIdx.x;
  const int p0 = blockIdx.y * kPTile;
  const int tid = threadIdx.x;
  const int lane = tid % kPTile;
  const int warp = tid / kPTile;
  const int p = p0 + lane;
  const bool p_ok = p < P;
  const float p2v = p_ok ? p2[p] : 0.f;
  const float* x_n = x + static_cast<int64_t>(n) * S * D;
  float* dist_n = dist + static_cast<int64_t>(n) * S * P;
  float run_min = __int_as_float(0x7f800000);  // +inf

  for (int s0 = 0; s0 < S; s0 += kSTile) {
    float acc[kRows];
    float x2[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      acc[i] = 0.f;
      x2[i] = 0.f;
    }

    for (int d0 = 0; d0 < D; d0 += kDChunk) {
      __syncthreads();  // the previous chunk has been consumed
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = warp + kWarps * i;
        const int s = s0 + r;
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          const int c = lane + kPTile * h;
          const float v = (s < S && d0 + c < D)
                              ? x_n[static_cast<int64_t>(s) * D + d0 + c]
                              : 0.f;
          xs[r][c] = v;
          x2[i] = fmaf(v, v, x2[i]);
        }
      }
      for (int i = tid; i < kPTile * kDChunk; i += kThreads) {
        const int r = i / kDChunk;  // prototype within the tile
        const int c = i % kDChunk;  // d within the chunk (coalesced)
        ws[c][r] = (p0 + r < P && d0 + c < D)
                       ? w[static_cast<int64_t>(p0 + r) * D + d0 + c]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kDChunk; k += 4) {
        const float w0 = ws[k][lane];
        const float w1 = ws[k + 1][lane];
        const float w2 = ws[k + 2][lane];
        const float w3 = ws[k + 3][lane];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float4 xv =
              *reinterpret_cast<const float4*>(&xs[warp + kWarps * i][k]);
          acc[i] = fmaf(xv.x, w0, acc[i]);
          acc[i] = fmaf(xv.y, w1, acc[i]);
          acc[i] = fmaf(xv.z, w2, acc[i]);
          acc[i] = fmaf(xv.w, w3, acc[i]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int off = kPTile / 2; off > 0; off >>= 1) {
        x2[i] += __shfl_xor_sync(0xffffffffu, x2[i], off);
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int s = s0 + warp + kWarps * i;
      if (p_ok && s < S) {
        float v = (x2[i] - 2.f * acc[i]) + p2v;
        v = v < 0.f ? 0.f : v;  // relu; NaN passes through
        dist_n[static_cast<int64_t>(s) * P + p] = v;
        run_min = nan_min(run_min, v);
      }
    }
  }

  mins[warp][lane] = run_min;
  __syncthreads();
  if (warp == 0 && p_ok) {
    float m = mins[0][lane];
#pragma unroll
    for (int g = 1; g < kWarps; ++g) m = nan_min(m, mins[g][lane]);
    min_d[static_cast<int64_t>(n) * P + p] = m;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). x (N,S,D), w (P,D), p2 (P,),
// dist (N,S,P) and min_d (N,P) are contiguous fp32; N, P >= 1, S >= 1.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t.
extern "C" int l2_min_forward(const float* x, const float* w,
                              const float* p2, float* dist, float* min_d,
                              int N, int S, int P, int D, void* stream) {
  const dim3 grid(N, (P + kPTile - 1) / kPTile);
  l2_min_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, p2, dist, min_d, S, P, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* l2_min_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
