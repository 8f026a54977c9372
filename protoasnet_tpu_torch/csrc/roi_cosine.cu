// Fused occurrence-weighted ROI pooling + prototype cosine head, forward.
//
// Replaces the Pallas TPU kernel protoasnet_tpu/ops/pallas_roi.py
// (roi_cosine_pallas -> _forward/_kernel). Per sample n and prototype p:
//
//   roi[n,p,:] = sum_s occ[n,s,p] * feat[n,s,:]                 (fp32 sums)
//   sim[n,p]   = (dot(roi,proto[p]) / (max(|roi|,eps) * pnorm[p]) + 1) / 2
//
// pnorm[p] = max(|proto[p]|, eps) is computed once by the caller, as the
// Pallas wrapper does. occ and feat are both fp32 or both bf16; all
// arithmetic is fp32.
//
// What bounds it on an H100: at the flagship head shape (N=128, S=1568,
// P=40, D=256) the function must move ~243 MB with fp32 inputs and ~124 MB
// with bf16 inputs (feat dominates), and do 2*N*S*P*D = 4.1 GFLOP. With
// fp32 inputs the product has to stay fp32 (67 TFLOP/s outside the tensor
// cores): ~61 us of operations against ~73 us of bytes, near the ridge.
// With bf16 inputs a bf16 tensor-core product with fp32 accumulation is
// exact (989 TFLOP/s, ~4 us), so the bound is the bytes, ~37 us; this
// kernel's CUDA-core FMAs do not reach it.
//
// Design (simple first, no TMA/wgmma yet):
//  - one block per (sample, tile of kPTile prototypes): grid (ceil(P/8), N);
//    the P/8 blocks of a sample are adjacent in launch order, so a sample's
//    feat rows are read from device memory once and from L2 after that;
//  - 256 threads = 64 lanes over d x 4 groups over s. A thread keeps a
//    kPTile x 4 tile of roi partials in registers (d = lane + 64*k), so each
//    feat element it loads (coalesced over d) feeds kPTile FMAs;
//  - the tile's occ[n, s-chunk, p-tile] values are staged in shared memory
//    and read as warp-wide broadcasts;
//  - the 4 s-group partials are summed through shared memory, the block
//    writes roi and reduces <roi,proto> and |roi|^2 per prototype (warp
//    shuffles, then across warps) for the sim epilogue. D > 256 loops over
//    d tiles inside the block; any S, P and D is handled by masking.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDLanes = 64;
constexpr int kSGroups = kThreads / kDLanes;
constexpr int kDPerThread = 4;
constexpr int kDTile = kDLanes * kDPerThread;  // == kThreads
constexpr int kPTile = 8;
constexpr int kSChunk = 64;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-8f;

static_assert(kDTile == kThreads, "one epilogue column per thread");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_cosine_kernel(const T* __restrict__ occ, const T* __restrict__ feat,
                  const float* __restrict__ protos,
                  const float* __restrict__ pnorm, float* __restrict__ roi,
                  float* __restrict__ sim, int S, int P, int D) {
  __shared__ float occ_s[kSChunk][kPTile];
  __shared__ float red[kSGroups][kPTile][kDTile];
  __shared__ float wsum[kWarps][2 * kPTile];

  const int n = blockIdx.y;
  const int p0 = blockIdx.x * kPTile;
  const int np = min(kPTile, P - p0);
  const int tid = threadIdx.x;
  const int lane_d = tid % kDLanes;
  const int sg = tid / kDLanes;
  const T* occ_n = occ + static_cast<int64_t>(n) * S * P;
  const T* feat_n = feat + static_cast<int64_t>(n) * S * D;

  float dotp[kPTile];
  float nrmp[kPTile];
#pragma unroll
  for (int p = 0; p < kPTile; ++p) {
    dotp[p] = 0.f;
    nrmp[p] = 0.f;
  }

  for (int d0 = 0; d0 < D; d0 += kDTile) {
    float acc[kPTile][kDPerThread];
#pragma unroll
    for (int p = 0; p < kPTile; ++p) {
#pragma unroll
      for (int k = 0; k < kDPerThread; ++k) acc[p][k] = 0.f;
    }

    for (int s0 = 0; s0 < S; s0 += kSChunk) {
      const int ns = min(kSChunk, S - s0);
      __syncthreads();  // the previous chunk has been consumed
      for (int i = tid; i < kSChunk * kPTile; i += kThreads) {
        const int r = i / kPTile;
        const int c = i % kPTile;
        occ_s[r][c] =
            (r < ns && c < np)
                ? to_f32(occ_n[static_cast<int64_t>(s0 + r) * P + p0 + c])
                : 0.f;
      }
      __syncthreads();
      for (int r = sg; r < ns; r += kSGroups) {
        const T* row = feat_n + static_cast<int64_t>(s0 + r) * D + d0;
        float f[kDPerThread];
#pragma unroll
        for (int k = 0; k < kDPerThread; ++k) {
          const int d = lane_d + k * kDLanes;
          f[k] = (d0 + d < D) ? to_f32(row[d]) : 0.f;
        }
#pragma unroll
        for (int p = 0; p < kPTile; ++p) {
          const float o = occ_s[r][p];
#pragma unroll
          for (int k = 0; k < kDPerThread; ++k) {
            acc[p][k] = fmaf(o, f[k], acc[p][k]);
          }
        }
      }
    }

#pragma unroll
    for (int p = 0; p < kPTile; ++p) {
#pragma unroll
      for (int k = 0; k < kDPerThread; ++k) {
        red[sg][p][lane_d + k * kDLanes] = acc[p][k];
      }
    }
    __syncthreads();
    const int d = d0 + tid;
    if (d < D) {
#pragma unroll
      for (int p = 0; p < kPTile; ++p) {
        if (p < np) {
          float r = 0.f;
#pragma unroll
          for (int g = 0; g < kSGroups; ++g) r += red[g][p][tid];
          roi[(static_cast<int64_t>(n) * P + p0 + p) * D + d] = r;
          const float pv = protos[static_cast<int64_t>(p0 + p) * D + d];
          dotp[p] = fmaf(r, pv, dotp[p]);
          nrmp[p] = fmaf(r, r, nrmp[p]);
        }
      }
    }
    __syncthreads();  // red is rewritten by the next d tile
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
#pragma unroll
  for (int p = 0; p < kPTile; ++p) {
    float a = dotp[p];
    float b = nrmp[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      wsum[warp][p] = a;
      wsum[warp][kPTile + p] = b;
    }
  }
  __syncthreads();
  if (tid < np) {
    float dot = 0.f;
    float nrm = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      dot += wsum[w][tid];
      nrm += wsum[w][kPTile + tid];
    }
    const float rnorm = fmaxf(sqrtf(nrm), kEps);
    const float cosv = dot / (rnorm * pnorm[p0 + tid]);
    sim[static_cast<int64_t>(n) * P + p0 + tid] = (cosv + 1.f) * 0.5f;
  }
}

template <typename T>
void launch(const void* occ, const void* feat, const float* protos,
            const float* pnorm, float* roi, float* sim, int N, int S, int P,
            int D, cudaStream_t stream) {
  const dim3 grid((P + kPTile - 1) / kPTile, N);
  roi_cosine_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(occ), static_cast<const T*>(feat), protos, pnorm,
      roi, sim, S, P, D);
}

}  // namespace

// Plain C interface (loaded with ctypes). occ (N,S,P) and feat (N,S,D) are
// contiguous and share one dtype: bf16 if `bf16` is 1, fp32 if 0. protos
// (P,D), pnorm (P,), roi (N,P,D) and sim (N,P) are contiguous fp32.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t.
extern "C" int roi_cosine_forward(const void* occ, const void* feat,
                                  int bf16, const float* protos,
                                  const float* pnorm, float* roi, float* sim,
                                  int N, int S, int P, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(occ, feat, protos, pnorm, roi, sim, N, S, P, D, st);
  } else {
    launch<float>(occ, feat, protos, pnorm, roi, sim, N, S, P, D, st);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* roi_cosine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
