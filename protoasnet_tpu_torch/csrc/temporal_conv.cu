// (3,1,1) temporal convolution, channels-last, SAME zero padding in T,
// stride 1 (the temporal half of R(2+1)D's Conv2Plus1D), forward.
//
// Replaces the Pallas TPU kernels experiments/pallas_temporal.py
// (temporal_conv_pallas, temporal_conv_pallas_v2, temporal_conv_pallas_v3:
// three tilings of one function). Per sample b, frame t and position s:
//
//   y[b,t,s,o] = sum_{dt=0..2} sum_c x[b,t+dt-1,s,c] * k[dt,c,o]
//
// with x[b,-1] = x[b,T] = 0. x is fp32 or bf16, k fp32 (the wrapper casts
// it; a bf16 tap is exact in fp32), y in x's dtype. All sums are fp32 FMAs
// on the CUDA cores: fp32 inputs are never rounded to TF32, bf16 products
// are exact in fp32, and y is rounded once (round to nearest even).
//
// What bounds it on an H100: at the flagship's layer1 shape (B=8, T=32,
// S=56*56, C=144, O=64) the function moves x and y once, 334 MB in bf16
// (0.10 ms at 3.35 TB/s) against 43.5 GFLOP of taps inside the clip
// (2*B*S*C*O*(3T-2); 0.044 ms at the bf16 tensor-core rate), so bf16 is
// bound by bytes; in fp32 the 43.5 GFLOP at 67 TFLOP/s (0.65 ms) bound it
// by operations. This kernel runs on the
// CUDA cores and reads each x frame three times (once per tap, mostly from
// L2), so it sits well above both bounds; tensor cores (mma/wgmma) and a
// rolling window of frames in shared memory are later work.
//
// Design (simple first):
//  - one block per (tile of 64 positions, tile of 64 outputs, sample):
//    grid (ceil(S/64), ceil(O/64), B); the block walks t = 0..T-1;
//  - 256 threads as 16 x 16; a thread owns 4 positions (ty + 16*i) x 4
//    outputs (tx + 16*j) of fp32 sums in registers for the current t;
//  - per tap and per 32-channel chunk, the 64 x rows of frame t+dt-1 and
//    the (32 x 64) slice of k[dt] are staged in shared memory as fp32; x
//    rows with a 33-float pitch (conflict-free stores, broadcast reads);
//  - a tap whose frame lies outside [0, T) is skipped (the zero padding);
//    the condition is the same for the whole block, so no thread diverges
//    around the barriers;
//  - any S, C, O and T >= 1 is handled by masking: staging fills zeros
//    outside the arrays and nothing is written outside them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;               // threads per side of the 16 x 16 grid
constexpr int kR = 4;                   // register tile: 4 positions x 4 outputs
constexpr int kSTile = kSide * kR;      // 64 positions per block
constexpr int kOTile = kSide * kR;      // 64 outputs per block
constexpr int kCChunk = 32;             // input channels staged per step

static_assert(kSide * kSide == kThreads, "16 x 16 threads");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
temporal_conv_kernel(const In* __restrict__ x, const float* __restrict__ k,
                     In* __restrict__ y, int T, int S, int C, int O) {
  __shared__ float xs[kSTile][kCChunk + 1];
  __shared__ float ks[kCChunk][kOTile];

  const int s0 = blockIdx.x * kSTile;
  const int o0 = blockIdx.y * kOTile;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;

  for (int t = 0; t < T; ++t) {
    float acc[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[i][j] = 0.f;
    }
    for (int dt = 0; dt < 3; ++dt) {
      const int tin = t + dt - 1;
      if (tin < 0 || tin >= T) continue;  // zero padding in T
      const In* x_t = x + (static_cast<int64_t>(b) * T + tin) * S * C;
      const float* k_dt = k + static_cast<int64_t>(dt) * C * O;
      for (int c0 = 0; c0 < C; c0 += kCChunk) {
        __syncthreads();  // the previous chunk has been consumed
        for (int e = tid; e < kSTile * kCChunk; e += kThreads) {
          const int r = e / kCChunk;  // position within the tile
          const int c = e % kCChunk;  // channel within the chunk (coalesced)
          const int s = s0 + r;
          xs[r][c] = (s < S && c0 + c < C)
                         ? to_f(x_t[static_cast<int64_t>(s) * C + c0 + c])
                         : 0.f;
        }
        for (int e = tid; e < kCChunk * kOTile; e += kThreads) {
          const int c = e / kOTile;
          const int o = e % kOTile;  // coalesced
          ks[c][o] = (c0 + c < C && o0 + o < O)
                         ? k_dt[static_cast<int64_t>(c0 + c) * O + o0 + o]
                         : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int c = 0; c < kCChunk; ++c) {
          float a[kR], w[kR];
#pragma unroll
          for (int i = 0; i < kR; ++i) a[i] = xs[ty + kSide * i][c];
#pragma unroll
          for (int j = 0; j < kR; ++j) w[j] = ks[c][tx + kSide * j];
#pragma unroll
          for (int i = 0; i < kR; ++i) {
#pragma unroll
            for (int j = 0; j < kR; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
          }
        }
      }
    }
    In* y_t = y + (static_cast<int64_t>(b) * T + t) * S * O;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int s = s0 + ty + kSide * i;
      if (s >= S) continue;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int o = o0 + tx + kSide * j;
        if (o < O) put(&y_t[static_cast<int64_t>(s) * O + o], acc[i][j]);
      }
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). x (B,T,S,C) contiguous, fp32 or
// (x_bf16 != 0) bf16; k (3,C,O) contiguous fp32; y (B,T,S,O) contiguous in
// x's dtype. B, T, S, O >= 1, C >= 0, B <= 65535, ceil(O/64) <= 65535.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t.
extern "C" int temporal_conv_forward(const void* x, int x_bf16,
                                     const float* k, void* y, int B, int T,
                                     int S, int C, int O, void* stream) {
  const dim3 grid((S + kSTile - 1) / kSTile, (O + kOTile - 1) / kOTile, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    temporal_conv_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), k,
        static_cast<__nv_bfloat16*>(y), T, S, C, O);
  } else {
    temporal_conv_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), k, static_cast<float*>(y), T, S, C, O);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* temporal_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
