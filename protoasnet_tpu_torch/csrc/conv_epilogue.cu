// The served R(2+1)D trunk's conv epilogue: y = relu(x + b[c] (+ r)), in
// place on a channels-last conv output.
//
// Replaces no TPU kernel: the JAX package leaves each eval BatchNorm, the
// residual add and the ReLU to XLA, which fuses them into the convolution.
// It was added for the served copy of the trunk (models/aligned.py), where
// each eval BatchNorm is folded into the conv before it (the scale into
// the conv's weight, the shift into a per-channel fp32 bias b) and what is
// left after each conv is this one elementwise pass: the shift, the
// block's residual r where it has one (the downsample conv's shift folded
// into b too) and the ReLU. Without it the same work took three or four
// passes over every conv output (BatchNorm, add, ReLU).
//
// What bounds it on an H100: bytes. A call reads x (and r) and writes y
// once, ~2 FLOP an element, far below the card's ~295 FLOP a byte; at
// batch 128 a call moves 0.2-11 GB of bf16. So the design does nothing
// but stream:
//  - x is (rows, C) with C innermost and a multiple of 8, so each thread
//    takes 8 elements of one row (one 16-byte vector in bf16, two in fp32)
//    whose channels are 8g .. 8g+7, g = vector index mod C/8; the bias is
//    read as two float4 of a C-float table that stays in L1;
//  - a grid-stride loop over the vectors with a few vectors a thread in
//    flight (4 in bf16, 2 in fp32: 64 or 32 bytes of x and as many of r a
//    thread), the vectors' channel groups advanced by the stride mod C/8,
//    no division in the loop;
//  - the sum in fp32 (x + b, then + r, as the plain route adds), the ReLU
//    keeping NaN, one rounding to the output type (bf16 round to nearest
//    even, as torch's cast).
// It launches on the caller's stream, does not synchronise and allocates
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;

// 8 elements of one row: one uint4 of bf16 or two of fp32
template <typename T>
struct Vec8 {
  uint4 u[sizeof(T) / 2];
};

__device__ __forceinline__ void to_float(const Vec8<__nv_bfloat16>& v,
                                         float (&f)[8]) {
  const uint32_t w[4] = {v.u[0].x, v.u[0].y, v.u[0].z, v.u[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void to_float(const Vec8<float>& v,
                                         float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(v.u[i].x);
    f[4 * i + 1] = __uint_as_float(v.u[i].y);
    f[4 * i + 2] = __uint_as_float(v.u[i].z);
    f[4 * i + 3] = __uint_as_float(v.u[i].w);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void from_float(const float (&f)[8],
                                           Vec8<__nv_bfloat16>& v) {
  v.u[0] = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                      pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

__device__ __forceinline__ void from_float(const float (&f)[8],
                                           Vec8<float>& v) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    v.u[i] = make_uint4(__float_as_uint(f[4 * i]),
                        __float_as_uint(f[4 * i + 1]),
                        __float_as_uint(f[4 * i + 2]),
                        __float_as_uint(f[4 * i + 3]));
}

template <typename T>
__device__ __forceinline__ Vec8<T> load(const T* p, int64_t vec) {
  Vec8<T> v;
  const uint4* q = reinterpret_cast<const uint4*>(p) + vec * (sizeof(T) / 2);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 2); ++i) v.u[i] = q[i];
  return v;
}

template <typename T>
__device__ __forceinline__ void store(T* p, int64_t vec, const Vec8<T>& v) {
  uint4* q = reinterpret_cast<uint4*>(p) + vec * (sizeof(T) / 2);
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 2); ++i) q[i] = v.u[i];
}

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    conv_epilogue_kernel(T* __restrict__ x, const T* __restrict__ r,
                         const float* __restrict__ bias, int64_t nvec,
                         int groups) {
  constexpr int kUnroll = sizeof(T) == 2 ? 4 : 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int gstep = static_cast<int>(stride % groups);
  int64_t v = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int g = static_cast<int>(v % groups);
  for (; v < nvec; v += kUnroll * stride) {
    Vec8<T> xv[kUnroll], rv[kUnroll];
    int gs[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t w = v + k * stride;
      gs[k] = g;
      g += gstep;
      if (g >= groups) g -= groups;
      if (w < nvec) {
        xv[k] = load(x, w);
        if (kResidual) rv[k] = load(r, w);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t w = v + k * stride;
      if (w >= nvec) break;
      const float4* b = reinterpret_cast<const float4*>(bias) + 2 * gs[k];
      const float4 b0 = __ldg(b), b1 = __ldg(b + 1);
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float f[8], res[8];
      to_float(xv[k], f);
      if (kResidual) to_float(rv[k], res);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float y = f[i] + bb[i];
        if (kResidual) y += res[i];
        f[i] = y < 0.f ? 0.f : y;  // NaN stays NaN, as torch.relu
      }
      Vec8<T> out;
      from_float(f, out);
      store(x, w, out);
    }
  }
}

template <typename T>
cudaError_t launch(void* x, const void* r, const float* bias, int64_t n,
                   int C, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  const int64_t nvec = n / 8;
  constexpr int kUnroll = sizeof(T) == 2 ? 4 : 2;
  const int64_t want = (nvec + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  T* xp = static_cast<T*>(x);
  if (r)
    conv_epilogue_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        xp, static_cast<const T*>(r), bias, nvec, C / 8);
  else
    conv_epilogue_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        xp, nullptr, bias, nvec, C / 8);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). x (n elements, rows of C with C
// innermost) is rewritten in place as relu(x + bias[c] + r), r (the same
// layout and dtype as x) optional (NULL); bf16 if `bf16` is 1, fp32 if 0;
// bias C fp32. x, r and bias 16-byte aligned, C a multiple of 8, n a
// multiple of C. The grid is a few blocks an SM of the current device.
// Launches on `stream` without synchronising; returns the cudaError_t of
// the launch.
extern "C" int conv_epilogue_forward(void* x, const void* r,
                                     const float* bias, int bf16, int64_t n,
                                     int C, void* stream) {
  if (C < 8 || C % 8 || n < 1 || n % C ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
       reinterpret_cast<uintptr_t>(bias)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16>(x, r, bias, n, C, st)
           : launch<float>(x, r, bias, n, C, st));
}

extern "C" const char* conv_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
