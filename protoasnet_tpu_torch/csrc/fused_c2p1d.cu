// Fused eval-mode Conv2Plus1D block, stride 1, channels-last, forward:
// spatial (1,3,3) conv + folded BatchNorm affine + ReLU + temporal (3,1,1)
// conv, with the mid activation kept in shared memory.
//
// Replaces the Pallas TPU kernel experiments/pallas_fused_c2p1d.py
// (fused_c2p1d -> _kernel). Per sample b, frame t and pixel (h,w):
//
//   mid[t,h,w,m] = relu(sum_{dh,dw,c} x[t,h+dh-1,w+dw-1,c]*ks[dh,dw,c,m]
//                       * scale[m] + shift[m])      rounded to x's dtype
//   out[t,h,w,o] = sum_{dt,m} mid[t+dt-1,h,w,m] * kt[dt,m,o]
//
// with x = 0 outside the image (SAME padding of the spatial conv) and
// mid[-1] = mid[T] = 0 (the temporal conv pads the mid with zeros, not
// with relu(shift)). x is fp32 or bf16, ks/scale/shift/kt fp32 (the wrapper
// casts the taps; a bf16 tap is exact in fp32), out in x's dtype. All sums
// are fp32 FMAs on the CUDA cores (never TF32); the affine is a rounded
// multiply then a rounded add, as the plain version computes it, and mid
// and out are rounded to x's dtype exactly where the plain version rounds.
//
// What bounds it on an H100: at the flagship's layer1 block (B=8, T=32,
// 56x56, C=64 -> Cm=144 -> Co=64) the function moves x and out once
// (206 MB in bf16, 0.06 ms at 3.35 TB/s) against 173.5 GFLOP of taps
// inside the clip (0.18 ms at the bf16 tensor-core rate, 2.59 ms at 67
// TFLOP/s for fp32): bound by operations in both dtypes. The point of the fusion is that mid (2.3x the
// bytes of x at layer1) never goes to device memory. This kernel runs on
// the CUDA cores, so it sits far above the bf16 bound; tensor cores
// (mma/wgmma) are later work.
//
// Design (simple first):
//  - one block per (spatial tile of NP positions, sample): the tile is
//    TH rows x TW columns with TW = min(W, NP), TH = min(H, NP / TW);
//    grid (tiles, B). The block owns all of Cm and walks t = 0..T-1;
//  - a ring of three mid frames (NP x Cm in x's dtype) lives in shared
//    memory. Each mid frame is computed once: at step t the block computes
//    mid[t+1] into slot (t+1)%3, then out[t] from slots (t-1)%3, t%3 and
//    (t+1)%3 for every Co tile, skipping the frames outside [0, T);
//  - spatial GEMM (NP x 9C) x (9C x Cm) in passes of MB mid channels: per
//    chunk of CK input channels the x tile with its 1-pixel halo
//    ((TH+2) x (TW+2) x CK, zeros outside the image) and the 9 taps'
//    (CK x MB) weights are staged in shared memory as fp32;
//  - temporal GEMM (NP x 3Cm) x (3Cm x Co) in passes of MB outputs, the kt
//    slice staged per chunk of MK mid channels, mid read from the ring;
//  - 256 threads as 16 x 16; a thread owns RP positions (ty + 16*i) x RM
//    channels (tx + 16*j) of fp32 sums (RP*RM = 16) in registers;
//  - NP (64, 32 or 16; RP = 4, 2, 1 and MB = 64, 128, 256) is the largest
//    for which the ring, the weight stage (36 KB) and the halo fit in the
//    227 KB a block may opt into: at Cm=144 a 64-position ring is 55 KB in
//    bf16 and 111 KB in fp32; at Cm=576 it takes 32 positions (111 KB) in
//    bf16 and 16 (111 KB) in fp32;
//  - positions outside the image or the tile are computed on zeros and
//    never stored (each position's temporal conv reads only its own mid).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;         // threads per side of the 16 x 16 grid
constexpr int kWFloats = 9216;    // weight stage: 36 KB of fp32
constexpr int kMaxSmem = 232448;  // the 227 KB a block can opt into

static_assert(kSide * kSide == kThreads, "16 x 16 threads");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename In>
__device__ __forceinline__ In from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int RP, int RM>
struct Tile {
  static constexpr int NP = kSide * RP;            // positions per block
  static constexpr int MB = kSide * RM;            // channels per pass
  static constexpr int CK = kWFloats / (9 * MB);   // x channels per stage
  static constexpr int MK = kWFloats / MB;         // mid channels per stage
  static_assert(9 * MB * CK == kWFloats, "spatial weight stage");
  static constexpr int kHalo = 3 * (NP + 2) * CK;  // (TH+2)(TW+2) <= 3(NP+2)
};

template <typename In, int RP, int RM>
size_t smem_bytes(int Cm) {
  using Tl = Tile<RP, RM>;
  return sizeof(float) * (kWFloats + Tl::kHalo)
         + sizeof(In) * 3 * static_cast<size_t>(Tl::NP) * Cm;
}

template <typename In, int RP, int RM>
__global__ void __launch_bounds__(kThreads)
fused_c2p1d_kernel(const In* __restrict__ x, const float* __restrict__ ks,
                   const float* __restrict__ scale,
                   const float* __restrict__ shift,
                   const float* __restrict__ kt, In* __restrict__ out, int T,
                   int H, int W, int C, int Cm, int Co, int TH, int TW,
                   int n_tw) {
  using Tl = Tile<RP, RM>;
  constexpr int NP = Tl::NP, MB = Tl::MB, CK = Tl::CK, MK = Tl::MK;
  extern __shared__ float4 smem4[];
  float* wbuf = reinterpret_cast<float*>(smem4);  // weight stage
  float* xh = wbuf + kWFloats;                    // x tile + halo
  In* ring = reinterpret_cast<In*>(xh + Tl::kHalo);  // 3 x NP x Cm

  const int b = blockIdx.y;
  const int h0 = (blockIdx.x / n_tw) * TH;
  const int w0 = (blockIdx.x % n_tw) * TW;
  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int halo_w = TW + 2;
  const int halo_n = (TH + 2) * halo_w;
  const int64_t HW = static_cast<int64_t>(H) * W;

  int hoff[RP];      // the position's top-left halo pixel in xh
  bool valid[RP];    // inside the tile and the image: stored
  int64_t gpos[RP];  // h*W + w
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int p = ty + kSide * i;
    const int ph = p / TW, pw = p % TW;
    const bool in_tile = ph < TH;
    valid[i] = in_tile && h0 + ph < H && w0 + pw < W;
    hoff[i] = in_tile ? ph * halo_w + pw : 0;
    gpos[i] = static_cast<int64_t>(h0 + ph) * W + (w0 + pw);
  }

  // mid[tf] -> ring slot `slot`: spatial conv, affine, ReLU, rounding
  auto compute_mid = [&](int tf, int slot) {
    const In* x_t = x + (static_cast<int64_t>(b) * T + tf) * HW * C;
    In* mid = ring + static_cast<int64_t>(slot) * NP * Cm;
    __syncthreads();  // out[t-1] has read the slot (it held mid[t-2])
    for (int m0 = 0; m0 < Cm; m0 += MB) {
      float acc[RP][RM];
#pragma unroll
      for (int i = 0; i < RP; ++i) {
#pragma unroll
        for (int j = 0; j < RM; ++j) acc[i][j] = 0.f;
      }
      for (int c0 = 0; c0 < C; c0 += CK) {
        __syncthreads();  // earlier readers of xh / wbuf are done
        for (int e = tid; e < halo_n * CK; e += kThreads) {
          const int c = e % CK, q = e / CK;
          const int hh = h0 - 1 + q / halo_w;
          const int ww = w0 - 1 + q % halo_w;
          float v = 0.f;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W && c0 + c < C) {
            v = to_f(x_t[(static_cast<int64_t>(hh) * W + ww) * C + c0 + c]);
          }
          xh[e] = v;
        }
        for (int e = tid; e < 9 * CK * MB; e += kThreads) {
          const int m = e % MB, c = (e / MB) % CK, tap = e / (MB * CK);
          wbuf[e] = (c0 + c < C && m0 + m < Cm)
                        ? ks[(static_cast<int64_t>(tap) * C + c0 + c) * Cm
                             + m0 + m]
                        : 0.f;
        }
        __syncthreads();
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap) {
          const int toff = (tap / 3) * halo_w + tap % 3;
          const float* wt = wbuf + tap * CK * MB;
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            float a[RP], w[RM];
#pragma unroll
            for (int i = 0; i < RP; ++i) a[i] = xh[(hoff[i] + toff) * CK + c];
#pragma unroll
            for (int j = 0; j < RM; ++j) w[j] = wt[c * MB + tx + kSide * j];
#pragma unroll
            for (int i = 0; i < RP; ++i) {
#pragma unroll
              for (int j = 0; j < RM; ++j) {
                acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int m = m0 + tx + kSide * j;
        if (m >= Cm) continue;
        const float sc = scale[m], sh = shift[m];
#pragma unroll
        for (int i = 0; i < RP; ++i) {
          float v = __fadd_rn(__fmul_rn(acc[i][j], sc), sh);
          v = v < 0.f ? 0.f : v;  // relu; NaN passes through
          mid[(ty + kSide * i) * Cm + m] = from_f<In>(v);
        }
      }
    }
  };

  // out[t] from the ring, for every Co tile
  auto compute_out = [&](int t) {
    In* out_t = out + (static_cast<int64_t>(b) * T + t) * HW * Co;
    for (int o0 = 0; o0 < Co; o0 += MB) {
      float acc[RP][RM];
#pragma unroll
      for (int i = 0; i < RP; ++i) {
#pragma unroll
        for (int j = 0; j < RM; ++j) acc[i][j] = 0.f;
      }
      for (int dt = 0; dt < 3; ++dt) {
        const int tf = t + dt - 1;
        if (tf < 0 || tf >= T) continue;  // the zero mid frames
        const In* mid = ring + static_cast<int64_t>(tf % 3) * NP * Cm;
        for (int mm0 = 0; mm0 < Cm; mm0 += MK) {
          __syncthreads();  // the ring slot is written; wbuf is free
          for (int e = tid; e < MK * MB; e += kThreads) {
            const int o = e % MB, m = e / MB;
            wbuf[e] = (mm0 + m < Cm && o0 + o < Co)
                          ? kt[(static_cast<int64_t>(dt) * Cm + mm0 + m) * Co
                               + o0 + o]
                          : 0.f;
          }
          __syncthreads();
          const int mk = min(MK, Cm - mm0);
#pragma unroll 4
          for (int m = 0; m < mk; ++m) {
            float a[RP], w[RM];
#pragma unroll
            for (int i = 0; i < RP; ++i) {
              a[i] = to_f(mid[(ty + kSide * i) * Cm + mm0 + m]);
            }
#pragma unroll
            for (int j = 0; j < RM; ++j) w[j] = wbuf[m * MB + tx + kSide * j];
#pragma unroll
            for (int i = 0; i < RP; ++i) {
#pragma unroll
              for (int j = 0; j < RM; ++j) {
                acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        if (!valid[i]) continue;
#pragma unroll
        for (int j = 0; j < RM; ++j) {
          const int o = o0 + tx + kSide * j;
          if (o < Co) out_t[gpos[i] * Co + o] = from_f<In>(acc[i][j]);
        }
      }
    }
  };

  compute_mid(0, 0);
  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) compute_mid(t + 1, (t + 1) % 3);
    compute_out(t);
  }
}

template <typename In, int RP, int RM>
int launch(const In* x, const float* ks, const float* scale,
           const float* shift, const float* kt, In* out, int B, int T, int H,
           int W, int C, int Cm, int Co, cudaStream_t stream) {
  constexpr int NP = Tile<RP, RM>::NP;
  const size_t smem = smem_bytes<In, RP, RM>(Cm);
  const int TW = W < NP ? W : NP;
  const int TH = H < NP / TW ? H : NP / TW;
  const int n_th = (H + TH - 1) / TH, n_tw = (W + TW - 1) / TW;
  auto kern = fused_c2p1d_kernel<In, RP, RM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<dim3(n_th * n_tw, B), kThreads, smem, stream>>>(
      x, ks, scale, shift, kt, out, T, H, W, C, Cm, Co, TH, TW, n_tw);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int positions(int Cm) {
  if (smem_bytes<In, 4, 4>(Cm) <= kMaxSmem) return 64;
  if (smem_bytes<In, 2, 8>(Cm) <= kMaxSmem) return 32;
  if (smem_bytes<In, 1, 16>(Cm) <= kMaxSmem) return 16;
  return 0;
}

template <typename In>
int dispatch(const void* x, const float* ks, const float* scale,
             const float* shift, const float* kt, void* out, int B, int T,
             int H, int W, int C, int Cm, int Co, cudaStream_t st) {
  const In* xi = static_cast<const In*>(x);
  In* oi = static_cast<In*>(out);
  switch (positions<In>(Cm)) {
    case 64:
      return launch<In, 4, 4>(xi, ks, scale, shift, kt, oi, B, T, H, W, C,
                              Cm, Co, st);
    case 32:
      return launch<In, 2, 8>(xi, ks, scale, shift, kt, oi, B, T, H, W, C,
                              Cm, Co, st);
    case 16:
      return launch<In, 1, 16>(xi, ks, scale, shift, kt, oi, B, T, H, W, C,
                               Cm, Co, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Positions per block the kernel takes for Cm mid channels in x's dtype
// (64, 32 or 16), or 0 if even 16 do not fit in shared memory.
extern "C" int fused_c2p1d_positions(int x_bf16, int Cm) {
  return x_bf16 ? positions<__nv_bfloat16>(Cm) : positions<float>(Cm);
}

// Plain C interface (loaded with ctypes). x (B,T,H,W,C) contiguous, fp32 or
// (x_bf16 != 0) bf16; ks (3,3,C,Cm), scale (Cm,), shift (Cm,), kt
// (3,Cm,Co) contiguous fp32; out (B,T,H,W,Co) contiguous in x's dtype.
// B, T, H, W, Cm, Co >= 1, C >= 0, B <= 65535,
// fused_c2p1d_positions(x_bf16, Cm) > 0. Launches on `stream` without
// synchronising; returns the cudaError_t of the attribute call or launch.
extern "C" int fused_c2p1d_forward(const void* x, int x_bf16, const float* ks,
                                   const float* scale, const float* shift,
                                   const float* kt, void* out, int B, int T,
                                   int H, int W, int C, int Cm, int Co,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? dispatch<__nv_bfloat16>(x, ks, scale, shift, kt, out, B,
                                          T, H, W, C, Cm, Co, st)
                : dispatch<float>(x, ks, scale, shift, kt, out, B, T, H, W,
                                  C, Cm, Co, st);
}

extern "C" const char* fused_c2p1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
