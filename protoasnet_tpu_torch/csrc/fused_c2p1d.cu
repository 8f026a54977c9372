// Fused eval-mode Conv2Plus1D block, stride 1, channels-last, forward, on
// Hopper's tensor cores: spatial (1,3,3) conv + folded BatchNorm affine +
// ReLU + temporal (3,1,1) conv, with the mid activation kept in shared
// memory.
//
// Replaces the Pallas TPU kernel experiments/pallas_fused_c2p1d.py
// (fused_c2p1d -> _kernel). Per sample b, frame t and pixel (h,w):
//
//   mid[t,h,w,m] = relu(sum_{dh,dw,c} x[t,h+dh-1,w+dw-1,c]*ks[dh,dw,c,m]
//                       * scale[m] + shift[m])      rounded to x's dtype
//   out[t,h,w,o] = sum_{dt,m} mid[t+dt-1,h,w,m] * kt[dt,m,o]
//
// with x = 0 outside the image (SAME padding of the spatial conv) and
// mid[-1] = mid[T] = 0 (the temporal conv pads the mid with zeros, not with
// relu(shift)). fp32 sums; the affine is a rounded multiply then a rounded
// add (never an FMA); mid and out are rounded to x's dtype where the plain
// version (ops/fused_c2p1d.py::fused_c2p1d_torch) rounds them.
//
// Products, all on the tensor cores with mma.sync and fp32 accumulators, as
// in temporal_conv.cu:
//  - bf16 x: mma.m16n8k16 bf16 fed by ldmatrix from bf16 tiles. The taps
//    come as k_hi = bf16(k) and, for fp32 taps, k_lo = bf16(k - k_hi); the
//    k_lo product runs only when k_lo is given (the wrapper drops it when
//    both tap arrays are bf16). mid enters the temporal product as the bf16
//    it was rounded to;
//  - fp32 x: 3xTF32 on mma.m16n8k8 tf32: each operand v as hi = rna(v) and
//    lo = rna(v - hi) (cvt.rna): the taps once by the wrapper
//    (ops/temporal_conv.py::split_tf32), the x halo once per staged item
//    (in place, into a hi and a lo array: each halo element feeds 9 taps x
//    4 warps), mid in registers as it is read. The tensor
//    cores truncate when they accumulate, which over K = 9*256 (spatial)
//    and 3*576 (temporal) misses the 1e-5 limit, so the three products of
//    each k8 step start from zero and are added to the running sums with
//    fp32 adds.
//
// What bounds it on an H100 (B=8; FLOPs of the taps inside the clip,
// experiments/fused_c2p1d.py::flops; x, taps and out moved once):
//   layer1 (T=32, 56x56, 64->144->64)    173.49 GFLOP, 206 MB bf16
//   layer2 (T=16, 28x28, 128->288->128)   84.73 GFLOP, 52 MB bf16
//   layer3 (T=8, 14x14, 256->576->256)    40.37 GFLOP, 16 MB bf16
// bf16 at 989 TFLOP/s: 0.175 / 0.086 / 0.041 ms against 0.061 / 0.016 /
// 0.005 ms of bytes; fp32 at the 3xTF32 rate (165 TFLOP/s): 1.05 / 0.51 /
// 0.24 ms against twice the bytes. Bound by operations in both dtypes at
// every shape; mid (2.25x the bytes of x) never goes to device memory.
//
// Design, against what held PR 3's CUDA-core kernel back:
//  - tensor cores for both GEMMs (above), on tiles kept in x's dtype: the x
//    halo, the tap stages and the mid ring are bf16 for bf16 x;
//  - the spatial conv is an implicit GEMM (64 positions x 9C) x (9C x Cm)
//    on a halo tile: per channel chunk, the tile's TH x TW pixels with a
//    1-pixel halo ((TH+2)(TW+2) rows of the chunk's channels, zeros
//    outside the image) are staged once, and the 9 taps are row offsets
//    into it: ldmatrix takes one row address per lane, so the im2col costs
//    nothing;
//  - mid never leaves the SM: a ring of three mid frames (64 positions x
//    the block's mid channels, x's dtype) in shared memory; the block
//    computes mid[f] once, then out[f-1] from mid[f-2..f] over K = 3 x its
//    mid channels, one 64-output pass at a time, so the accumulators stay
//    at 16 per thread for any Co (the ring, not three rolling output sets,
//    at every shape: three sets of Co=256 would take 192 registers);
//  - the taps are streamed, not restaged element-wise: one stream of
//    items per block (each pass's channel chunks of the spatial GEMM, then
//    each output pass's chunks of the temporal taps, frame after frame)
//    runs through a 3-stage cp.async ring two items ahead of the tensor
//    cores. An item is a 64-byte channel chunk (32 bf16, 16 with k_lo, 8
//    fp32) of the halo with its 9 x chunk x 64 spatial taps, or 3 x 3
//    chunks of mid channels x 64 outputs of temporal taps: ~46-50 KB;
//  - tap reuse is 64 positions (one frame tile) per byte streamed: per
//    block and frame the spatial taps of its mid channels (9*C*slice) and
//    the temporal taps (3*slice*Co) leave L2 once, 221 KB at layer1 bf16,
//    2.8 GB over the clip (x4 in fp32: 4-byte hi and lo arrays);
//  - enough blocks: grid (spatial tiles, mid-channel splits, B). The tile
//    is TH x TW <= 64 positions with the fewest tiles per frame (8x8 at
//    56x56, 4x14 at 28x28 and 14x14). Where tiles x B is under the card's
//    SM count, or the ring does not fit, Cm is split into S slices of a
//    multiple of 16 channels: each block computes its slice of mid (no
//    work is repeated) and writes its part of out in fp32 to a scratch
//    array, which a second kernel sums over the slices in order and rounds
//    to x's dtype. S is the fewest that fills the SMs and fits (the
//    wrapper, ops/fused_c2p1d_cuda.py::tiling; a split into more, shorter
//    slices that filled the waves better measured no faster at layer3).
//    bf16 / fp32: layer1 392 blocks, S=1 / 784, S=2; layer2 224, S=2 / 336,
//    S=3; layer3 160, S=5 / 192, S=6;
//  - a warp whose 16 channels of a pass lie past the block's mid channels
//    (layer1's third spatial pass: 16 of 64) or past Co skips the products;
//  - shared-memory rows padded by 16 bytes (halo, ring) and 8 elements
//    (taps): ldmatrix and the fp32 fragment loads are free of bank
//    conflicts; staging is cp.async where rows of x, ks and kt are 16-byte
//    multiples and the pointers 16-byte aligned, else element-wise and
//    masked (C=3 or 5, Co=65, views off a 16-byte boundary);
//  - 256 threads = 8 warps as 2 (positions) x 4 (channels): a warp's tile
//    is 32 positions x 16 channels (2 x 2 m16n8 tiles) in both GEMMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNP = 64;      // positions per block (4 m16 tiles)
constexpr int kNB = 64;      // channels per pass (mid or out)
constexpr int kKP = kNB + 8;  // tap row pitch (elements)
constexpr int kStages = 3;   // cp.async ring depth (items)
constexpr int kSlots = 3;    // mid frames in the ring

// x channels per item: a 64-byte chunk, or 32 bytes when k_lo doubles the
// taps (so that every item stays near 48 KB)
template <typename In, bool kLo>
__host__ __device__ constexpr int chunk_channels() {
  return sizeof(In) == 4 ? 8 : (kLo ? 16 : 32);
}
template <typename In>
__host__ __device__ constexpr int step_channels() {  // k of one mma
  return sizeof(In) == 2 ? 16 : 8;
}
template <typename In>
__host__ __device__ constexpr int pad() {  // 16 bytes
  return 16 / static_cast<int>(sizeof(In));
}
__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// shared-memory layout (elements of In): kStages items, then the ring
template <typename In, bool kLo>
struct Layout {
  static constexpr int kCK = chunk_channels<In, kLo>();
  static constexpr int kMK = 3 * kCK;          // mid channels per item
  static constexpr int kHP = kCK + pad<In>();  // halo row pitch
  static constexpr int kArr = kLo ? 2 : 1;
  // fp32 x: the halo as staged is split in place into TF32 hi and a second
  // array of lo, once per item (not once per tap and warp)
  static constexpr int kHalos = sizeof(In) == 4 ? 2 : 1;
  static constexpr int kTapElems = 9 * kCK * kKP;  // = 3 * kMK * kKP
  __host__ __device__ static int taps(int hr) { return hr * kHP * kHalos; }
  __host__ __device__ static int stage(int hr) {
    return taps(hr) + kTapElems * kArr;
  }
  __host__ __device__ static int ring_pitch(int slice) {
    return round16(slice) + pad<In>();
  }
  __host__ __device__ static int64_t bytes(int hr, int slice) {
    return (static_cast<int64_t>(kStages) * stage(hr) +
            static_cast<int64_t>(kSlots) * kNP * ring_pitch(slice)) *
           static_cast<int64_t>(sizeof(In));
  }
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
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d += a * b on the tensor cores
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

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename In>
struct Params {
  const In* x;
  const In* ks;     // (3, 3, C, Cm): rows (tap, c)
  const In* ks_lo;  // its second array (TF32 lo, or bf16 k_lo), or null
  const float* scale;
  const float* shift;
  const In* kt;     // (3, Cm, Co): rows (dt, m)
  const In* kt_lo;
  In* out;          // (B, T, H, W, Co)
  float* part;      // (S, B, T, H, W, Co) fp32 when Cm is split, or null
  int T, H, W, C, Cm, Co, TH, TW, n_tw, slice;
};

// The block's place and the thread's place in it.
struct Geo {
  int tid, lane, wm, wn, g, t4;  // g, t4: mma fragment row/col
  int b, split, h0, w0, hw, hr;  // hw: halo row width, hr: halo rows
  int m_base, m_len;             // the block's mid channels
  int n_ck, n_sp, n_mk, n_op;    // chunks and passes of the two GEMMs
};

template <typename In, bool kLo>
__device__ __forceinline__ Geo make_geo(const Params<In>& p) {
  using L = Layout<In, kLo>;
  Geo q;
  q.tid = threadIdx.x;
  q.lane = q.tid & 31;
  q.wm = (q.tid >> 5) >> 2;
  q.wn = (q.tid >> 5) & 3;
  q.g = q.lane >> 2;
  q.t4 = q.lane & 3;
  q.b = blockIdx.z;
  q.split = blockIdx.y;
  q.h0 = (blockIdx.x / p.n_tw) * p.TH;
  q.w0 = (blockIdx.x % p.n_tw) * p.TW;
  q.hw = p.TW + 2;
  q.hr = (p.TH + 2) * q.hw;
  q.m_base = q.split * p.slice;
  q.m_len = min(p.slice, p.Cm - q.m_base);
  q.n_ck = p.C > L::kCK ? (p.C + L::kCK - 1) / L::kCK : 1;
  q.n_sp = (q.m_len + kNB - 1) / kNB;
  q.n_mk = (q.m_len + L::kMK - 1) / L::kMK;
  q.n_op = (p.Co + kNB - 1) / kNB;
  return q;
}

// One item of the block's stream. kind 0: chunk `chunk` (x channels) of
// pass `pass` (64 mid channels) of the spatial GEMM of mid[f]; kind 1:
// chunk `chunk` (mid channels) of pass `pass` (64 outputs) of the temporal
// GEMM of out[f-1]. The stream: mid[0], then mid[f] and out[f-1] for f =
// 1..T-1, then out[T-1]; it ends at f = T+1.
struct Cursor {
  int f = 0, kind = 0, pass = 0, chunk = 0;
};

__device__ __forceinline__ void advance(Cursor& c, const Geo& q, int T) {
  if (++c.chunk < (c.kind ? q.n_mk : q.n_ck)) return;
  c.chunk = 0;
  if (++c.pass < (c.kind ? q.n_op : q.n_sp)) return;
  c.pass = 0;
  if (c.kind == 0 && c.f >= 1) {  // mid[f] is done: out[f-1] next
    c.kind = 1;
    return;
  }
  ++c.f;  // mid[f+1] next, or at f == T out[T-1] alone
  c.kind = c.f < T ? 0 : 1;
}

// Stage item c into st: kind 0 the halo tile of x[b, f] (channels of the
// chunk) and the chunk's 9 x kCK x 64 spatial taps; kind 1 the chunk's
// 3 x kMK x 64 temporal taps. Taps start at st + taps(hr) (and k_lo's
// kTapElems further); everything outside the image, C, the block's mid
// channels or Co is zero.
template <typename In, bool kAligned, bool kLo>
__device__ __forceinline__ void load_item(In* st, const Params<In>& p,
                                          const Geo& q, const Cursor& c) {
  using L = Layout<In, kLo>;
  constexpr int kPer = kAligned ? 16 / sizeof(In) : 1;  // elements per copy
  constexpr int kGR = kNB / kPer;                       // copies per tap row
  In* const taps = st + L::taps(q.hr);
  const int m_end = q.m_base + q.m_len;
  if (c.kind == 0) {
    const int c0 = c.chunk * L::kCK;
    const int n0 = q.m_base + c.pass * kNB;
    const In* const xf =
        p.x + (static_cast<int64_t>(q.b) * p.T + c.f) * p.H * p.W * p.C;
    constexpr int kG = L::kCK / kPer;  // copies per halo row
    for (int e = q.tid; e < q.hr * kG; e += kThreads) {
      const int r = e / kG, ch = c0 + e % kG * kPer;
      const int hh = q.h0 - 1 + r / q.hw, ww = q.w0 - 1 + r % q.hw;
      const bool ok = hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && ch < p.C;
      const int64_t off = (static_cast<int64_t>(hh) * p.W + ww) * p.C + ch;
      In* const dst = st + r * L::kHP + e % kG * kPer;
      if constexpr (kAligned)
        cp_async16(dst, ok ? xf + off : p.x, ok);
      else
        *dst = ok ? xf[off] : from_f<In>(0.f);
    }
    for (int e = q.tid; e < 9 * L::kCK * kGR; e += kThreads) {
      const int row = e / kGR, n = e % kGR * kPer;  // row: tap * kCK + cc
      const int ch = c0 + row % L::kCK, m = n0 + n;
      const bool ok = ch < p.C && m < m_end;
      const int64_t off =
          (static_cast<int64_t>(row / L::kCK) * p.C + ch) * p.Cm + m;
      In* const dst = taps + row * kKP + n;
      if constexpr (kAligned) {
        cp_async16(dst, ok ? p.ks + off : p.ks, ok);
        if constexpr (kLo)
          cp_async16(dst + L::kTapElems, ok ? p.ks_lo + off : p.ks_lo, ok);
      } else {
        *dst = ok ? p.ks[off] : from_f<In>(0.f);
        if constexpr (kLo) dst[L::kTapElems] = ok ? p.ks_lo[off] : from_f<In>(0.f);
      }
    }
  } else {
    const int mk0 = c.chunk * L::kMK, o0 = c.pass * kNB;
    for (int e = q.tid; e < 3 * L::kMK * kGR; e += kThreads) {
      const int row = e / kGR, n = e % kGR * kPer;  // row: dt * kMK + mm
      const int m = q.m_base + mk0 + row % L::kMK, o = o0 + n;
      const bool ok = m < m_end && o < p.Co;
      const int64_t off =
          (static_cast<int64_t>(row / L::kMK) * p.Cm + m) * p.Co + o;
      In* const dst = taps + row * kKP + n;
      if constexpr (kAligned) {
        cp_async16(dst, ok ? p.kt + off : p.kt, ok);
        if constexpr (kLo)
          cp_async16(dst + L::kTapElems, ok ? p.kt_lo + off : p.kt_lo, ok);
      } else {
        *dst = ok ? p.kt[off] : from_f<In>(0.f);
        if constexpr (kLo) dst[L::kTapElems] = ok ? p.kt_lo[off] : from_f<In>(0.f);
      }
    }
  }
}

// acc += A (the warp's 32 positions x kc channels) x B (kc x the warp's nj
// n8 tiles of channels, nj = 1 or 2). a.r: bf16, r[i] is the lane's ldmatrix
// row (lane & 15) of m16 tile i at channel 0; fp32, r[2i + h] is row g + 8h
// of tile i, split into TF32 hi and lo here, or (kPreA) already split with
// the lo array `a_lo` elements further. b: tap row 0 at the warp's first
// channel (pitch kKP), the second array `lo` further.
template <typename In>
struct Rows {
  const In* r[4];
};

template <typename In, bool kLo, bool kPreA>
__device__ __forceinline__ void mma_rows(float (&acc)[2][2][4],
                                         const Rows<In>& a, int a_lo,
                                         const In* b, int lo, int kc, int nj,
                                         const Geo& q) {
  if constexpr (sizeof(In) == 2) {
#pragma unroll 2
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i], a.r[i] + kk + (q.lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < (kLo ? 2 : 1); ++h) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, b + h * lo + (kk + (q.lane & 15)) * kKP +
                                  (q.lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][0], af[i], bb[0], bb[1]);
          if (nj > 1) mma_bf16(acc[i][1], af[i], bb[2], bb[3]);
        }
      }
    }
  } else {
    static_assert(kLo, "fp32 taps come split in two");
#pragma unroll 2
    for (int kk = 0; kk < kc; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* const r0 =
            reinterpret_cast<const float*>(a.r[2 * i]) + kk + q.t4;
        const float* const r1 =
            reinterpret_cast<const float*>(a.r[2 * i + 1]) + kk + q.t4;
        // (g, t), (g+8, t), (g, t+4), (g+8, t+4)
        const float* const at[4] = {r0, r1, r0 + 4, r1 + 4};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kPreA) {
            ahi[i][e] = __float_as_uint(at[e][0]);
            alo[i][e] = __float_as_uint(at[e][a_lo]);
          } else {
            split_tf32(at[e][0], ahi[i][e], alo[i][e]);
          }
        }
      }
      const uint32_t* const kh = reinterpret_cast<const uint32_t*>(b) +
                                 (kk + q.t4) * kKP + q.g;
      const uint32_t* const kl = kh + lo;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= nj) continue;
        const uint32_t bh0 = kh[j * 8], bh1 = kh[4 * kKP + j * 8];
        const uint32_t bl0 = kl[j * 8], bl1 = kl[4 * kKP + j * 8];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // the tensor cores truncate when they accumulate: the three
          // products of one k8 step start from zero and go into the
          // running sums by fp32 adds (round to nearest)
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(t, alo[i], bh0, bh1);
          mma_tf32(t, ahi[i], bl0, bl1);
          mma_tf32(t, ahi[i], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
      }
    }
  }
}

// fp32 x: the staged halo (hr rows of kCK channels) split in place into
// TF32 hi, with lo hr * kHP elements further
template <typename In, bool kLo>
__device__ __forceinline__ void split_halo(In* halo, const Geo& q) {
  using L = Layout<In, kLo>;
  float* const h = reinterpret_cast<float*>(halo);
  for (int e = q.tid; e < q.hr * L::kCK; e += kThreads) {
    float* const v = h + e / L::kCK * L::kHP + e % L::kCK;
    uint32_t hi, lo;
    split_tf32(*v, hi, lo);
    *v = __uint_as_float(hi);
    v[q.hr * L::kHP] = __uint_as_float(lo);
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// The pass's 64 mid channels of the block's positions into a ring slot:
// affine (rounded multiply, rounded add), ReLU (NaN passes), rounding to
// x's dtype; channels past the block's own up to a multiple of 16 are 0.
template <typename In>
__device__ __forceinline__ void store_mid(const float (&acc)[2][2][4],
                                          In* mid, int rp, int pass,
                                          const Params<In>& p, const Geo& q) {
  const int width = round16(q.m_len);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = pass * kNB + q.wn * 16 + j * 8 + 2 * q.t4;
    if (n >= width) continue;
    float sc[2], sh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = n + e < q.m_len;
      sc[e] = ok ? p.scale[q.m_base + n + e] : 0.f;
      sh[e] = ok ? p.shift[q.m_base + n + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = __fadd_rn(__fmul_rn(acc[i][j][2 * h + e], sc[e]),
                                    sh[e]);
          v[e] = a < 0.f ? 0.f : a;
        }
        const int pos = q.wm * 32 + i * 16 + q.g + 8 * h;
        put2(mid + pos * rp + n, v[0], v[1]);
      }
  }
}

// The pass's 64 outputs of out[t] at the block's positions in the image:
// rounded to x's dtype, or into the block's fp32 part when Cm is split.
template <typename In>
__device__ __forceinline__ void store_out(const float (&acc)[2][2][4],
                                          int t, int pass,
                                          const Params<In>& p, const Geo& q) {
  const int64_t frame = static_cast<int64_t>(q.b) * p.T + t;
  float* const part =
      p.part == nullptr
          ? nullptr
          : p.part + static_cast<int64_t>(q.split) * gridDim.z * p.T * p.H *
                         p.W * p.Co;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = q.wm * 32 + i * 16 + q.g + 8 * h;
      const int hh = q.h0 + pos / p.TW, ww = q.w0 + pos % p.TW;
      if (pos >= p.TH * p.TW || hh >= p.H || ww >= p.W) continue;
      const int64_t row = ((frame * p.H + hh) * p.W + ww) * p.Co;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = pass * kNB + q.wn * 16 + j * 8 + 2 * q.t4;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (p.Co % 2 == 0) {  // o is even, so o < Co implies o + 1 < Co
          if (o >= p.Co) continue;
          if (part != nullptr)
            put2(part + row + o, v0, v1);
          else
            put2(p.out + row + o, v0, v1);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (o + e >= p.Co) continue;
            const float v = e ? v1 : v0;
            if (part != nullptr)
              part[row + o + e] = v;
            else
              p.out[row + o + e] = from_f<In>(v);
          }
        }
      }
    }
}

template <typename In, bool kAligned, bool kLo>
__global__ void __launch_bounds__(kThreads)
fused_c2p1d_kernel(const Params<In> p) {
  using L = Layout<In, kLo>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  In* const smem = reinterpret_cast<In*>(smem_raw);
  const Geo q = make_geo<In, kLo>(p);
  const int stage = L::stage(q.hr);
  const int rp = L::ring_pitch(p.slice);
  In* const ring = smem + kStages * stage;

  // the thread's A rows: positions (bf16: ldmatrix row lane & 15 of tiles
  // 0, 1; fp32: rows g, g + 8 of tiles 0, 1) and their halo rows
  int pos[4], hrow[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pos[k] = sizeof(In) == 2 ? q.wm * 32 + (k & 1) * 16 + (q.lane & 15)
                             : q.wm * 32 + (k >> 1) * 16 + q.g + 8 * (k & 1);
    hrow[k] = pos[k] < p.TH * p.TW
                  ? pos[k] / p.TW * q.hw + pos[k] % p.TW
                  : 0;  // a row past the tile: computed, never stored
  }

  float acc_s[2][2][4], acc_t[2][2][4];
  zero(acc_s);
  zero(acc_t);
  Cursor ld, cs;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (ld.f <= p.T) load_item<In, kAligned, kLo>(smem + s * stage, p, q, ld);
    cp_async_commit();
    advance(ld, q, p.T);
  }
  for (int i = 0; cs.f <= p.T; ++i) {
    cp_async_wait<kStages - 2>();  // item i has landed (this thread's part)
    __syncthreads();  // ... everyone's; slot (i - 1) % kStages is free
    if (ld.f <= p.T)
      load_item<In, kAligned, kLo>(smem + (i + kStages - 1) % kStages * stage,
                                   p, q, ld);
    cp_async_commit();
    advance(ld, q, p.T);

    In* const st = smem + i % kStages * stage;
    const In* const taps = st + L::taps(q.hr) + q.wn * 16;
    constexpr bool kF32 = sizeof(In) == 4;
    Rows<In> a;
    if (cs.kind == 0) {  // mid[f], spatial
      if constexpr (kF32) {
        split_halo<In, kLo>(st, q);
        __syncthreads();
      }
      if (cs.chunk == 0) zero(acc_s);
      // the warp's channels of this pass inside the block's (16 or none)
      const bool busy =
          round16(q.m_len) - cs.pass * kNB - q.wn * 16 > 0;
#pragma unroll
      for (int tap = 0; busy && tap < 9; ++tap) {
        const int toff = tap / 3 * q.hw + tap % 3;
#pragma unroll
        for (int k = 0; k < 4; ++k) a.r[k] = st + (hrow[k] + toff) * L::kHP;
        mma_rows<In, kLo, kF32>(acc_s, a, q.hr * L::kHP,
                                taps + tap * L::kCK * kKP, L::kTapElems,
                                L::kCK, 2, q);
      }
      if (cs.chunk == q.n_ck - 1)
        store_mid<In>(acc_s, ring + cs.f % kSlots * kNP * rp, rp, cs.pass, p,
                      q);
    } else {  // out[t], temporal
      const int t = cs.f - 1, mk0 = cs.chunk * L::kMK;
      constexpr int kS = step_channels<In>();
      const int kc = min(L::kMK, (q.m_len - mk0 + kS - 1) / kS * kS);
      if (cs.chunk == 0) zero(acc_t);
      const int nw = p.Co - cs.pass * kNB - q.wn * 16;  // the warp's outputs
#pragma unroll 1
      for (int dt = 0; nw > 0 && dt < 3; ++dt) {
        const int tf = t + dt - 1;
        if (tf < 0 || tf >= p.T) continue;  // the zero mid frames
        const In* const mid = ring + tf % kSlots * kNP * rp + mk0;
#pragma unroll
        for (int k = 0; k < 4; ++k) a.r[k] = mid + pos[k] * rp;
        mma_rows<In, kLo, false>(acc_t, a, 0, taps + dt * L::kMK * kKP,
                                 L::kTapElems, kc, nw > 8 ? 2 : 1, q);
      }
      if (cs.chunk == q.n_mk - 1) store_out<In>(acc_t, t, cs.pass, p, q);
    }
    advance(cs, q, p.T);
  }
  cp_async_wait<0>();
}

// out = x's dtype of the sum over the S parts, in order
template <typename In>
__global__ void __launch_bounds__(256)
sum_parts_kernel(const float* __restrict__ part, In* __restrict__ out,
                 int64_t n, int S) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < S; ++k) s += part[k * n + i];
    out[i] = from_f<In>(s);
  }
}

template <typename In, bool kAligned, bool kLo>
int launch(const Params<In>& p, int B, int S, cudaStream_t st) {
  const int64_t bytes =
      Layout<In, kLo>::bytes((p.TH + 2) * (p.TW + 2), p.slice);
  auto kern = fused_c2p1d_kernel<In, kAligned, kLo>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_th = (p.H + p.TH - 1) / p.TH;
  kern<<<dim3(n_th * p.n_tw, S, B), kThreads, bytes, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.part == nullptr) return static_cast<int>(e);
  const int64_t n = static_cast<int64_t>(B) * p.T * p.H * p.W * p.Co;
  const int64_t blocks = (n + 255) / 256;
  sum_parts_kernel<In><<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                         256, 0, st>>>(p.part, p.out, n, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int dispatch(const Params<In>& p, int aligned, int B, int S,
             cudaStream_t st) {
  const bool lo = p.ks_lo != nullptr;
  if constexpr (sizeof(In) == 4) {
    if (!lo) return static_cast<int>(cudaErrorInvalidValue);  // needs k_lo
    return aligned ? launch<In, true, true>(p, B, S, st)
                   : launch<In, false, true>(p, B, S, st);
  } else {
    if (lo)
      return aligned ? launch<In, true, true>(p, B, S, st)
                     : launch<In, false, true>(p, B, S, st);
    return aligned ? launch<In, true, false>(p, B, S, st)
                   : launch<In, false, false>(p, B, S, st);
  }
}

}  // namespace

// Dynamic shared memory of one block for x in bf16 (x_bf16) or fp32, with
// one tap array or two (fp32 always has two), a TH x TW tile and `slice`
// mid channels per block: kStages items and the ring of three mid frames.
extern "C" int64_t fused_c2p1d_smem_bytes(int x_bf16, int two_arrays, int TH,
                                          int TW, int slice) {
  const int hr = (TH + 2) * (TW + 2);
  if (!x_bf16) return Layout<float, true>::bytes(hr, slice);
  return two_arrays ? Layout<__nv_bfloat16, true>::bytes(hr, slice)
                    : Layout<__nv_bfloat16, false>::bytes(hr, slice);
}

// Plain C interface (loaded with ctypes). x (B,T,H,W,C) contiguous, fp32 or
// (x_bf16 != 0) bf16; ks (3,3,C,Cm) and kt (3,Cm,Co) contiguous in x's
// dtype, with ks_lo / kt_lo their second arrays (fp32 x: the TF32 split, ks
// = hi and ks_lo = lo, required; bf16 x: the bf16 split of fp32 taps, or
// both null); scale, shift (Cm,) fp32; out (B,T,H,W,Co) contiguous in x's
// dtype. The blocks take TH x TW positions (TH * TW <= 64) and `slice` mid
// channels (a multiple of 16, or >= Cm); when S = ceil(Cm / slice) > 1,
// part is fp32 scratch of S * B*T*H*W*Co. aligned != 0 only if rows of C,
// Cm and Co elements are 16-byte multiples and x and the tap arrays start
// on 16-byte boundaries. B, T, H, W, Cm, Co >= 1, C >= 0, B and S <= 65535.
// Launches on `stream` without synchronising; returns the cudaError_t of
// the attribute call or a launch.
extern "C" int fused_c2p1d_forward(const void* x, int x_bf16, const void* ks,
                                   const void* ks_lo, const float* scale,
                                   const float* shift, const void* kt,
                                   const void* kt_lo, void* out, float* part,
                                   int aligned, int B, int T, int H, int W,
                                   int C, int Cm, int Co, int TH, int TW,
                                   int slice, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = (Cm + slice - 1) / slice;
  if (TH < 1 || TW < 1 || TH * TW > kNP || (S > 1 && part == nullptr) ||
      (S > 1 && slice % 16 != 0) || (ks_lo == nullptr) != (kt_lo == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tw = (W + TW - 1) / TW;
  float* const pt = S > 1 ? part : nullptr;
  if (x_bf16) {
    using B16 = __nv_bfloat16;
    const Params<B16> p{static_cast<const B16*>(x), static_cast<const B16*>(ks),
                        static_cast<const B16*>(ks_lo), scale, shift,
                        static_cast<const B16*>(kt),
                        static_cast<const B16*>(kt_lo), static_cast<B16*>(out),
                        pt, T, H, W, C, Cm, Co, TH, TW, n_tw, slice};
    return dispatch<B16>(p, aligned, B, S, st);
  }
  const Params<float> p{static_cast<const float*>(x),
                        static_cast<const float*>(ks),
                        static_cast<const float*>(ks_lo), scale, shift,
                        static_cast<const float*>(kt),
                        static_cast<const float*>(kt_lo),
                        static_cast<float*>(out), pt, T, H, W, C, Cm, Co, TH,
                        TW, n_tw, slice};
  return dispatch<float>(p, aligned, B, S, st);
}

extern "C" const char* fused_c2p1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
