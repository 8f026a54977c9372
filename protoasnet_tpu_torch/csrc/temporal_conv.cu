// (3,1,1) temporal convolution, channels-last, SAME zero padding in T,
// stride 1 (the temporal half of R(2+1)D's Conv2Plus1D), forward, on
// Hopper's tensor cores.
//
// Replaces the Pallas TPU kernels experiments/pallas_temporal.py
// (temporal_conv_pallas, temporal_conv_pallas_v2, temporal_conv_pallas_v3:
// three tilings of one function). Per sample b, frame t and position s:
//
//   y[b,t,s,o] = sum_{dt=0..2} sum_c x[b,t+dt-1,s,c] * k[dt,c,o]
//
// with x[b,-1] = x[b,T] = 0, fp32 sums and y rounded once (to nearest
// even) to x's dtype.
//
// Products, all on the tensor cores with mma.sync and fp32 accumulators:
//  - bf16 x: mma.m16n8k16 bf16 fed by ldmatrix. A bf16 product is exact in
//    fp32, so only the order of the sums differs from the plain version.
//    The taps come as k_hi = bf16(k) and, for an fp32 k, k_lo = bf16(k -
//    k_hi) (the wrapper drops k_lo when it is all zero, as it is for a bf16
//    k); the second product runs only when k_lo is given.
//  - fp32 x: 3xTF32 on mma.m16n8k8 tf32. Each operand v is split into hi
//    = rna.tf32(v) and lo = rna.tf32(v - hi), x in registers (cvt.rna), the
//    taps once by the wrapper (ops/temporal_conv.py::split_tf32, staged as
//    two arrays), and a_lo*b_hi + a_hi*b_lo + a_hi*b_hi is summed. The
//    dropped a_lo*b_lo and the rounding of lo are ~2^-22 of a product, so
//    the result keeps fp32 accuracy (1e-5 of max |ref| against float64);
//    plain TF32 would not (~1e-3). The tensor cores truncate when they
//    accumulate, which over K = 3*576 drifts past that limit, so the three
//    products of each k8 step start from zero and are added to the running
//    sums with fp32 adds.
//
// What bounds it on an H100: at the flagship's layer1 shape (B=8, T=32,
// S=56*56, C=144, O=64) the function moves x and y once, 334 MB in bf16
// (0.0997 ms at 3.35 TB/s) against 43.5 GFLOP of taps inside the clip
// (2*B*S*C*O*(3T-2); 0.044 ms at 989 TFLOP/s): 130 FLOP per byte, under the
// card's ~295, so bf16 is bound by bytes and mma.sync has more rate than
// it needs (wgmma and TMA are a later step). In fp32 the 668 MB take 0.199
// ms and the 3 x 43.5 GFLOP of TF32 products 0.263 ms at 495 TFLOP/s, so
// fp32 is bound by operations at the 3xTF32 rate (165 TFLOP/s of fp32).
//
// Design:
//  - one block of BM/32 (fp32) or BM/16 (bf16) x 2 warps per (tile of 64
//    outputs, tile of BM positions, sample): grid (ceil(O/64), ceil(S/BM),
//    B), outputs fastest, so the blocks that share an x tile run next to
//    each other and the second read of x comes from L2. BM is 64, or 32
//    when 64 would give fewer blocks than the card has SMs
//    (temporal_conv_tile_rows);
//  - each input frame is read once: the block walks tin = 0..T-1, and each
//    staged part of frame tin is multiplied by all three taps into three
//    register sets of accumulators, for the outputs tin+1 (tap 0), tin
//    (tap 1) and tin-1 (tap 2). After frame tin, output tin-1 is complete:
//    it is written and the sets rotate. Output 0 never receives tap 0 and
//    output T-1 never tap 2, so the zero padding needs no branch; the two
//    taps that would land outside [0, T) (tap 2 at tin=0, tap 0 at
//    tin=T-1) are skipped for the whole block;
//  - two ways of staging. Where the block's three tap slices (both arrays)
//    and two x frame tiles fit in the shared memory a block may have
//    (temporal_conv_taps_resident; at 64 positions: the stem, and layer1
//    and layer2 in bf16), the resident kernel loads the taps once and x a
//    whole frame tile (BM contiguous rows) at a time, one frame ahead, so x
//    streams in long runs and the taps leave L2 once per block. Otherwise a
//    ring of 3 stages holds one 64-byte channel chunk of the BM x rows (32
//    bf16 or 16 fp32 channels) and the chunk's three tap slices (x 64
//    outputs, and the second tap array when given), two chunks ahead of
//    the tensor cores. scripts/temporal_conv_probe.py times builds of this
//    file with parts of the work dropped (PERF.md);
//  - when rows of x and k are 16-byte multiples and the pointers 16-byte
//    aligned, staging is cp.async (zero-fill past S, C and O); otherwise
//    (C=45, a view off a 16-byte boundary) element by element, masked.
//    Channels past C are zeros, so K is padded to the chunk or k-step;
//  - shared-memory rows are padded by 16 bytes (x) and 8 elements (taps),
//    which keeps ldmatrix and the fp32 fragment loads free of bank
//    conflicts;
//  - warp tile: 16 (bf16) or 32 (fp32, so that each split tap fragment
//    serves two x tiles) positions x 32 outputs, so 3 x 4 (x 2) m16n8
//    accumulator tiles per thread; y is written from them as pairs (one
//    by one when O is odd).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;          // outputs per block
constexpr int kWN = kBN / 2;     // outputs per warp (2 warps across O)
constexpr int kNT = kWN / 8;     // m16n8 tiles across a warp's outputs
constexpr int kStages = 3;       // ring depth
constexpr int kChunkBytes = 64;  // channel bytes of x staged per step
constexpr int kKP = kBN + 8;     // tap row pitch (elements)
constexpr int kFrames = 2;       // x frames in the resident kernel's ring

// m16 tiles per warp across positions: 1 for bf16, 2 for fp32 (whose
// 3xTF32 B fragments are then reused over two A tiles)
template <typename In>
__host__ __device__ constexpr int m_tiles() {
  return sizeof(In) == 4 ? 2 : 1;
}
// BM positions per block, 16 * m_tiles per warp: BM / (16 * m_tiles) x 2
// warps
template <typename In>
__host__ __device__ constexpr int threads_for(int BM) {
  return BM / (16 * m_tiles<In>()) * 2 * 32;
}

// channels per mma k-step: 16 bf16 or 8 TF32
template <typename In>
__host__ __device__ constexpr int step_channels() {
  return sizeof(In) == 2 ? 16 : 8;
}

template <typename In, int BM, bool kLo>
struct Layout {
  static constexpr int kE = sizeof(In);
  static constexpr int kBK = kChunkBytes / kE;  // channels per chunk
  static constexpr int kXP = kBK + 16 / kE;     // x row pitch (elements)
  static constexpr int kXElems = BM * kXP;
  static constexpr int kKElems = 3 * kBK * kKP;  // three tap slices
  static constexpr int kStageElems = kXElems + kKElems * (kLo ? 2 : 1);
  static constexpr int kBytes = kStages * kStageElems * kE;
  static_assert((kXElems * kE) % 16 == 0 && (kKElems * kE) % 16 == 0,
                "stages keep 16-byte alignment");
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

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
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

// The block's geometry: tile origin and the thread's place in it.
struct Tile {
  int o0, s0, tid, lane, wm, wn, g, t4;  // g, t4: mma fragment row/col
  int S, C, O;
};

// Stage chunk i (frame i / nck, channels (i % nck) * kBK + [0, kBK)) into
// ring slot i % kStages: the x rows s0.. of the block's sample (xb) and the
// three tap slices (and k_lo's).
template <typename In, int BM, bool kAligned, bool kLo>
__device__ __forceinline__ void load_chunk(In* smem, const In* x,
                                           const In* xb, const In* k,
                                           const In* k_lo, int i, int nck,
                                           const Tile& q) {
  using L = Layout<In, BM, kLo>;
  constexpr int kBK = L::kBK, kXP = L::kXP;
  constexpr int kThreads = threads_for<In>(BM);
  In* const xs = smem + (i % kStages) * L::kStageElems;
  In* const ks = xs + L::kXElems;
  const In* const xt = xb + (i / nck) * (static_cast<int64_t>(q.S) * q.C);
  const int c0 = (i % nck) * kBK;
  const int64_t tap = static_cast<int64_t>(q.C) * q.O;
  if constexpr (kAligned) {
    constexpr int kPer = 16 / sizeof(In);  // elements per 16 bytes
    constexpr int kXRow = kBK / kPer, kKRow = kBN / kPer;
    static_assert((BM * kXRow) % kThreads == 0 &&
                  (3 * kBK * kKRow) % kThreads == 0, "whole passes");
#pragma unroll
    for (int e0 = 0; e0 < BM * kXRow; e0 += kThreads) {
      const int e = e0 + q.tid;
      const int r = e / kXRow, c = c0 + e % kXRow * kPer;
      const bool ok = q.s0 + r < q.S && c < q.C;
      cp_async16(xs + r * kXP + e % kXRow * kPer,
                 ok ? xt + static_cast<int64_t>(q.s0 + r) * q.C + c : x, ok);
    }
#pragma unroll
    for (int e0 = 0; e0 < 3 * kBK * kKRow; e0 += kThreads) {
      const int e = e0 + q.tid;
      const int row = e / kKRow, n = e % kKRow * kPer;  // row: dt * kBK + kr
      const int c = c0 + row % kBK, o = q.o0 + n;
      const bool ok = c < q.C && o < q.O;
      const int64_t off = row / kBK * tap + static_cast<int64_t>(c) * q.O + o;
      cp_async16(ks + row * kKP + n, ok ? k + off : k, ok);
      if constexpr (kLo)
        cp_async16(ks + L::kKElems + row * kKP + n, ok ? k_lo + off : k_lo,
                   ok);
    }
  } else {
    static_assert((BM * kBK) % kThreads == 0 &&
                  (3 * kBK * kBN) % kThreads == 0, "whole passes");
#pragma unroll 4
    for (int e0 = 0; e0 < BM * kBK; e0 += kThreads) {
      const int e = e0 + q.tid;
      const int r = e / kBK, cc = e % kBK;
      const int s = q.s0 + r, c = c0 + cc;
      xs[r * kXP + cc] = (s < q.S && c < q.C)
                             ? xt[static_cast<int64_t>(s) * q.C + c]
                             : zero<In>();
    }
#pragma unroll 4
    for (int e0 = 0; e0 < 3 * kBK * kBN; e0 += kThreads) {
      const int e = e0 + q.tid;
      const int row = e / kBN, n = e % kBN;
      const int c = c0 + row % kBK, o = q.o0 + n;
      const bool ok = c < q.C && o < q.O;
      const int64_t off = row / kBK * tap + static_cast<int64_t>(c) * q.O + o;
      ks[row * kKP + n] = ok ? k[off] : zero<In>();
      if constexpr (kLo)
        ks[L::kKElems + row * kKP + n] = ok ? k_lo[off] : zero<In>();
    }
  }
}

// Multiply the x rows at xs (pitch xp elements; the block's positions,
// channels [0, kc)) by the taps in use, tap dt at kt + dt * kdt (rows of
// kKP elements, channel-major like x) and, when kLo, the second tap array
// at kt + klo. acc[dt] collects tap dt, i.e. output frame tin + 1 - dt.
// The loop over k-steps is unrolled by kUnroll.
template <typename In, bool kLo, int kUnroll>
__device__ __forceinline__ void multiply(
    float (&acc)[3][m_tiles<In>()][kNT][4], const In* xs, int xp,
    const In* kt, int kdt, int klo, int kc, bool tap0, bool tap2,
    const Tile& q) {
  constexpr int kMT = m_tiles<In>();
  const int row0 = q.wm * 16 * kMT;  // the warp's first position
  if constexpr (sizeof(In) == 2) {
#pragma unroll(kUnroll)
    for (int kk = 0; kk < kc; kk += 16) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(a[i], xs + (row0 + i * 16 + (q.lane & 15)) * xp + kk +
                              (q.lane >> 4) * 8);
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        if ((dt == 0 && !tap0) || (dt == 2 && !tap2)) continue;
#pragma unroll
        for (int h = 0; h < (kLo ? 2 : 1); ++h) {
          const In* const kd = kt + h * klo + dt * kdt;
#pragma unroll
          for (int jp = 0; jp < kNT / 2; ++jp) {
            uint32_t bb[4];
            ldmatrix_x4_trans(bb, kd + (kk + (q.lane & 15)) * kKP +
                                      q.wn * kWN + jp * 16 +
                                      (q.lane >> 4) * 8);
#pragma unroll
            for (int i = 0; i < kMT; ++i) {
              mma_bf16(acc[dt][i][2 * jp], a[i], bb[0], bb[1]);
              mma_bf16(acc[dt][i][2 * jp + 1], a[i], bb[2], bb[3]);
            }
          }
        }
      }
    }
  } else {
    // the taps arrive split (hi, then lo: TF32 values); x is split here
#pragma unroll(kUnroll)
    for (int kk = 0; kk < kc; kk += 8) {
      uint32_t ahi[kMT][4], alo[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float* const xr = reinterpret_cast<const float*>(xs) +
                                (row0 + i * 16 + q.g) * xp + kk + q.t4;
        split_tf32(xr[0], ahi[i][0], alo[i][0]);           // (g, t)
        split_tf32(xr[8 * xp], ahi[i][1], alo[i][1]);      // (g+8, t)
        split_tf32(xr[4], ahi[i][2], alo[i][2]);           // (g, t+4)
        split_tf32(xr[8 * xp + 4], ahi[i][3], alo[i][3]);  // (g+8, t+4)
      }
#pragma unroll
      for (int dt = 0; dt < 3; ++dt) {
        if ((dt == 0 && !tap0) || (dt == 2 && !tap2)) continue;
        const uint32_t* const kh = reinterpret_cast<const uint32_t*>(kt) +
                                   dt * kdt + (kk + q.t4) * kKP + q.wn * kWN +
                                   q.g;
        const uint32_t* const kl = kh + klo;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          // (k=t, n=g) and (k=t+4, n=g)
          const uint32_t bh0 = kh[j * 8], bh1 = kh[4 * kKP + j * 8];
          const uint32_t bl0 = kl[j * 8], bl1 = kl[4 * kKP + j * 8];
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            // the tensor cores' own accumulation truncates; the three
            // products of one k8 step are summed there from zero and
            // added to the running sums by fp32 adds (round to nearest)
            float p[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(p, alo[i], bh0, bh1);
            mma_tf32(p, ahi[i], bl0, bl1);
            mma_tf32(p, ahi[i], bh0, bh1);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[dt][i][j][e] += p[e];
          }
        }
      }
    }
  }
}

// Write one accumulator set as output frame yt (S x O) of the block's tile:
// as pairs where O is even (y starts 8-byte aligned), else one by one.
template <typename In>
__device__ __forceinline__ void store_frame(
    const float (&a)[m_tiles<In>()][kNT][4], In* yt, const Tile& q) {
#pragma unroll
  for (int i = 0; i < m_tiles<In>(); ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int o = q.o0 + q.wn * kWN + j * 8 + 2 * q.t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s =
            q.s0 + (q.wm * m_tiles<In>() + i) * 16 + q.g + 8 * h;
        if (s >= q.S) continue;
        In* const p = yt + static_cast<int64_t>(s) * q.O + o;
        const float v0 = a[i][j][2 * h], v1 = a[i][j][2 * h + 1];
        if (q.O % 2 == 0) {  // o is even, so o < O implies o + 1 < O
          if (o < q.O) put2(p, v0, v1);
        } else {
          if (o < q.O) put(p, v0);
          if (o + 1 < q.O) put(p + 1, v1);
        }
      }
    }
  }
}

// Frame tin has been multiplied in: output tin - 1 (set 2) is complete, and
// at the last frame output T-1 (set 1) too. Write them and rotate the sets.
template <typename In>
__device__ __forceinline__ void finish_frame(
    float (&acc)[3][m_tiles<In>()][kNT][4], In* yb, int64_t frame_out,
    int tin, int T, const Tile& q) {
  if (tin > 0) store_frame<In>(acc[2], yb + (tin - 1) * frame_out, q);
  if (tin == T - 1) store_frame<In>(acc[1], yb + tin * frame_out, q);
#pragma unroll
  for (int i = 0; i < m_tiles<In>(); ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[2][i][j][e] = acc[1][i][j][e];
        acc[1][i][j][e] = acc[0][i][j][e];
        acc[0][i][j][e] = 0.f;
      }
}

__device__ __forceinline__ Tile make_tile(int BM, int S, int C, int O) {
  Tile q;
  q.o0 = blockIdx.x * kBN;
  q.s0 = blockIdx.y * BM;
  q.tid = threadIdx.x;
  q.lane = q.tid & 31;
  q.wm = (q.tid >> 5) >> 1;
  q.wn = (q.tid >> 5) & 1;
  q.g = q.lane >> 2;
  q.t4 = q.lane & 3;
  q.S = S, q.C = C, q.O = O;
  return q;
}

template <typename In, int BM, bool kAligned, bool kLo>
__global__ void __launch_bounds__(threads_for<In>(BM))
temporal_conv_kernel(const In* __restrict__ x, const In* __restrict__ k,
                     const In* __restrict__ k_lo, In* __restrict__ y, int T,
                     int S, int C, int O) {
  using L = Layout<In, BM, kLo>;
  constexpr int kMT = m_tiles<In>();
  // k-steps of a chunk, all unrolled; but fp32 at 32 positions (64
  // threads, so up to 255 registers each) one at a time: unrolled, it spills
  constexpr int kUnroll =
      sizeof(In) == 4 && BM == 32 ? 1 : L::kBK / step_channels<In>();
  static_assert(kLo || sizeof(In) == 2, "fp32 taps come split in two");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  In* const smem = reinterpret_cast<In*>(smem_raw);

  const Tile q = make_tile(BM, S, C, O);
  const int nck = C > L::kBK ? (C + L::kBK - 1) / L::kBK : 1;  // per frame
  const int nchunks = T * nck;
  const int64_t frame_out = static_cast<int64_t>(S) * O;
  const In* const xb = x + static_cast<int64_t>(blockIdx.z) * T * S * C;
  In* const yb = y + static_cast<int64_t>(blockIdx.z) * T * frame_out;

  float acc[3][kMT][kNT][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][i][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nchunks)
      load_chunk<In, BM, kAligned, kLo>(smem, x, xb, k, k_lo, i, nck, q);
    cp_async_commit();
  }
  for (int i = 0; i < nchunks; ++i) {
    cp_async_wait<kStages - 2>();  // chunk i has landed (this thread's part)
    __syncthreads();  // ... everyone's; slot (i - 1) % kStages is free
    if (i + kStages - 1 < nchunks)
      load_chunk<In, BM, kAligned, kLo>(smem, x, xb, k, k_lo,
                                        i + kStages - 1, nck, q);
    cp_async_commit();
    const int tin = i / nck;
    const In* const xs = smem + (i % kStages) * L::kStageElems;
    multiply<In, kLo, kUnroll>(
        acc, xs, L::kXP, xs + L::kXElems, L::kBK * kKP, L::kKElems, L::kBK,
        tin < T - 1, tin > 0, q);
    if (i % nck == nck - 1)
      finish_frame<In>(acc, yb, frame_out, tin, T, q);
  }
  cp_async_wait<0>();
}

// Channels the resident kernel keeps per frame: C rounded up to a k-step.
template <typename In>
__host__ __device__ constexpr int padded_channels(int C) {
  constexpr int kS = step_channels<In>();
  return (C + kS - 1) / kS * kS;
}

// Shared memory of the resident kernel: all three taps (both arrays when
// kLo) for the block's 64 outputs, and kFrames x frames of BM positions.
template <typename In, bool kLo>
constexpr int resident_bytes(int BM, int C) {
  return (3 * padded_channels<In>(C) * kKP * (kLo ? 2 : 1) +
          kFrames * BM * (padded_channels<In>(C) + 16 / int(sizeof(In)))) *
         int(sizeof(In));
}

// The same function with the taps loaded once per block and kept in shared
// memory, and x staged a whole frame tile (BM contiguous rows of C) at a
// time, kFrames - 1 frames ahead: for C small enough that the taps fit.
template <typename In, int BM, bool kAligned, bool kLo>
__global__ void __launch_bounds__(threads_for<In>(BM))
temporal_conv_resident_kernel(const In* __restrict__ x,
                              const In* __restrict__ k,
                              const In* __restrict__ k_lo,
                              In* __restrict__ y, int T, int S, int C,
                              int O) {
  constexpr int kThreads = threads_for<In>(BM);
  constexpr int kPer = 16 / sizeof(In);  // elements per 16 bytes
  constexpr int kMT = m_tiles<In>();
  // k-steps unrolled: fp32's (three products each) one at a time, which
  // keeps its registers down
  constexpr int kUnroll = sizeof(In) == 2 ? 2 : 1;
  static_assert(kLo || sizeof(In) == 2, "fp32 taps come split in two");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  In* const taps = reinterpret_cast<In*>(smem_raw);
  const int cp = padded_channels<In>(C), xp = cp + kPer;
  const int kdt = cp * kKP, klo = 3 * kdt;  // tap and second-array strides
  In* const frames = taps + (kLo ? 2 : 1) * klo;
  const Tile q = make_tile(BM, S, C, O);
  const int64_t frame_in = static_cast<int64_t>(S) * C;
  const int64_t frame_out = static_cast<int64_t>(S) * O;
  const In* const xb = x + static_cast<int64_t>(blockIdx.z) * T * frame_in;
  In* const yb = y + static_cast<int64_t>(blockIdx.z) * T * frame_out;
  const int64_t tap = static_cast<int64_t>(C) * O;

  // the taps: rows (dt, c) for c < cp, the block's 64 outputs
  if constexpr (kAligned) {
    constexpr int kRow = kBN / kPer;
    for (int e = q.tid; e < 3 * cp * kRow; e += kThreads) {
      const int row = e / kRow, n = e % kRow * kPer, c = row % cp;
      const bool ok = c < C && q.o0 + n < O;
      const int64_t off = row / cp * tap + static_cast<int64_t>(c) * O +
                          q.o0 + n;
      cp_async16(taps + row * kKP + n, ok ? k + off : k, ok);
      if constexpr (kLo)
        cp_async16(taps + klo + row * kKP + n, ok ? k_lo + off : k_lo, ok);
    }
  } else {
    for (int e = q.tid; e < 3 * cp * kBN; e += kThreads) {
      const int row = e / kBN, n = e % kBN, c = row % cp;
      const bool ok = c < C && q.o0 + n < O;
      const int64_t off = row / cp * tap + static_cast<int64_t>(c) * O +
                          q.o0 + n;
      taps[row * kKP + n] = ok ? k[off] : zero<In>();
      if constexpr (kLo)
        taps[klo + row * kKP + n] = ok ? k_lo[off] : zero<In>();
    }
  }
  // x frame f (rows s0.., channels [0, cp)) into ring slot f % kFrames
  auto load_frame = [&](int f) {
    In* const xs = frames + (f % kFrames) * BM * xp;
    const In* const xt = xb + f * frame_in;
    if constexpr (kAligned) {
      const int row = cp / kPer;
      for (int e = q.tid; e < BM * row; e += kThreads) {
        const int r = e / row, c = e % row * kPer;
        const bool ok = q.s0 + r < S && c < C;
        cp_async16(xs + r * xp + c,
                   ok ? xt + static_cast<int64_t>(q.s0 + r) * C + c : x, ok);
      }
    } else {
      for (int e = q.tid; e < BM * cp; e += kThreads) {
        const int r = e / cp, c = e % cp;
        xs[r * xp + c] = (q.s0 + r < S && c < C)
                             ? xt[static_cast<int64_t>(q.s0 + r) * C + c]
                             : zero<In>();
      }
    }
  };

  float acc[3][kMT][kNT][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][i][j][e] = 0.f;

#pragma unroll
  for (int f = 0; f < kFrames - 1; ++f) {  // the taps go with frame 0
    if (f < T) load_frame(f);
    cp_async_commit();
  }
  for (int tin = 0; tin < T; ++tin) {
    cp_async_wait<kFrames - 2>();  // frame tin has landed (this thread's)
    __syncthreads();  // ... everyone's; slot (tin - 1) % kFrames is free
    if (tin + kFrames - 1 < T) load_frame(tin + kFrames - 1);
    cp_async_commit();
    multiply<In, kLo, kUnroll>(
        acc, frames + (tin % kFrames) * BM * xp, xp, taps, kdt, klo, cp,
        tin < T - 1, tin > 0, q);
    finish_frame<In>(acc, yb, frame_out, tin, T, q);
  }
  cp_async_wait<0>();
}

template <typename In, bool kAligned, bool kLo>
int launch_resident(const void* x, const void* k, const void* k_lo, void* y,
                    int B, int T, int S, int C, int O, cudaStream_t st) {
  constexpr int BM = 64;
  const int bytes = resident_bytes<In, kLo>(BM, C);
  auto kern = temporal_conv_resident_kernel<In, BM, kAligned, kLo>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((O + kBN - 1) / kBN, (S + BM - 1) / BM, B);
  kern<<<grid, threads_for<In>(BM), bytes, st>>>(
      static_cast<const In*>(x), static_cast<const In*>(k),
      static_cast<const In*>(k_lo), static_cast<In*>(y), T, S, C, O);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, int BM, bool kAligned, bool kLo>
int launch(const void* x, const void* k, const void* k_lo, void* y, int B,
           int T, int S, int C, int O, cudaStream_t st) {
  constexpr int kBytes = Layout<In, BM, kLo>::kBytes;
  auto kern = temporal_conv_kernel<In, BM, kAligned, kLo>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((O + kBN - 1) / kBN, (S + BM - 1) / BM, B);
  kern<<<grid, threads_for<In>(BM), kBytes, st>>>(
      static_cast<const In*>(x), static_cast<const In*>(k),
      static_cast<const In*>(k_lo), static_cast<In*>(y), T, S, C, O);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, int BM>
int launch_bm(const void* x, const void* k, const void* k_lo, void* y,
              int aligned, int B, int T, int S, int C, int O,
              cudaStream_t st) {
  if (k_lo != nullptr)
    return aligned
               ? launch<In, BM, true, true>(x, k, k_lo, y, B, T, S, C, O, st)
               : launch<In, BM, false, true>(x, k, k_lo, y, B, T, S, C, O, st);
  if constexpr (sizeof(In) == 2)
    return aligned
               ? launch<In, BM, true, false>(x, k, k_lo, y, B, T, S, C, O, st)
               : launch<In, BM, false, false>(x, k, k_lo, y, B, T, S, C, O,
                                              st);
  return static_cast<int>(cudaErrorInvalidValue);  // fp32 needs k_lo
}

template <typename In>
int launch_res(const void* x, const void* k, const void* k_lo, void* y,
               int aligned, int B, int T, int S, int C, int O,
               cudaStream_t st) {
  if (k_lo != nullptr)
    return aligned
               ? launch_resident<In, true, true>(x, k, k_lo, y, B, T, S, C, O,
                                                 st)
               : launch_resident<In, false, true>(x, k, k_lo, y, B, T, S, C,
                                                  O, st);
  if constexpr (sizeof(In) == 2)
    return aligned
               ? launch_resident<In, true, false>(x, k, k_lo, y, B, T, S, C,
                                                  O, st)
               : launch_resident<In, false, false>(x, k, k_lo, y, B, T, S,
                                                   C, O, st);
  return static_cast<int>(cudaErrorInvalidValue);  // fp32 needs k_lo
}

// Whether the resident kernel's shared memory fits in what a block may
// opt into on the current device (227 KB on an H100).
template <typename In>
bool fits_resident(bool two_arrays, int C) {
  int dev = 0, most = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return (two_arrays ? resident_bytes<In, true>(64, C)
                     : resident_bytes<In, false>(64, C)) <= most;
}

}  // namespace

// Positions per block (64 or 32) for B samples of S positions and O
// outputs: 64 unless that gives fewer blocks than the current device has
// SMs.
extern "C" int temporal_conv_tile_rows(int B, int S, int O) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int64_t blocks = static_cast<int64_t>(B) * ((S + 63) / 64) *
                         ((O + kBN - 1) / kBN);
  return blocks >= sms ? 64 : 32;
}

// Whether the kernel keeps the taps in shared memory (the resident kernel)
// for x in bf16 (x_bf16) or fp32 with one or two tap arrays: with 64
// positions per block, when the taps and two x frames fit in a block's
// shared memory.
extern "C" int temporal_conv_taps_resident(int x_bf16, int two_arrays,
                                           int B, int S, int C, int O) {
  if (temporal_conv_tile_rows(B, S, O) != 64) return 0;
  return x_bf16 ? fits_resident<__nv_bfloat16>(two_arrays, C)
                : fits_resident<float>(true, C);
}

// Plain C interface (loaded with ctypes). x (B,T,S,C) contiguous, fp32 or
// (x_bf16 != 0) bf16; k (3,C,O) and k_lo (3,C,O) contiguous in x's dtype:
// for fp32 x the TF32 split of the taps (k = TF32 hi, k_lo = TF32 lo), for
// bf16 x k_hi and k_lo of the bf16 split, or null; y (B,T,S,O)
// contiguous in x's dtype, 8-byte aligned. aligned != 0 only if C and O
// rows are 16-byte multiples and x, k, k_lo start on 16-byte boundaries.
// B, T, S, O >= 1, C >= 0, B <= 65535, ceil(S/32) <= 65535. Launches on
// `stream` without synchronising; returns the cudaError_t of the attribute
// call or launch.
extern "C" int temporal_conv_forward(const void* x, int x_bf16, const void* k,
                                     const void* k_lo, void* y, int aligned,
                                     int B, int T, int S, int C, int O,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (temporal_conv_taps_resident(x_bf16, k_lo != nullptr, B, S, C, O))
    return x_bf16 ? launch_res<__nv_bfloat16>(x, k, k_lo, y, aligned, B, T,
                                              S, C, O, st)
                  : launch_res<float>(x, k, k_lo, y, aligned, B, T, S, C, O,
                                      st);
  const bool wide = temporal_conv_tile_rows(B, S, O) == 64;
  if (x_bf16)
    return wide ? launch_bm<__nv_bfloat16, 64>(x, k, k_lo, y, aligned, B, T,
                                               S, C, O, st)
                : launch_bm<__nv_bfloat16, 32>(x, k, k_lo, y, aligned, B, T,
                                               S, C, O, st);
  return wide ? launch_bm<float, 64>(x, k, k_lo, y, aligned, B, T, S, C, O,
                                     st)
              : launch_bm<float, 32>(x, k, k_lo, y, aligned, B, T, S, C, O,
                                     st);
}

extern "C" const char* temporal_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
