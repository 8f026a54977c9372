// Fused pooling attention with decomposed relative positions and residual
// pooling (MViTv2), forward, on Hopper's tensor cores.
//
// Replaces no TPU kernel: the JAX package has no transformer trunk. It was
// added for the MViTv2 trunk (models/backbones/mvit.py), whose attention
// takes q, k and v already pooled and normed: per (clip, head), Lq query
// rows and Lk key rows of 96, each the class token then the spatial tokens
// in (t, h, w) order:
//
//   A = q.k^T * d^-1/2;  A[i, j] += q_i . (R_t[t_i, t_j] + R_h[h_i, h_j]
//                                          + R_w[w_i, w_j])  (i, j >= 1)
//   o = softmax(A) . v;  o[i] += q_i  (i >= 1)
//
// with R_a = table_a[idx_a[coordinate of i, coordinate of j]].
//
// What bounds it on an H100: per (clip, head) it reads q and writes o, Lq
// rows each, and reads k and v, Lk rows each (the tables are KBs); it does
// 4*Lq*Lk*d FLOP. At the trunk's first stage (Lq = 12,545, Lk = 257, one
// head) that is 256 FLOP a byte of q and o in bf16, against the card's
// ridge of ~295: a call sits at the balance point, 0.18-0.21 ms at batch
// 128 either way, and mma.sync reaches well under the bf16 peak. So the
// design keeps every logit in registers, moves nothing but q, k, v and o,
// and puts the positional terms on the tensor cores:
//  - q.R_a[idx_a(i, j)] = (q_i . table_a^T)[idx_a(i, j)]: each warp first
//    multiplies its 16 query rows by each axis's table (scaled by d^1/2 in
//    the wrapper, so the scale below applies to it too) with mma, parks
//    the 16 x rows_a products in shared memory and gathers, for each row,
//    the k_t + k_h + k_w <= 32 terms its keys need (the index rule is an
//    int table from the wrapper);
//  - those terms become two more k16 steps of q (an "augmented" q row of
//    96 + 32), and each key row in shared memory gets 32 more columns, a
//    one-hot of its three coordinates (none for the class token): q.k^T
//    over 128 columns is then the logit with its positional term, and no
//    per-logit gather is left in the softmax;
//  - a block of 8 warps takes 128 query rows of one (clip, head); k (rows,
//    plus the one-hot) and v (transposed) stream through shared memory in
//    chunks of 64 keys, read as fp32 or bf16 and stored in the compute
//    type; each warp walks them with the online (running max and sum)
//    softmax in exp2 (32 keys a step), log2 e folded into the scale; the
//    last step's n8 tiles are a template argument (257 = 8 x 32 + 1
//    multiplies one n8 tile there); 128 registers in bf16, so two blocks
//    share an SM and one stages its chunk while the other multiplies;
//  - the residual: q of the spatial rows added to o before its one
//    rounding, o written as (clip, Lq, heads*d), the heads side by side;
//  - bf16 compute: both products with mma.m16n8k16 (fp32 sums), P rounded
//    to bf16 for the second, as flash attention does (the input may be
//    fp32, as the pooling norms give it under autocast: it is rounded once
//    where it is loaded); fp32: 3xTF32 on mma.m16n8k8 (hi = rna.tf32(v),
//    lo = rna.tf32(v - hi); lo*hi + hi*lo + hi*hi), the P . V product
//    taking P's accumulator fragment as its A fragment as in
//    csrc/window_attn.cu;
//  - row pitches: k 136 (bf16) / 132 (fp32) elements, v^T 72, which keep
//    the fragment loads free of bank conflicts.
// The Lq x Lk logits and the positional terms never reach device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHD = 96;          // head width
constexpr int kRel = 32;         // positional columns (k_t + k_h + k_w)
constexpr int kAug = kHD + kRel;  // q.k^T columns with the one-hot
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows a block
constexpr int kKB = 64;          // keys a chunk
constexpr int kSub = 32;         // keys a step of the online softmax
constexpr int kVP = kKB + 8;     // v^T row pitch
constexpr int kTabMax = 64;      // rows of one axis's table, at most

template <typename T>
struct Layout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kKP = kBf16 ? kAug + 8 : kAug + 4;  // k row pitch
  static constexpr int kMinBlocks = kBf16 ? 2 : 1;  // 128 registers in bf16
  // k [kKB][kKP], v^T [kHD][kVP] in T; each warp's table products
  // [16][kTabMax] fp32
  __host__ __device__ static constexpr int bytes() {
    return kKB * kKP * static_cast<int>(sizeof(T)) +
           kHD * kVP * static_cast<int>(sizeof(T)) + kWarps * 16 * kTabMax * 4;
  }
};

template <typename Tin, typename T>
struct Params {
  const Tin *q_cls, *q_sp, *k_cls, *k_sp, *v_cls, *v_sp;  // (N, d), (N, S, d)
  const T* tab;     // (axes' rows, each rounded up to 8, d), times d^1/2
  const int* idx;   // idx_t (qt, kt), idx_h (qh, kh), idx_w (qw, kw)
  T* out;           // (N / heads, Lq, heads * d)
  float scale;      // d^-1/2 * log2 e
  int heads, Lq, Lk, qt, qh, qw, kt, kh, kw, rows_t, rows_h, rows_w;
};

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

// hi*hi + hi*lo + lo*hi of one k8 step, a and b raw fp32
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const float (&a)[4],
                                           float b0, float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[e], al[e]);
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ float exp2_approx(float x) {  // 2^-inf = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// two consecutive elements of a row as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(
      __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// eight consecutive elements (16-byte aligned) as floats
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *(reinterpret_cast<float4*>(p) + 1) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }

__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

// The augmented q of one m16 tile as A fragments, and the table products:
// bf16 eight k16 steps (six of q, two of positional terms); fp32 sixteen
// k8 steps kept raw and split where they are used.
template <typename T>
struct QFrag;

template <>
struct QFrag<__nv_bfloat16> {
  static constexpr int kSteps = kHD / 16;
  uint32_t a[kAug / 16][4];
  template <typename Tin>
  __device__ void load(const Tin* q0, const Tin* q1, int t4) {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int c = ks * 16 + 2 * t4;
      float2 v = load2(q0 + c);
      a[ks][0] = pack_bf16(v.x, v.y);
      v = load2(q1 + c);
      a[ks][1] = pack_bf16(v.x, v.y);
      v = load2(q0 + c + 8);
      a[ks][2] = pack_bf16(v.x, v.y);
      v = load2(q1 + c + 8);
      a[ks][3] = pack_bf16(v.x, v.y);
    }
  }
  // slot j of 8 (two columns a register) -> its positional column
  __device__ static int rel_col(int j, int t4) {
    return 2 * t4 + (j & 1) + 8 * (j >> 1);
  }
  __device__ void set_rel(const float (&rv)[2][8]) {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[kSteps + s][h] = pack_bf16(rv[h][4 * s], rv[h][4 * s + 1]);
        a[kSteps + s][2 + h] = pack_bf16(rv[h][4 * s + 2], rv[h][4 * s + 3]);
      }
  }
  // d += q . rows of `b` (row-major, pitch `ld`) for the n8 tile at b:
  // columns k of q against b[g][k], q's own columns only
  __device__ void mul_rows(float (&d)[4], const __nv_bfloat16* b, int ld,
                           int g, int t4) const {
    const __nv_bfloat16* r = b + g * ld + 2 * t4;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const uint32_t b0 = __ldg(reinterpret_cast<const unsigned int*>(
          r + ks * 16));
      const uint32_t b1 = __ldg(reinterpret_cast<const unsigned int*>(
          r + ks * 16 + 8));
      mma_bf16(d, a[ks], b0, b1);
    }
  }
  // d = augmented q . k^T for the n8 tile of keys at kr (shared memory)
  __device__ void qk(float (&d)[4], const __nv_bfloat16* kr) const {
#pragma unroll
    for (int ks = 0; ks < kAug / 16; ++ks) {
      const uint32_t* b = reinterpret_cast<const uint32_t*>(kr + ks * 16);
      mma_bf16(d, a[ks], b[0], b[4]);
    }
  }
};

template <>
struct QFrag<float> {
  static constexpr int kSteps = kHD / 8;
  float a[kAug / 8][4];
  template <typename Tin>
  __device__ void load(const Tin* q0, const Tin* q1, int t4) {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int c = ks * 8 + t4;
      a[ks][0] = static_cast<float>(q0[c]);
      a[ks][1] = static_cast<float>(q1[c]);
      a[ks][2] = static_cast<float>(q0[c + 4]);
      a[ks][3] = static_cast<float>(q1[c + 4]);
    }
  }
  __device__ static int rel_col(int j, int t4) { return t4 + 4 * j; }
  __device__ void set_rel(const float (&rv)[2][8]) {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[kSteps + s][h] = rv[h][2 * s];
        a[kSteps + s][2 + h] = rv[h][2 * s + 1];
      }
  }
  __device__ void mul_rows(float (&d)[4], const float* b, int ld, int g,
                           int t4) const {
    const float* r = b + g * ld + t4;
    // the fp32 path (tests, fp32 training) is not tuned: its k steps stay
    // rolled, which keeps its build to seconds (unrolled: 35 s of ptxas)
#pragma unroll 1
    for (int ks = 0; ks < kSteps; ++ks)
      mma_3xtf32(d, a[ks], __ldg(r + ks * 8), __ldg(r + ks * 8 + 4));
  }
  __device__ void qk(float (&d)[4], const float* kr) const {
#pragma unroll 1
    for (int ks = 0; ks < kAug / 8; ++ks)
      mma_3xtf32(d, a[ks], kr[ks * 8], kr[ks * 8 + 4]);
  }
};

// o[dn] += P . v over the keys of the chunk from key0 (P in s, fp32)
template <int NT>
__device__ __forceinline__ void pv(float (&o)[kHD / 8][4],
                                   const float (&s)[NT][4],
                                   const __nv_bfloat16* vt, int key0, int g,
                                   int t4) {
#pragma unroll
  for (int kk = 0; kk < (NT + 1) / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    if (2 * kk + 1 < NT) {
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    } else {
      a[2] = a[3] = 0u;
    }
#pragma unroll
    for (int dn = 0; dn < kHD / 8; ++dn) {
      const uint32_t* b = reinterpret_cast<const uint32_t*>(
          vt + (dn * 8 + g) * kVP + key0 + kk * 16 + 2 * t4);
      mma_bf16(o[dn], a, b[0], b[4]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void pv(float (&o)[kHD / 8][4],
                                   const float (&s)[NT][4], const float* vt,
                                   int key0, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    // A's k index t is key 2t, t + 4 is key 2t + 1: the accumulator's own
    const float a[4] = {s[nt][0], s[nt][2], s[nt][1], s[nt][3]};
#pragma unroll
    for (int dn = 0; dn < kHD / 8; ++dn) {
      const float2 b = *reinterpret_cast<const float2*>(
          vt + (dn * 8 + g) * kVP + key0 + nt * 8 + 2 * t4);
      mma_3xtf32(o[dn], a, b.x, b.y);
    }
  }
}

// the running state of rows g and g + 8 of one m16 tile
struct Rows {
  float m[2], l[2];  // running max (log2 units), this thread's partial sums
  float o[kHD / 8][4];
};

// one block of NT n8 tiles of keys from key0 of the chunk; kTail: keys at
// or past `valid` masked
template <typename T, int NT, bool kTail>
__device__ __forceinline__ void key_block(Rows& r, const QFrag<T>& q,
                                          const T* ks, const T* vt,
                                          float scale, int key0, int valid,
                                          int g, int t4) {
  constexpr int kKP = Layout<T>::kKP;
  float s[NT][4];
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    q.qk(s[nt], ks + (key0 + nt * 8 + g) * kKP +
                    (Layout<T>::kBf16 ? 2 * t4 : t4));
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = key0 + nt * 8 + 2 * t4 + c;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g, g + 8
        float v = s[nt][2 * h + c] * scale;
        if (kTail && j >= valid) v = -INFINITY;
        s[nt][2 * h + c] = v;
        mx[h] = fmaxf(mx[h], v);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(r.m[h], quad_max(mx[h]));
    const float alpha = exp2_approx(r.m[h] - mn);
    r.m[h] = mn;
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][2 * h] = exp2_approx(s[nt][2 * h] - mn);
      s[nt][2 * h + 1] = exp2_approx(s[nt][2 * h + 1] - mn);
      sum += s[nt][2 * h] + s[nt][2 * h + 1];
    }
    r.l[h] = r.l[h] * alpha + sum;
#pragma unroll
    for (int dn = 0; dn < kHD / 8; ++dn) {
      r.o[dn][2 * h] *= alpha;
      r.o[dn][2 * h + 1] *= alpha;
    }
  }
  pv<NT>(r.o, s, vt, key0, g, t4);
}

template <typename T, int NT>
__device__ __forceinline__ void tail_block(Rows& r, const QFrag<T>& q,
                                           const T* ks, const T* vt,
                                           float scale, int key0, int valid,
                                           int tiles, int g, int t4) {
  if constexpr (NT > 1) {
    if (tiles < NT) {
      tail_block<T, NT - 1>(r, q, ks, vt, scale, key0, valid, tiles, g, t4);
      return;
    }
  }
  key_block<T, NT, true>(r, q, ks, vt, scale, key0, valid, g, t4);
}

// the positional terms of this thread's rows and slots, one axis at a time:
// the tile's products with the axis's table parked in `park` (16 x rows,
// this warp's own), each slot's term gathered where its column is the
// axis's
template <typename T, typename Tin>
__device__ __forceinline__ void positional(QFrag<T>& q,
                                           const Params<Tin, T>& p,
                                           float* park, int row0, int row1,
                                           int g, int t4) {
  float rv[2][8];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) rv[h][j] = 0.f;
  const int rows[3] = {p.rows_t, p.rows_h, p.rows_w};
  const int ks[3] = {p.kt, p.kh, p.kw};
  int coord[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = (h ? row1 : row0) - 1;  // the class token's row: s = -1
    coord[h][0] = s / (p.qh * p.qw);
    coord[h][1] = (s / p.qw) % p.qh;
    coord[h][2] = s % p.qw;
  }
  const int* idx = p.idx;
  const T* tab = p.tab;
  int col0 = 0;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int n8 = (rows[ax] + 7) / 8;
    for (int nt = 0; nt < n8; ++nt) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      q.mul_rows(d, tab + nt * 8 * kHD, kHD, g, t4);
      const int c = nt * 8 + 2 * t4;
      park[g * kTabMax + c] = d[0];
      park[g * kTabMax + c + 1] = d[1];
      park[(g + 8) * kTabMax + c] = d[2];
      park[(g + 8) * kTabMax + c + 1] = d[3];
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if ((h ? row1 : row0) == 0) continue;  // the class token: none
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = QFrag<T>::rel_col(j, t4) - col0;
        if (k >= 0 && k < ks[ax])
          rv[h][j] = park[(g + 8 * h) * kTabMax +
                          __ldg(idx + coord[h][ax] * ks[ax] + k)];
      }
    }
    __syncwarp();  // the next axis's products overwrite the park
    tab += n8 * 8 * kHD;
    idx += (ax == 0 ? p.qt : ax == 1 ? p.qh : p.qw) * ks[ax];
    col0 += ks[ax];
  }
  q.set_rel(rv);
}

template <typename Tin, typename T>
__global__ void __launch_bounds__(kThreads, Layout<T>::kMinBlocks)
    pool_attn_kernel(const Params<Tin, T> p) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vt = ks + kKB * L::kKP;
  float* park = reinterpret_cast<float*>(vt + kHD * kVP);
  const int n = blockIdx.y;  // clip * heads + head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int sq = p.Lq - 1, sk = p.Lk - 1;
  const int tile0 = blockIdx.x * kRows + warp * 16;
  const bool active = tile0 < p.Lq;  // warp-uniform
  const int r0 = tile0 + g, r1 = r0 + 8;
  const int i0 = min(r0, p.Lq - 1), i1 = min(r1, p.Lq - 1);

  auto q_row = [&](int i) {
    return i == 0 ? p.q_cls + static_cast<int64_t>(n) * kHD
                  : p.q_sp + (static_cast<int64_t>(n) * sq + i - 1) * kHD;
  };

  QFrag<T> q;
  Rows r;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r.m[h] = -INFINITY;
    r.l[h] = 0.f;
  }
#pragma unroll
  for (int dn = 0; dn < kHD / 8; ++dn)
    r.o[dn][0] = r.o[dn][1] = r.o[dn][2] = r.o[dn][3] = 0.f;
  if (active) {
    q.load(q_row(i0), q_row(i1), t4);
    positional<T, Tin>(q, p, park + warp * 16 * kTabMax, i0, i1, g, t4);
  }

  for (int key0 = 0; key0 < p.Lk; key0 += kKB) {
    __syncthreads();  // the previous chunk is spent
    // k as rows (plus the one-hot of its coordinates), v transposed;
    // zeros past Lk
    // a warp's lanes take consecutive keys: the column stores of v^T then
    // fall in distinct banks
    constexpr int kChunks = kHD / 8;
    for (int it = tid; it < kKB * kChunks; it += kThreads) {
      const int j = it % kKB, c = (it / kKB) * 8;
      const int key = key0 + j;
      float kv[8], vv[8];
      if (key < p.Lk) {
        const int64_t row = key == 0
                                ? static_cast<int64_t>(n) * kHD
                                : (static_cast<int64_t>(n) * sk + key - 1) *
                                      kHD;
        load8((key == 0 ? p.k_cls : p.k_sp) + row + c, kv);
        load8((key == 0 ? p.v_cls : p.v_sp) + row + c, vv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = vv[e] = 0.f;
      }
      store8(ks + j * L::kKP + c, kv);
#pragma unroll
      for (int e = 0; e < 8; ++e) store_elem(vt + (c + e) * kVP + j, vv[e]);
    }
    for (int it = tid; it < kKB * (kRel / 8); it += kThreads) {
      const int j = it % kKB, c = (it / kKB) * 8;
      const int key = key0 + j;
      int ct = -1, ch = -1, cw = -1;
      if (key >= 1 && key < p.Lk) {
        const int s = key - 1;
        ct = s / (p.kh * p.kw);
        ch = p.kt + (s / p.kw) % p.kh;
        cw = p.kt + p.kh + s % p.kw;
      }
      float hot[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = c + e;
        hot[e] = (col == ct || col == ch || col == cw) ? 1.f : 0.f;
      }
      store8(ks + j * L::kKP + kHD + c, hot);
    }
    __syncthreads();

    if (active) {
      const int valid = min(kKB, p.Lk - key0);
      for (int sub = 0; sub < valid; sub += kSub) {
        if (valid - sub >= kSub)
          key_block<T, kSub / 8, false>(r, q, ks, vt, p.scale, sub, valid, g,
                                        t4);
        else
          tail_block<T, kSub / 8>(r, q, ks, vt, p.scale, sub, valid,
                                  (valid - sub + 7) / 8, g, t4);
      }
    }
  }

  if (!active) return;
  const int b = n / p.heads, head = n % p.heads;
  const int c_out = p.heads * kHD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / quad_sum(r.l[h]);  // every lane of the warp
    const int row = h ? r1 : r0;
    if (row >= p.Lq) continue;
    T* o = p.out + (static_cast<int64_t>(b) * p.Lq + row) * c_out +
           head * kHD + 2 * t4;
    const Tin* res = q_row(row) + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < kHD / 8; ++dn) {
      float2 add = make_float2(0.f, 0.f);
      if (row > 0) add = load2(res + dn * 8);  // the residual pooling
      store2(o + dn * 8, fmaf(r.o[dn][2 * h], inv, add.x),
             fmaf(r.o[dn][2 * h + 1], inv, add.y));
    }
  }
}

template <typename Tin, typename T>
int launch(const Params<Tin, T>& p, int N, cudaStream_t st) {
  const int smem = Layout<T>::bytes();
  auto kernel = pool_attn_kernel<Tin, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.Lq + kRows - 1) / kRows, N);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, typename T>
int forward(const void* const* qkv, const void* tab, const int* idx,
            void* out, float scale, const int* sizes, cudaStream_t st) {
  const Params<Tin, T> p{
      static_cast<const Tin*>(qkv[0]), static_cast<const Tin*>(qkv[1]),
      static_cast<const Tin*>(qkv[2]), static_cast<const Tin*>(qkv[3]),
      static_cast<const Tin*>(qkv[4]), static_cast<const Tin*>(qkv[5]),
      static_cast<const T*>(tab), idx, static_cast<T*>(out), scale,
      sizes[1], sizes[2], sizes[3], sizes[4], sizes[5], sizes[6], sizes[7],
      sizes[8], sizes[9], sizes[10], sizes[11], sizes[12]};
  return launch<Tin, T>(p, sizes[0], st);
}

}  // namespace

// Dynamic shared memory of one block, bf16 (bf16 != 0) or fp32 compute.
extern "C" int pool_attn_smem_bytes(int bf16) {
  return bf16 ? Layout<__nv_bfloat16>::bytes() : Layout<float>::bytes();
}

// Plain C interface (loaded with ctypes). qkv: six pointers, q_cls, q_sp,
// k_cls, k_sp, v_cls, v_sp, contiguous, (N, 96) and (N, S, 96), bf16 if
// `in_bf16` is 1, fp32 if 0, 16-byte aligned. Compute in bf16 if
// `compute_bf16` is 1 (fp32 or bf16 input), else fp32 (fp32 input); `tab`
// and `out` are in the compute type: tab (rows_t, rows_h, rows_w each
// rounded up to 8, 96) the three tables times 96^1/2, zeros in the
// rounding; idx int32 idx_t (qt, kt), idx_h (qh, kh), idx_w (qw, kw), each
// a row of its own table; out (N / heads, Lq, heads * 96). sizes: N, heads,
// Lq, Lk, qt, qh, qw, kt, kh, kw, rows_t, rows_h, rows_w. Launches on
// `stream` without synchronising; returns the cudaError_t of the attribute
// call or the launch.
extern "C" int pool_attn_forward(const void* const* qkv, const void* tab,
                                 const int* idx, void* out, int in_bf16,
                                 int compute_bf16, float scale,
                                 const int* sizes, void* stream) {
  const int N = sizes[0], heads = sizes[1], Lq = sizes[2], Lk = sizes[3];
  const int kt = sizes[7], kh = sizes[8], kw = sizes[9];
  if (N < 1 || N > 65535 || heads < 1 || N % heads || Lq < 2 || Lk < 2 ||
      kt + kh + kw > kRel || sizes[10] > kTabMax || sizes[11] > kTabMax ||
      sizes[12] > kTabMax || sizes[4] * sizes[5] * sizes[6] != Lq - 1 ||
      kt * kh * kw != Lk - 1 || (in_bf16 && !compute_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!compute_bf16)
    return forward<float, float>(qkv, tab, idx, out, scale, sizes, st);
  return in_bf16 ? forward<__nv_bfloat16, __nv_bfloat16>(qkv, tab, idx, out,
                                                         scale, sizes, st)
                 : forward<float, __nv_bfloat16>(qkv, tab, idx, out, scale,
                                                 sizes, st);
}

extern "C" const char* pool_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
