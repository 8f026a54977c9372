// Fused shifted-window 3-D attention with a relative-position bias (Video
// Swin), forward, on Hopper's tensor cores.
//
// Replaces no TPU kernel: the JAX package has no transformer trunk. It was
// added for the Video Swin trunk (models/backbones/swin3d.py), whose
// attention runs in windows of N = 8x7x7 = 392 tokens with 32-wide heads.
// For each (window, head) of the volume rolled by -shift:
//
//   o = softmax(q.k^T * d^-1/2 + B + M) . v
//
// with B[i, j] = table[c0 + pos[i] - pos[j], head] (pos places a window
// index in the module's window, so c0 + pos[i] - pos[j] is the pair's
// relative-position index) and M[i, j] = -100 where the two tokens came
// from different regions of the rolled volume (shifted blocks only).
//
// What bounds it on an H100: per (window, head) it moves q, k, v and o,
// 4*N*d elements (100 KB in bf16), and does 4*N^2*d FLOP (19.7 MFLOP) and
// N^2 exponentials: 0.49 ms of bytes for a stage-1 call at batch 128 in
// bf16, against 0.33 ms of products at the bf16 peak; but the N^2
// exponentials (16 a clock on an SM) and the per-logit softmax arithmetic
// (~8 instructions) take ~10k SM clocks a pair, ~0.7 ms for the same call.
// So the design keeps every logit in registers, spends as few
// instructions a logit as it can, and moves nothing but q, k, v and o:
//  - a block of 5 warps takes one head of up to 4 windows in turn; for
//    each it stages the window's k (rows) and v (transposed) in shared
//    memory, read where qkv (B, T, H, W, 3C) holds them through int32
//    token tables (the roll and the window partition are addressing, not
//    copies), zero rows past N;
//  - each warp takes 16 queries at a time (392 = 25 m16 tiles, five a
//    warp), q in registers, and walks the keys in blocks of 64 with the
//    online (running max and sum) softmax, exp2 with log2 e folded into
//    the scale and the table; the last block's n8 tiles are a template
//    argument, so 392 = 6 x 64 + 8 multiplies one n8 tile there;
//  - the bias is gathered from the head's table column, staged in shared
//    memory once a block (10 KB, log2 e folded in by the wrapper), at
//    c0 + pos[i] - pos[j]; pos[j] and the region label of each key share
//    one int (pos | label << 16), so a logit costs one shared load for
//    its bias and none for its mask beyond the key's word;
//  - bf16: both products with mma.m16n8k16 (fp32 sums), P rounded to bf16
//    for the second, as flash attention does; fp32: 3xTF32 on
//    mma.m16n8k8 (hi = rna.tf32(v), lo = rna.tf32(v - hi); lo*hi + hi*lo
//    + hi*hi), which keeps fp32 accuracy at K = 32 and 64-key blocks. The
//    P . V product takes P's accumulator fragment as its A fragment: in
//    bf16 the layouts agree; in fp32 the k index t of an A fragment is
//    read as key 2t and t + 4 as key 2t + 1, and v's B fragment is read in
//    the same key order (two adjacent keys of the transposed v), so no
//    shuffle is needed;
//  - row pitches: k 40 (bf16) / 36 (fp32) elements, v^T N rounded up to
//    16 plus 8, which keep the fragment loads free of bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHD = 32;        // head width
constexpr int kWarps = 5;      // 25 m16 tiles of 392 queries, five a warp
constexpr int kThreads = kWarps * 32;
constexpr int kKB = 64;        // keys a block of the online softmax
constexpr int kWinPerCta = 4;  // windows of one head a block takes in turn

template <typename T>
struct Layout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kKP = kBf16 ? kHD + 8 : kHD + 4;  // k row pitch
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // a uint4
  static constexpr int kMinBlocks = kBf16 ? 3 : 1;
  __host__ __device__ static int npad(int n) { return (n + 15) / 16 * 16; }
  __host__ __device__ static int vpitch(int n) { return npad(n) + 8; }
  // k [npad][kKP], v^T [kHD][vpitch], pos|label [npad], the table column
  __host__ __device__ static int bytes(int n, int rows) {
    return npad(n) * kKP * static_cast<int>(sizeof(T)) +
           kHD * vpitch(n) * static_cast<int>(sizeof(T)) + npad(n) * 4 +
           rows * 4;
  }
};

template <typename T>
struct Params {
  const T* qkv;        // (B, T, H, W, 3C)
  T* out;              // (B, T, H, W, C)
  const float* tbl;    // (heads, rows), times log2 e
  const int* tok;      // (windows, N): token of each window position
  const int* pos;      // (N,): place in the module's window
  const int* lab;      // (windows, N): region in the rolled volume
  float qk_scale;      // d^-1/2 * log2 e
  float mask_value;    // -100 * log2 e
  int clip, C, heads, N, NW, NBW, rows, c0;
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

// q of one m16 tile as A fragments: bf16 two k16 steps, fp32 four k8
// steps split into hi and lo
template <typename T>
struct QFrag;

template <>
struct QFrag<__nv_bfloat16> {
  uint32_t a[kHD / 16][4];
  __device__ void load(const __nv_bfloat16* q0, const __nv_bfloat16* q1,
                       int t4) {
#pragma unroll
    for (int ks = 0; ks < kHD / 16; ++ks) {
      const int c = ks * 16 + 2 * t4;
      a[ks][0] = *reinterpret_cast<const uint32_t*>(q0 + c);
      a[ks][1] = *reinterpret_cast<const uint32_t*>(q1 + c);
      a[ks][2] = *reinterpret_cast<const uint32_t*>(q0 + c + 8);
      a[ks][3] = *reinterpret_cast<const uint32_t*>(q1 + c + 8);
    }
  }
};

template <>
struct QFrag<float> {
  uint32_t hi[kHD / 8][4], lo[kHD / 8][4];
  __device__ void load(const float* q0, const float* q1, int t4) {
#pragma unroll
    for (int ks = 0; ks < kHD / 8; ++ks) {
      const int c = ks * 8 + t4;
      split_tf32(q0[c], hi[ks][0], lo[ks][0]);
      split_tf32(q1[c], hi[ks][1], lo[ks][1]);
      split_tf32(q0[c + 4], hi[ks][2], lo[ks][2]);
      split_tf32(q1[c + 4], hi[ks][3], lo[ks][3]);
    }
  }
};

// s[nt] = q . k^T over the n8 tile nt of keys key0.. (rows g, g + 8)
template <int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4],
                                   const QFrag<__nv_bfloat16>& q,
                                   const __nv_bfloat16* ks, int key0, int g,
                                   int t4) {
  constexpr int kKP = Layout<__nv_bfloat16>::kKP;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* kr = ks + (key0 + nt * 8 + g) * kKP + 2 * t4;
#pragma unroll
    for (int k = 0; k < kHD / 16; ++k) {
      const uint32_t* b = reinterpret_cast<const uint32_t*>(kr + k * 16);
      mma_bf16(s[nt], q.a[k], b[0], b[4]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], const QFrag<float>& q,
                                   const float* ks, int key0, int g, int t4) {
  constexpr int kKP = Layout<float>::kKP;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const float* kr = ks + (key0 + nt * 8 + g) * kKP + t4;
#pragma unroll
    for (int k = 0; k < kHD / 8; ++k) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(kr[k * 8], bh0, bl0);
      split_tf32(kr[k * 8 + 4], bh1, bl1);
      mma_tf32(s[nt], q.lo[k], bh0, bh1);
      mma_tf32(s[nt], q.hi[k], bl0, bl1);
      mma_tf32(s[nt], q.hi[k], bh0, bh1);
    }
  }
}

// o[dn] += P . v over the keys of the block (P in s, fp32)
template <int NT>
__device__ __forceinline__ void pv(float (&o)[kHD / 8][4],
                                   const float (&s)[NT][4],
                                   const __nv_bfloat16* vt, int vp, int key0,
                                   int g, int t4) {
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
          vt + (dn * 8 + g) * vp + key0 + kk * 16 + 2 * t4);
      mma_bf16(o[dn], a, b[0], b[4]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void pv(float (&o)[kHD / 8][4],
                                   const float (&s)[NT][4], const float* vt,
                                   int vp, int key0, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    // A's k index t is key 2t, t + 4 is key 2t + 1: the accumulator's own
    uint32_t ah[4], al[4];
    split_tf32(s[nt][0], ah[0], al[0]);
    split_tf32(s[nt][2], ah[1], al[1]);
    split_tf32(s[nt][1], ah[2], al[2]);
    split_tf32(s[nt][3], ah[3], al[3]);
#pragma unroll
    for (int dn = 0; dn < kHD / 8; ++dn) {
      const float2 b = *reinterpret_cast<const float2*>(
          vt + (dn * 8 + g) * vp + key0 + nt * 8 + 2 * t4);
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(b.x, bh0, bl0);
      split_tf32(b.y, bh1, bl1);
      mma_tf32(o[dn], al, bh0, bh1);
      mma_tf32(o[dn], ah, bl0, bl1);
      mma_tf32(o[dn], ah, bh0, bh1);
    }
  }
}

// the running state of rows g and g + 8 of one m16 tile
struct Rows {
  float m[2], l[2];  // running max (log2 units), this thread's partial sums
  float o[kHD / 8][4];
  int bias[2], lab[2];  // c0 + pos[i], region of the row
};

// one block of NT n8 tiles of keys from key0; kTail: keys past N masked
template <typename T, bool kShifted, int NT, bool kTail>
__device__ __forceinline__ void key_block(Rows& r, const QFrag<T>& q,
                                          const T* ks, const T* vt, int vp,
                                          const int* posl, const float* tbl,
                                          const Params<T>& p, int key0, int g,
                                          int t4) {
  float s[NT][4];
  qk<NT>(s, q, ks, key0, g, t4);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = key0 + nt * 8 + 2 * t4 + c;
      const int pl = posl[j];
      const int pj = pl & 0xffff;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g, g + 8
        float v = fmaf(s[nt][2 * h + c], p.qk_scale, tbl[r.bias[h] - pj]);
        if (kShifted && (pl >> 16) != r.lab[h]) v += p.mask_value;
        if (kTail && j >= p.N) v = -INFINITY;
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
  pv<NT>(r.o, s, vt, vp, key0, g, t4);
}

template <typename T, bool kShifted, int NT>
__device__ __forceinline__ void tail_block(Rows& r, const QFrag<T>& q,
                                           const T* ks, const T* vt, int vp,
                                           const int* posl, const float* tbl,
                                           const Params<T>& p, int key0,
                                           int tiles, int g, int t4) {
  if constexpr (NT > 1) {
    if (tiles < NT) {
      tail_block<T, kShifted, NT - 1>(r, q, ks, vt, vp, posl, tbl, p, key0,
                                      tiles, g, t4);
      return;
    }
  }
  key_block<T, kShifted, NT, true>(r, q, ks, vt, vp, posl, tbl, p, key0, g,
                                   t4);
}

// the 8 bf16 (4 fp32) elements of v as a column of v^T
__device__ __forceinline__ void store_column(__nv_bfloat16* vt, int vp,
                                             const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  unsigned short* dst = reinterpret_cast<unsigned short*>(vt);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e * vp] = static_cast<unsigned short>(w[e >> 1] >> (16 * (e & 1)));
}
__device__ __forceinline__ void store_column(float* vt, int vp,
                                             const uint4& v) {
  vt[0] = __uint_as_float(v.x);
  vt[vp] = __uint_as_float(v.y);
  vt[2 * vp] = __uint_as_float(v.z);
  vt[3 * vp] = __uint_as_float(v.w);
}

__device__ __forceinline__ void store2(__nv_bfloat16* o, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

template <typename T, bool kShifted>
__global__ void __launch_bounds__(kThreads, Layout<T>::kMinBlocks)
    window_attn_kernel(const Params<T> p) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int npad = L::npad(p.N), vp = L::vpitch(p.N);
  T* ks = reinterpret_cast<T*>(smem);
  T* vt = ks + npad * L::kKP;
  int* posl = reinterpret_cast<int*>(vt + kHD * vp);
  float* tbl = reinterpret_cast<float*>(posl + npad);
  const int head = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c3 = 3 * p.C, col0 = head * kHD;

  for (int i = tid; i < p.rows; i += kThreads)
    tbl[i] = p.tbl[static_cast<int64_t>(head) * p.rows + i];

  const int first = blockIdx.x * kWinPerCta;
  const int last = min(first + kWinPerCta, p.NBW);
  for (int bw = first; bw < last; ++bw) {
    const int wi = bw % p.NW;
    const int64_t base = static_cast<int64_t>(bw / p.NW) * p.clip;
    const int* tok = p.tok + static_cast<int64_t>(wi) * p.N;
    __syncthreads();  // the previous window's k, v and labels are spent
    // k as rows, v transposed, 16 bytes a thread a step; zeros past N
    constexpr int kChunks = kHD / L::kVec;
    for (int idx = tid; idx < npad * kChunks; idx += kThreads) {
      const int j = idx / kChunks, c = (idx % kChunks) * L::kVec;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j < p.N) {
        const T* row = p.qkv + (base + tok[j]) * c3 + col0 + c;
        kv = __ldg(reinterpret_cast<const uint4*>(row + p.C));
        vv = __ldg(reinterpret_cast<const uint4*>(row + 2 * p.C));
      }
      *reinterpret_cast<uint4*>(ks + j * L::kKP + c) = kv;
      store_column(vt + c * vp + j, vp, vv);
    }
    for (int j = tid; j < npad; j += kThreads) {
      int pl = 0;
      if (j < p.N) {
        pl = p.pos[j];
        if (kShifted) pl |= p.lab[static_cast<int64_t>(wi) * p.N + j] << 16;
      }
      posl[j] = pl;
    }
    __syncthreads();

    for (int mt = warp; mt * 16 < p.N; mt += kWarps) {
      const int r0 = mt * 16 + g, r1 = r0 + 8;
      const int i0 = min(r0, p.N - 1), i1 = min(r1, p.N - 1);
      Rows r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pl = posl[h ? i1 : i0];
        r.m[h] = -INFINITY;
        r.l[h] = 0.f;
        r.bias[h] = p.c0 + (pl & 0xffff);
        r.lab[h] = pl >> 16;
      }
#pragma unroll
      for (int dn = 0; dn < kHD / 8; ++dn)
        r.o[dn][0] = r.o[dn][1] = r.o[dn][2] = r.o[dn][3] = 0.f;
      const int64_t row0 = base + tok[i0], row1 = base + tok[i1];
      QFrag<T> q;
      q.load(p.qkv + row0 * c3 + col0, p.qkv + row1 * c3 + col0, t4);

      const int full = p.N / kKB;
      for (int kb = 0; kb < full; ++kb)
        key_block<T, kShifted, kKB / 8, false>(r, q, ks, vt, vp, posl, tbl,
                                               p, kb * kKB, g, t4);
      const int rest = p.N - full * kKB;
      if (rest)
        tail_block<T, kShifted, kKB / 8>(r, q, ks, vt, vp, posl, tbl, p,
                                         full * kKB, (rest + 7) / 8, g, t4);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float inv = 1.f / quad_sum(r.l[h]);  // every lane of the warp
        if ((h ? r1 : r0) >= p.N) continue;
        T* o = p.out + (h ? row1 : row0) * p.C + col0 + 2 * t4;
#pragma unroll
        for (int dn = 0; dn < kHD / 8; ++dn)
          store2(o + dn * 8, r.o[dn][2 * h] * inv, r.o[dn][2 * h + 1] * inv);
      }
    }
  }
}

template <typename T, bool kShifted>
int launch(const Params<T>& p, cudaStream_t st) {
  const int smem = Layout<T>::bytes(p.N, p.rows);
  auto kernel = window_attn_kernel<T, kShifted>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.NBW + kWinPerCta - 1) / kWinPerCta, p.heads);
  kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int forward(const void* qkv, void* out, const float* tbl, const int* tok,
            const int* pos, const int* lab, float qk_scale, float mask_value,
            int clip, int C, int heads, int N, int NW, int NBW, int rows,
            int c0, int shifted, cudaStream_t st) {
  const Params<T> p{static_cast<const T*>(qkv), static_cast<T*>(out), tbl,
                    tok, pos, lab, qk_scale, mask_value, clip, C, heads, N,
                    NW, NBW, rows, c0};
  return shifted ? launch<T, true>(p, st) : launch<T, false>(p, st);
}

}  // namespace

// Dynamic shared memory of one block for windows of N tokens and a table
// of `rows` rows, bf16 (bf16 != 0) or fp32.
extern "C" int window_attn_smem_bytes(int bf16, int N, int rows) {
  return bf16 ? Layout<__nv_bfloat16>::bytes(N, rows)
              : Layout<float>::bytes(N, rows);
}

// Plain C interface (loaded with ctypes). qkv (B, T, H, W, 3C) and out
// (B, T, H, W, C) are contiguous and share one dtype, bf16 if `bf16` is 1,
// fp32 if 0, 16-byte aligned; C = 32 * heads. tbl (heads, rows) fp32 is
// the bias table transposed and times log2 e; tok and lab (NW, N) and pos
// (N,) int32 (ops/window_attn_cuda.py::index_tables); clip = T*H*W; NW
// windows a clip, NBW = B*NW; c0 the table row of a pair (i, i). Launches
// on `stream` without synchronising; returns the cudaError_t of the
// attribute call or the launch.
extern "C" int window_attn_forward(const void* qkv, void* out, int bf16,
                                   const float* tbl, const int* tok,
                                   const int* pos, const int* lab,
                                   float qk_scale, float mask_value, int clip,
                                   int C, int heads, int N, int NW, int NBW,
                                   int rows, int c0, int shifted,
                                   void* stream) {
  if (N < 1 || N > 0xffff || heads < 1 || heads > 65535 || C != kHD * heads ||
      NW < 1 || NBW < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? forward<__nv_bfloat16>(qkv, out, tbl, tok, pos, lab, qk_scale,
                                       mask_value, clip, C, heads, N, NW, NBW,
                                       rows, c0, shifted, st)
              : forward<float>(qkv, out, tbl, tok, pos, lab, qk_scale,
                               mask_value, clip, C, heads, N, NW, NBW, rows,
                               c0, shifted, st);
}

extern "C" const char* window_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
