// Score tile of the Zipformer attention weights, for one warp:
//
//   x[t, s] = q[t].k[s] + pq[t].poslin[s + T-1-t],
//   keys s >= len scoring -1e9 and keys s >= T -inf (they do not exist),
//
// over 16 queries (rows) and 8 * NT keys (columns) for each warp of a
// warpgroup (64 rows), in the accumulator layout of wgmma m64nN (mma.sync
// m16n8's, a warp's 16 rows each): lane (g, tg) = (lane / 4, lane % 4)
// holds, for the key tile j, x[j][0..3] at (row g, key 8j + 2tg), (g, 8j +
// 2tg + 1), (g + 8, 8j + 2tg), (g + 8, 8j + 2tg + 1). Rows are queries, so a
// row's max and sum live in one quad of lanes (FlashAttention-2's layout).
//
// The content product q.k runs on the tensor cores at float32 accuracy:
// each operand is split into two TF32 values, big = rna(x) and small =
// rna(x - big), and the tile accumulates small*big + big*small + big*big in
// float32 (3xTF32), as wgmma m64n64k8 with the queries in registers and the
// keys, split once a block, in shared memory. One TF32 pass keeps about 11 bits of each operand, an
// error of order 2^-11 of |q||k| in a score and so in the relative weight,
// far beyond the 2^-12 of slack that the bf16 gate leaves; the dropped
// small*small term is below 2^-22 of it.
//
// The relative-position band pq[t].poslin[j] stays on the SIMT cores: PD = 4
// terms per score from one float4 position row staged in shared memory.
// Kernel 2 sums it with fmaf; the BAND_BF16 variant (kernel 5) with rounded
// products and adds left to right (__fmul_rn, __fadd_rn), rounds the float32
// band to bf16 nearest-even and widens it before the add, exactly as its
// plain twin does, because its gate has no room for a band one ulp off.
//
// Softmax in base 2: exp(x - m) = exp2((x - m) * log2(e)). The difference is
// exact or rounded once (2^-24 of |x - m|), the product once more, and
// ex2.approx is good to about 2^-22 relative: for the weights that matter
// (x - m > -20) the weight's relative error is under 1e-5, against the
// gate's 2^-12 = 2.4e-4. A row with every key masked gets x - m = 0 at each
// existing key, so the uniform 1/T.
//
// Both passes of the kernel call the same routines on the same staged data,
// so they see bit-identical scores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace svt_attn_tile {

constexpr float kMasked = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;

// The 3xTF32 split x = big + small (+ below 2^-22 |x|): big = cvt.rna.tf32(x),
// small = cvt.rna.tf32(x - big). For finite x, cvt.rna is adding half an
// ulp of TF32 to the magnitude bits (ties away from zero) and clearing the
// 13 low bits; nvcc emulates the instruction with a further inf/NaN test
// and select, so the integer form, the operands being finite.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// The warpgroup's 64 query rows as wgmma A fragments in registers, split
// once; warp w holds rows 16w..16w+15, and a[ks] covers dims 8ks..8ks+7:
// a[ks][0..3] = q[g][8ks+tg], q[g+8][8ks+tg], q[g][8ks+tg+4], q[g+8][8ks+tg+4].
template <int QD>
struct QueryFrags {
  uint32_t big[QD / 8][4];
  uint32_t small[QD / 8][4];
};

// q0, q1: rows g and g + 8 of the warp (nullptr for a query at or beyond
// T: zeros).
template <int QD>
__device__ __forceinline__ void load_query_frags(QueryFrags<QD>& f, const float* q0,
                                                 const float* q1, int tg) {
#pragma unroll
  for (int ks = 0; ks < QD / 8; ++ks) {
    const int c = 8 * ks + tg;
    const float v[4] = {q0 ? q0[c] : 0.f, q1 ? q1[c] : 0.f, q0 ? q0[c + 4] : 0.f,
                        q1 ? q1[c + 4] : 0.f};
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], f.big[ks][i], f.small[ks][i]);
  }
}

// Key tiles in shared memory are K-major rows of 128 bytes (up to 32
// floats, qd <= 32; a shorter qd leaves the rest of the row unused) in
// wgmma's 128-byte swizzle: 16-byte chunk c of key row n sits at chunk
// c ^ (n % 8) of the row, in 8-row atoms of 1024 bytes (a tile starts
// 1024-byte aligned). Byte offset of (n, c):
__device__ __forceinline__ uint32_t key_chunk(int n, int c) {
  return n * 128 + ((c ^ (n & 7)) << 4);
}

// The split pass of one staged step: `big` holds the raw keys [KEYS rows] as
// staged; each float becomes its TF32 big part there and its small part at
// the same place in `small`. Then the async proxy (wgmma) may read both,
// after a barrier.
template <int QD, int KEYS, int THREADS>
__device__ __forceinline__ void split_keys(unsigned char* big, unsigned char* small,
                                           int tid) {
  constexpr int kChunks = QD / 4;
  static_assert(KEYS * kChunks % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int u = 0; u < KEYS * kChunks / THREADS; ++u) {
    const int i = tid + u * THREADS;
    const uint32_t off = key_chunk(i / kChunks, i % kChunks);
    const float4 v = *reinterpret_cast<const float4*>(big + off);
    uint4 hi, lo;
    split_tf32(v.x, hi.x, lo.x);
    split_tf32(v.y, hi.y, lo.y);
    split_tf32(v.z, hi.z, lo.z);
    split_tf32(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(big + off) = hi;
    *reinterpret_cast<uint4*>(small + off) = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a K-major 128-byte-swizzled tile at shared address
// `addr` (8-row groups 1024 bytes apart).
__device__ __forceinline__ uint64_t key_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (its registers are defined only after the wait).
template <int NT>
__device__ __forceinline__ void fence_acc(float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(x[j][i])::"memory");
}

// x (+)= a * B over m64 n64 k8, TF32 in, float32 accumulation; B from
// shared memory through `desc`, a from registers.
__device__ __forceinline__ void wgmma_tf32(float (&x)[8][4], const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(x[0][0]), "+f"(x[0][1]), "+f"(x[0][2]), "+f"(x[0][3]), "+f"(x[1][0]),
        "+f"(x[1][1]), "+f"(x[1][2]), "+f"(x[1][3]), "+f"(x[2][0]), "+f"(x[2][1]),
        "+f"(x[2][2]), "+f"(x[2][3]), "+f"(x[3][0]), "+f"(x[3][1]), "+f"(x[3][2]),
        "+f"(x[3][3]), "+f"(x[4][0]), "+f"(x[4][1]), "+f"(x[4][2]), "+f"(x[4][3]),
        "+f"(x[5][0]), "+f"(x[5][1]), "+f"(x[5][2]), "+f"(x[5][3]), "+f"(x[6][0]),
        "+f"(x[6][1]), "+f"(x[6][2]), "+f"(x[6][3]), "+f"(x[7][0]), "+f"(x[7][1]),
        "+f"(x[7][2]), "+f"(x[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// x[j][*] = q.k for the warpgroup's 64 rows and the 64 keys of a split key
// tile (big and small parts at shared addresses `big`, `small`): per 8-dim
// step small*big, big*small, then big*big, all into one float32
// accumulator, tile j holding keys 8j..8j+7. Two ways of overlapping the
// products with the SIMT work were slower on the H100: the band computed
// meanwhile into 32 more registers spilled (12% slower), and the 64 keys as
// two n32 groups, the first half's scores finished while the second's
// products ran, gained nothing (PERF.md).
template <int QD>
__device__ __forceinline__ void content_tile(float (&x)[8][4], const QueryFrags<QD>& f,
                                             uint32_t big, uint32_t small) {
  fence_acc(x);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < QD / 8; ++ks) {
    wgmma_tf32(x, f.small[ks], key_desc(big + 32 * ks), ks > 0);
    wgmma_tf32(x, f.big[ks], key_desc(small + 32 * ks), 1);
    wgmma_tf32(x, f.big[ks], key_desc(big + 32 * ks), 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(x);
}

template <bool BAND_BF16>
__device__ __forceinline__ float band(float4 p, float4 r) {
  if constexpr (BAND_BF16) {
    float b = __fmul_rn(p.x, r.x);
    b = __fadd_rn(b, __fmul_rn(p.y, r.y));
    b = __fadd_rn(b, __fmul_rn(p.z, r.z));
    b = __fadd_rn(b, __fmul_rn(p.w, r.w));
    return __bfloat162float(__float2bfloat16_rn(b));
  } else {
    float b = fmaf(p.x, r.x, 0.f);
    b = fmaf(p.y, r.y, b);
    b = fmaf(p.z, r.z, b);
    return fmaf(p.w, r.w, b);
  }
}

// Adds the band. pq[h]: the position query of row g + 8h; element (row
// g + 8h, key 8j + 2tg + e) reads position row r0 + 8j + e - 8h of s_pos, r0
// being x[0][0]'s. Row g + 8 of tile j reads row g's of tile j - 1, so the
// lane loads 2 (NT + 1) rows, not 4 NT.
template <int NT, bool BAND_BF16>
__device__ __forceinline__ void add_band(float (&x)[NT][4], const float4 (&pq)[2],
                                         const float4* s_pos, int r0) {
#pragma unroll
  for (int j = -1; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 row = s_pos[r0 + 8 * j + e];
      if (j >= 0) x[j][e] += band<BAND_BF16>(pq[0], row);
      if (j + 1 < NT) x[j + 1][2 + e] += band<BAND_BF16>(pq[1], row);
    }
  }
}

// Keys s >= len score -1e9, keys s >= T (which do not exist) -inf; s0 is
// the key of x[0][0] (2tg included).
template <int NT>
__device__ __forceinline__ void mask_keys(float (&x)[NT][4], int s0, int len, int T) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + 8 * j + (i & 1);
      if (s >= len) x[j][i] = kMasked;
      if (s >= T) x[j][i] = -INFINITY;
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// exp(x - m) as 2^((x - m) log2 e); ex2.approx flushes results below
// 2^-126 to zero, far under the gate's absolute 1e-6.
__device__ __forceinline__ float exp2_shift(float x, float m) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"((x - m) * kLog2e));
  return y;
}

// Online softmax statistics of rows g and g + 8 over one tile: m[h] is the
// row's running max (the same in the quad's four lanes), l[h] this lane's
// share of the running sum of exp(x - m). A tile of keys beyond T only
// (all -inf) leaves both as they were.
template <int NT>
__device__ __forceinline__ void online_update(const float (&x)[NT][4], float (&m)[2],
                                              float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mt = m[h];
#pragma unroll
    for (int j = 0; j < NT; ++j) mt = fmaxf(mt, fmaxf(x[j][2 * h], x[j][2 * h + 1]));
    mt = quad_max(mt);
    const float ms = mt == -INFINITY ? 0.f : mt;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      sum += exp2_shift(x[j][2 * h], ms) + exp2_shift(x[j][2 * h + 1], ms);
    l[h] = l[h] * exp2_shift(m[h], ms) + sum;
    m[h] = mt;
  }
}

// Two (max, sum) pairs of one row, a then b, as one.
__device__ __forceinline__ float2 combine(float2 a, float2 b) {
  const float m = fmaxf(a.x, b.x);
  return make_float2(m, a.y * exp2_shift(a.x, m) + b.y * exp2_shift(b.x, m));
}

}  // namespace svt_attn_tile
