// Zipformer attention weights, keys-major, bf16 out.
//
// Replaces: sherpa_vietnamese_asr_tpu/ops/attention.py _attn_kernel_t
// (launcher _attn_weights_pallas, entry attention_weights_pallas), the TPU
// kernel that computes per (batch*head, 128-query block) the content scores,
// the banded rel-pos scores realigned by log2(R) sublane rolls, the key mask
// and the softmax over keys.
//
//   out[b, h, s, t] = softmax_s( q[t].k[s] + pq[t].pos[h, s + T-1-t] ),
//   keys s >= lens[b] masked to -1e9 (all keys masked -> uniform 1/T).
//
// The BAND_BF16 instantiation (entry svt_attention_weights_bf16band) replaces
// benchmarks/_skewbf16.py _attn_kernel_t_bf16band (launcher
// attn_weights_bf16band), a measurement probe of the TPU kernel above that
// cast its band to bf16 before the rolls. Here the rolls are an index, so
// what is left is its function: every position score rounded to bf16
// (nearest even) and widened back before the content score is added
// (attn_tile.cuh says how, and why in that order).
//
// What bounds it on the H100: the output, B*H*T^2 bf16 weights, 173 MB per
// stack-0 layer (B 8, T 1646, H 4), 52 us at 3.35 TB/s; the inputs are a few
// MB. The work: a two-pass softmax scores every (query, key) twice. The
// content product q.k (qd = 32) runs on the tensor cores as 3xTF32 wgmma
// (attn_tile.cuh), 33.6 us of the TF32 peak at stack 0 with both passes and
// the split; the band (pd = 4), masks and exp2 on the SIMT cores, about 15
// instructions a score a pass. As built it takes 0.39 ms of device time at
// stack 0, 14% of its bound: the SIMT work and three or four barriers a
// step in two passes, with the tensor cores idle most of the time
// (tools/attn_stages.py: pass 2 0.22 ms of it, the product 0.10, the band
// 0.08, the global stores 0.07, the key split 0.05). A first version ran
// the product as mma.sync m16n8k8, each warp loading and splitting its own
// key fragments: 0.44 ms, the product and its split half of the loop's
// instructions (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Design (FlashAttention-2's layout, rows are queries):
//   - a block takes 64 queries of one (batch, head): 8 warps, two
//     warpgroups along the keys, each warp 16 query rows. Keys go in steps
//     of 128, 64 for each warpgroup, which scores its 64 x 64 tile with
//     wgmma m64n64k8 (attn_tile.cuh), the queries split in registers once.
//   - each step's 128 key rows (in wgmma's 128-byte-swizzled K-major
//     layout) and the 191 position rows its scores need (one float4 a row,
//     pd = 4) are staged with cp.async, double-buffered: the next step loads
//     while this one computes. One pass of the block then splits the keys
//     into TF32 big and small parts in place. q, k and pq are read in place
//     from the projection through their element strides.
//   - pass 1 keeps each row's online max and sum in registers, reduced over
//     the quad with shuffles; the two key groups combine their (max, sum)
//     in shared memory. Pass 2 recomputes each tile with the same
//     instructions, writes exp2((x - m) log2 e) / sum as bf16 into a shared
//     [128 keys][64 queries] tile, and the block stores its rows of keys with
//     consecutive queries, coalesced: bf16x2 a lane (128 bytes a warp) when
//     T is even, so that every row of `out` starts 4-byte aligned, bf16 a
//     lane at odd T (2T bytes a row: at T 823 a row may start on a 2-byte
//     boundary).
//
// The grid is (ceil(T / 64), B*H) blocks of 256 threads, two resident an SM
// (75 KB of shared memory each, registers capped at 128): at B 8, stack 0
// (T 1646, H 4) 832 blocks, 3.2 waves on 132 SMs; stacks 1 and 5 (T 823,
// H 4) 416, 1.6 waves; stacks 2 and 4 (T 412, H 4) 224, 0.85 of a wave;
// stack 3 (T 206, H 8) 256, 0.97 of a wave. The key split puts 16 warps on
// an SM where one query tile a block would leave 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"

// SVT_ATTN_CUT (default 0, the kernel as shipped) is a timing instrument:
// each bit skips one part of every step, and any mask but 0 gives wrong
// weights. tools/attn_stages.py builds and times the masks.
#ifndef SVT_ATTN_CUT
#define SVT_ATTN_CUT 0
#endif

namespace {

constexpr int kCut = SVT_ATTN_CUT;
constexpr int kCutStore = 1;    // pass 2's global stores
constexpr int kCutPass2 = 2;    // all of pass 2
constexpr int kCutProduct = 4;  // the content product (scores are the band)
constexpr int kCutBand = 8;     // the band
constexpr int kCutSplit = 16;   // the split pass (the product reads raw keys)

using namespace svt_attn_tile;

constexpr int kRowWarps = 4;                        // warps along the queries
constexpr int kKeyGroups = 2;                       // warps along the keys
constexpr int kThreads = 32 * kRowWarps * kKeyGroups;
constexpr int kQueryTile = 16 * kRowWarps;          // queries a block
constexpr int kGroupKeys = 64;                      // keys a warp a step
constexpr int kStepKeys = kGroupKeys * kKeyGroups;  // keys a step
constexpr int kTiles = kGroupKeys / 8;              // n8 key tiles a warp a step
constexpr int kPosRows = kStepKeys + kQueryTile - 1;
constexpr int kOutStride = kQueryTile + 8;  // bf16; conflict-free transposed writes

struct Smem {  // 1024-byte aligned (the swizzled key tiles)
  unsigned char big[2][kStepKeys * 128];  // staged keys, then their TF32 big parts
  unsigned char small[kStepKeys * 128];   // their small parts
  float4 pos[2][kPosRows + 1];
  __nv_bfloat16 p[kStepKeys][kOutStride];
  float2 ml[kKeyGroups][kQueryTile];
};

struct Args {
  const float* q;
  const float* k;
  const float* pq;
  const float* pos;  // [H, 2T-1, 4]
  const int* lens;
  __nv_bfloat16* out;  // [B, H, T, T]
  int H, T;
  long long qs[3], ks[3], ps[3];  // element strides of batch, time, head
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

template <int QD, int PD, bool BAND_BF16>
__global__ void __launch_bounds__(kThreads, 2) attn_kernel(const Args a) {
  static_assert(PD == 4, "one float4 position row a score");
  extern __shared__ unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~static_cast<uintptr_t>(1023));

  const int T = a.T, n_rows = 2 * T - 1;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int t0 = blockIdx.x * kQueryTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % kRowWarps, kg = warp / kRowWarps;
  const int g = lane >> 2, tg = lane & 3;
  const int tl0 = 16 * rw + g;  // block-local rows tl0 and tl0 + 8
  const int len = a.lens[b];

  const float* kb = a.k + b * a.ks[0] + h * a.ks[2];
  const float* pb = a.pos + (size_t)h * n_rows * PD;

  QueryFrags<QD> qf;
  float4 pq[2];
  {
    const float* qrow[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + tl0 + 8 * r;
      qrow[r] = t < T ? a.q + b * a.qs[0] + t * a.qs[1] + h * a.qs[2] : nullptr;
      const float* p = a.pq + b * a.ps[0] + t * a.ps[1] + h * a.ps[2];
      pq[r] = t < T ? make_float4(p[0], p[1], p[2], p[3]) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    load_query_frags<QD>(qf, qrow[0], qrow[1], tg);
  }

  // Keys [s0, s0 + 128) and position rows j = jmin + r, r < 191, where
  // jmin = s0 + T-1 - (t0 + 63): key s and query t read row
  // (s - s0) + (t0 + 63 - t). Rows outside the keys or the table fill zeros.
  constexpr int kChunks = QD / 4;  // 16-byte chunks a key row
  static_assert(kStepKeys * kChunks % kThreads == 0 && kPosRows <= kThreads, "staging");
  auto stage = [&](int step, int buf) {
    const int s0 = step * kStepKeys;
#pragma unroll
    for (int u = 0; u < kStepKeys * kChunks / kThreads; ++u) {
      const int i = tid + u * kThreads;
      const int row = i / kChunks, c = i % kChunks, s = s0 + row;
      const bool valid = s < T;
      cp_async16(sm.big[buf] + key_chunk(row, c), valid ? kb + s * a.ks[1] + 4 * c : kb,
                 valid);
    }
    if (tid < kPosRows) {
      const int j = s0 + T - 1 - (t0 + kQueryTile - 1) + tid;
      const bool valid = j >= 0 && j < n_rows;
      cp_async16(&sm.pos[buf][tid], valid ? pb + (size_t)j * PD : pb, valid);
    }
  };

  const int steps = (T + kStepKeys - 1) / kStepKeys;
  const int iters = kCut & kCutPass2 ? steps : 2 * steps;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};
  __nv_bfloat16* ob = a.out + (size_t)bh * T * T;

  stage(0, 0);
  cp_async_commit();
  // Iterations 0 .. steps-1 are pass 1, steps .. 2*steps-1 pass 2.
  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1, step = it < steps ? it : it - steps;
    if (it + 1 < iters) stage((it + 1) % steps, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    if (!(kCut & kCutSplit)) split_keys<QD, kStepKeys, kThreads>(sm.big[buf], sm.small, tid);
    __syncthreads();
    if (it == steps) {  // both key groups' (max, sum), group 0 first
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 c = combine(sm.ml[0][tl0 + 8 * r], sm.ml[1][tl0 + 8 * r]);
        m[r] = c.x;
        inv[r] = 1.f / c.y;
      }
    }

    float x[kTiles][4];
    if (kCut & kCutProduct) {
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) x[j][i] = 0.f;
    } else {
      const uint32_t slab = kg * kGroupKeys * 128;  // this warpgroup's 64 keys
      content_tile<QD>(x, qf, smem_addr(sm.big[buf] + slab), smem_addr(sm.small + slab));
    }
    const int sl = kg * kGroupKeys + 2 * tg;  // step-local key of x[0][0]
    if (!(kCut & kCutBand))
      add_band<kTiles, BAND_BF16>(x, pq, sm.pos[buf], sl + kQueryTile - 1 - tl0);
    const int s_warp = step * kStepKeys + kg * kGroupKeys;
    if (s_warp + kGroupKeys > min(len, T))  // warp-uniform: most tiles skip it
      mask_keys<kTiles>(x, s_warp + 2 * tg, len, T);

    if (it < steps) {
      online_update<kTiles>(x, m, l);
      if (it == steps - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float sum = quad_sum(l[r]);
          if (tg == 0) sm.ml[kg][tl0 + 8 * r] = make_float2(m[r], sum);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          sm.p[sl + 8 * j + (i & 1)][tl0 + 8 * r] =
              __float2bfloat16(exp2_shift(x[j][i], m[r]) * inv[r]);
        }
      __syncthreads();
      const int s0 = step * kStepKeys;
      const int keys = min(kStepKeys, T - s0), queries = min(kQueryTile, T - t0);
      constexpr int kWarps = kThreads / 32;
      if (kCut & kCutStore) {
        // timing instrument: no global stores
      } else if ((T & 1) == 0) {  // every row of out starts 4-byte aligned
        const int tq = 2 * lane;
        for (int kr = warp; kr < keys; kr += kWarps) {
          __nv_bfloat16* dst = ob + (size_t)(s0 + kr) * T + t0 + tq;
          if (tq + 1 < queries)
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                *reinterpret_cast<const __nv_bfloat162*>(&sm.p[kr][tq]);
          else if (tq < queries)
            *dst = sm.p[kr][tq];
        }
      } else {
        for (int kr = warp; kr < keys; kr += kWarps)
          for (int tq = lane; tq < queries; tq += 32)
            ob[(size_t)(s0 + kr) * T + t0 + tq] = sm.p[kr][tq];
      }
    }
    __syncthreads();
  }
}

template <int QD, bool BAND_BF16>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  auto kernel = attn_kernel<QD, 4, BAND_BF16>;
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;  // + the alignment
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T + kQueryTile - 1) / kQueryTile, B * a.H);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool BAND_BF16>
int dispatch(const float* q, const float* k, const float* pq, const float* pos,
             const int* lens, void* out, int B, int H, int T, int qd, int pd,
             long long q_sb, long long q_st, long long q_sh, long long k_sb,
             long long k_st, long long k_sh, long long p_sb, long long p_st,
             long long p_sh, void* stream) {
  if (pd != 4 || T < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const Args a{q, k, pq, pos, lens, static_cast<__nv_bfloat16*>(out), H, T,
               {q_sb, q_st, q_sh}, {k_sb, k_st, k_sh}, {p_sb, p_st, p_sh}};
  auto st = (cudaStream_t)stream;
  if (qd == 32) return (int)launch<32, BAND_BF16>(a, B, st);
  if (qd == 16) return (int)launch<16, BAND_BF16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k [B, T, H, qd] and pq [B, T, H, pd] float32 with the given element
// strides (batch, time, head; the last dim contiguous; k's rows 16-byte
// aligned), pos [H, 2T-1, pd] float32 contiguous, lens [B] int32, out
// [B, H, T, T] bf16.
extern "C" int svt_attention_weights(const float* q, const float* k, const float* pq,
                                     const float* pos, const int* lens, void* out, int B,
                                     int H, int T, int qd, int pd, long long q_sb,
                                     long long q_st, long long q_sh, long long k_sb,
                                     long long k_st, long long k_sh, long long p_sb,
                                     long long p_st, long long p_sh, void* stream) {
  return dispatch<false>(q, k, pq, pos, lens, out, B, H, T, qd, pd, q_sb, q_st, q_sh,
                         k_sb, k_st, k_sh, p_sb, p_st, p_sh, stream);
}

// The same arguments; the position scores rounded to bf16 before the add.
extern "C" int svt_attention_weights_bf16band(
    const float* q, const float* k, const float* pq, const float* pos, const int* lens,
    void* out, int B, int H, int T, int qd, int pd, long long q_sb, long long q_st,
    long long q_sh, long long k_sb, long long k_st, long long k_sh, long long p_sb,
    long long p_st, long long p_sh, void* stream) {
  return dispatch<true>(q, k, pq, pos, lens, out, B, H, T, qd, pd, q_sb, q_st, q_sh, k_sb,
                        k_st, k_sh, p_sb, p_st, p_sh, stream);
}
