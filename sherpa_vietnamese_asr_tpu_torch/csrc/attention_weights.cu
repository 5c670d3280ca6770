// Zipformer attention weights, keys-major, bf16 out.
//
// Replaces: sherpa_vietnamese_asr_tpu/ops/attention.py _attn_kernel_t
// (launcher _attn_weights_pallas, entry attention_weights_pallas), the TPU
// kernel that computes per (batch*head, 128-query block) the content scores,
// the banded rel-pos scores realigned by log2(R) sublane rolls, the key mask
// and the softmax over keys.
//
//   out[bh, s, t] = softmax_s( q[t].k[s] + pq[t].pos[s + T-1-t] ),
//   keys s >= lens[b] masked to -1e9 (all keys masked -> uniform 1/T).
//
// What bounds it on the H100: the output. It is B*H*T^2 bf16 values, about
// 173 MB per stack-0 layer at B = 8 (T = 1646, H = 4), 52 us at 3.35 TB/s,
// while the inputs are a few MB. The two-pass softmax below recomputes each
// score (2 x 36 FMA per score with qd = 32, pd = 4), about 12 GFLOP of SIMT
// fp32 per stack-0 layer, so in this first version the recompute, not the
// write, is likely the bound.
//
// Design: the band and the rolls were TPU layout devices; here the skew is
// index arithmetic. One thread per query t, 128 neighbouring queries per
// block, grid (T/128, B*H). Each thread keeps q[t] and pq[t] in registers
// and walks the keys in tiles of 64 staged in shared memory together with
// the 64 + 127 position rows the tile needs. Pass 1 keeps an online max and
// sum; pass 2 recomputes and writes bf16(exp(x - max) / sum) to out[bh, s, t]:
// neighbouring threads write neighbouring t, so every store of the keys-major
// output is coalesced.
//
// The BAND_BF16 instantiation (entry svt_attention_weights_bf16band) replaces
// benchmarks/_skewbf16.py _attn_kernel_t_bf16band (launcher
// attn_weights_bf16band), a measurement probe of the TPU kernel above that
// cast its band to bf16 before the rolls, to halve their VMEM traffic. Here
// the rolls are an index, so what is left is its function: every position
// score pq[t].pos[j] rounded to bf16 (nearest even) and widened back before
// the content score is added. The band is summed over PD in one fixed order
// with rounded products and adds (__fmul_rn, __fadd_rn: no contraction into
// fma), as the plain twin sums it, so both round the same float32 value. The
// score lambda serves both passes, so the max, the sum and the weights all
// see the rounded score. Same bound and same work as kernel 2, plus two
// conversions a score.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kQueries = 128;  // threads (queries) per block
constexpr int kKeys = 64;      // keys per shared-memory tile
constexpr float kMasked = -1e9f;

template <int QD, int PD, bool BAND_BF16>
__global__ void __launch_bounds__(kQueries)
attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ pq, const float* __restrict__ pos,
            const int* __restrict__ lens, __nv_bfloat16* __restrict__ out,
            int H, int T) {
  __shared__ float s_k[kKeys][QD + 1];
  __shared__ float s_pos[kKeys + kQueries - 1][PD];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kQueries;
  const int t = t0 + tid;
  const bool live = t < T;
  const int len = lens[b];
  const int n_rows = 2 * T - 1;

  float qr[QD], pr[PD];
#pragma unroll
  for (int d = 0; d < QD; ++d)
    qr[d] = live ? q[((size_t)bh * T + t) * QD + d] : 0.f;
#pragma unroll
  for (int d = 0; d < PD; ++d)
    pr[d] = live ? pq[((size_t)bh * T + t) * PD + d] : 0.f;

  const float* kb = k + (size_t)bh * T * QD;
  const float* pb = pos + (size_t)h * n_rows * PD;

  // Stage keys [s0, s0+kKeys) and the position rows they need for this
  // block's queries: row j = s + T-1-t, j - jmin = (s - s0) + (127 - tid).
  auto stage = [&](int s0) {
    for (int i = tid; i < kKeys * QD; i += kQueries) {
      const int s = i / QD, d = i % QD;
      s_k[s][d] = (s0 + s < T) ? kb[(size_t)(s0 + s) * QD + d] : 0.f;
    }
    const int jmin = s0 + T - 1 - (t0 + kQueries - 1);
    for (int i = tid; i < (kKeys + kQueries - 1) * PD; i += kQueries) {
      const int r = i / PD, d = i % PD;
      const int j = jmin + r;
      s_pos[r][d] = (j >= 0 && j < n_rows) ? pb[(size_t)j * PD + d] : 0.f;
    }
  };
  auto score = [&](int s0, int si) {
    if (s0 + si >= len) return kMasked;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < QD; ++d) acc = fmaf(qr[d], s_k[si][d], acc);
    const int r = si + (kQueries - 1 - tid);
    float pacc;
    if constexpr (BAND_BF16) {
      pacc = __fmul_rn(pr[0], s_pos[r][0]);
#pragma unroll
      for (int d = 1; d < PD; ++d)
        pacc = __fadd_rn(pacc, __fmul_rn(pr[d], s_pos[r][d]));
      pacc = __bfloat162float(__float2bfloat16_rn(pacc));
    } else {
      pacc = 0.f;
#pragma unroll
      for (int d = 0; d < PD; ++d) pacc = fmaf(pr[d], s_pos[r][d], pacc);
    }
    return acc + pacc;
  };

  // Pass 1: online max and sum of exp over all keys.
  float m = -INFINITY, l = 0.f;
  for (int s0 = 0; s0 < T; s0 += kKeys) {
    __syncthreads();
    stage(s0);
    __syncthreads();
    const int n = min(kKeys, T - s0);
    for (int si = 0; si < n; ++si) {
      const float x = score(s0, si);
      if (x > m) {
        l = l * expf(m - x) + 1.f;
        m = x;
      } else {
        l += expf(x - m);
      }
    }
  }
  const float inv = 1.f / l;

  // Pass 2: recompute, normalise, write keys-major (coalesced along t).
  __nv_bfloat16* ob = out + (size_t)bh * T * T;
  for (int s0 = 0; s0 < T; s0 += kKeys) {
    __syncthreads();
    stage(s0);
    __syncthreads();
    const int n = min(kKeys, T - s0);
    for (int si = 0; si < n; ++si) {
      const float x = score(s0, si);
      if (live) ob[(size_t)(s0 + si) * T + t] = __float2bfloat16(expf(x - m) * inv);
    }
  }
}

template <int QD, int PD, bool BAND_BF16>
cudaError_t launch(const float* q, const float* k, const float* pq,
                   const float* pos, const int* lens, __nv_bfloat16* out,
                   int B, int H, int T, cudaStream_t stream) {
  dim3 grid((T + kQueries - 1) / kQueries, B * H);
  attn_kernel<QD, PD, BAND_BF16><<<grid, kQueries, 0, stream>>>(
      q, k, pq, pos, lens, out, H, T);
  return cudaGetLastError();
}

template <bool BAND_BF16>
int dispatch(const float* q, const float* k, const float* pq, const float* pos,
             const int* lens, void* out, int B, int H, int T, int qd, int pd,
             void* stream) {
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto st = (cudaStream_t)stream;
  if (qd == 32 && pd == 4)
    return (int)launch<32, 4, BAND_BF16>(q, k, pq, pos, lens, o, B, H, T, st);
  if (qd == 16 && pd == 4)
    return (int)launch<16, 4, BAND_BF16>(q, k, pq, pos, lens, o, B, H, T, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int svt_attention_weights(const float* q, const float* k,
                                     const float* pq, const float* pos,
                                     const int* lens, void* out, int B, int H,
                                     int T, int qd, int pd, void* stream) {
  return dispatch<false>(q, k, pq, pos, lens, out, B, H, T, qd, pd, stream);
}

// The same arguments; the position scores rounded to bf16 before the add.
extern "C" int svt_attention_weights_bf16band(const float* q, const float* k,
                                              const float* pq, const float* pos,
                                              const int* lens, void* out, int B,
                                              int H, int T, int qd, int pd,
                                              void* stream) {
  return dispatch<true>(q, k, pq, pos, lens, out, B, H, T, qd, pd, stream);
}
