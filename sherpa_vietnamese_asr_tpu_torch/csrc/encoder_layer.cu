// One whole Zipformer2 encoder layer of the bfloat16 tier, as a short
// sequence of launches on the caller's stream.
//
// Replaces: sherpa_vietnamese_asr_tpu/ops/encoder_layer.py _layer_kernel
// (launchers _layer_pallas, encoder_layer_pallas; its streamed=True variant
// computes the same), the TPU kernel that runs one whole layer per batch
// element with the sequence and a [H*T_pad, T_pad] attention-weights scratch
// resident in VMEM. The plain twin is ops/encoder_layer.encoder_layer_plain.
//
// Order, as in the TPU kernel: attention weights from the pre-layer x, ff1,
// the nonlin attention on head 0, self-attention 1, conv 1, ff2, the mid
// bypass, self-attention 2, conv 2, ff3, BiasNorm, the final bypass. Rounding
// points kept: a linear's f32 sum is rounded to bf16 and its bf16 bias added
// in bf16; the swoosh output is rounded to bf16 before the second product;
// attended values are rounded to bf16 before out_proj; the nonlin y-gate is a
// bf16 product; the conv gate output is zeroed on rows >= lens and stored in
// bf16; the K-tap depthwise sum is f32; the residual stream is f32. Masked
// keys score -1e9, so a chunk with lens 0 gets uniform weights over all
// T_pad keys. Every product here is hand-written: the seven linears and the
// attends through WMMA bf16 tiles with f32 accumulation, q.k and the
// positional band as exact bf16 products summed in f32 on the SIMT cores.
//
// What bounds it on the H100: a block has 227 KB of shared memory where the
// TPU kernel held 22 MB of weights scratch in VMEM at stack 0, so the layer
// is split into launches and the attention weights live in a [B, H, T_pad,
// T_pad] bf16 workspace in device memory (177 MB at stack 0, B 8, T_pad
// 1664, H 4: written once, read by three attends, 0.2 ms of HBM traffic at
// 3.35 TB/s). The linears are about 27 GFLOP per stack-0 layer, the attends
// about 18 GFLOP and the scores 13 GFLOP of SIMT fp32; in this first,
// simple version (64-row WMMA tiles staged through shared memory, no
// pipelining) the tile loads and the SIMT score recompute, not the tensor
// cores, are the likely bound. The wrapper allocates every workspace; this
// file allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ bf16 to_bf16(float x) { return __float2bfloat16(x); }
__device__ __forceinline__ bf16 to_bf16(bf16 x) { return x; }

__device__ __forceinline__ float swoosh_l(float x) {
  const float v = x - 4.f;
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))) - 0.08f * x - 0.035f;
}
__device__ __forceinline__ float swoosh_r(float x) {
  const float v = x - 1.f;
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))) - 0.08f * x - 0.313261687f;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------- GEMM
// C(m, n) = sum_k A(m, k) B(k, n) over WMMA 16x16x16 bf16 tiles with f32
// accumulation, A f32 (rounded to bf16 on load) or bf16, B bf16, any strides,
// batched over blockIdx.z = z1 * zdiv + z2. Epilogue on y = bf16(C) [+ bias
// in bf16]:
//   kStore:   out = y
//   kSwooshL: out = bf16(swoosh_l(y))
//   kYGate:   out = bf16(y * ygate)
//   kResid:   x_out = x_res + y, then with byp: x_orig + (x - x_orig) * clip(byp)
enum Epi { kStore = 0, kSwooshL = 1, kYGate = 2, kResid = 3 };

constexpr int kBM = 64, kBK = 32, kGemmThreads = 128;  // 4 warps x 16 rows

struct GemmArgs {
  const void* a;
  long long a_m, a_k, a_z1, a_z2;  // element strides of A(m, k), batch
  const bf16* b;
  long long b_k, b_n, b_z1, b_z2;
  int M, N, K, zdiv;
  // outputs are addressed by row z1 * c_rows + m and column z2 * c_cols + n
  long long c_rows, c_cols;
  const bf16* bias;  // [N] or null
  bf16* out;
  long long ldo;
  const bf16* ygate;
  long long ldy;
  float* x_out;
  const float* x_res;
  const float* x_orig;
  const float* byp;  // [N] or null
  long long ldx;
};

template <typename TA, int BN, int EPI>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(GemmArgs p) {
  __shared__ __align__(32) bf16 sA[kBM][kBK + 8];
  __shared__ __align__(32) bf16 sB[kBK][BN + 8];
  __shared__ __align__(32) float sC[kBM][BN + 4];
  constexpr int FN = BN / 16;

  const int z = blockIdx.z;
  const long long z1 = z / p.zdiv, z2 = z % p.zdiv;
  const TA* A = static_cast<const TA*>(p.a) + z1 * p.a_z1 + z2 * p.a_z2;
  const bf16* B = p.b + z1 * p.b_z1 + z2 * p.b_z2;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FN];
#pragma unroll
  for (int f = 0; f < FN; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kGemmThreads) {
      int mm, kk;  // neighbouring threads on the contiguous axis
      if (p.a_m == 1) { mm = i % kBM; kk = i / kBM; } else { kk = i % kBK; mm = i / kBK; }
      const int gm = m0 + mm, gk = k0 + kk;
      sA[mm][kk] = (gm < p.M && gk < p.K) ? to_bf16(A[gm * p.a_m + gk * p.a_k])
                                          : __float2bfloat16(0.f);
    }
    for (int i = tid; i < kBK * BN; i += kGemmThreads) {
      int kk, nn;
      if (p.b_n == 1) { nn = i % BN; kk = i / BN; } else { kk = i % kBK; nn = i / kBK; }
      const int gk = k0 + kk, gn = n0 + nn;
      sB[kk][nn] = (gk < p.K && gn < p.N) ? B[gk * p.b_k + gn * p.b_n]
                                          : __float2bfloat16(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &sA[warp * 16][kk], kBK + 8);
#pragma unroll
      for (int f = 0; f < FN; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &sB[kk][f * 16], BN + 8);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int f = 0; f < FN; ++f)
    wmma::store_matrix_sync(&sC[warp * 16][f * 16], acc[f], BN + 4, wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < kBM * BN; i += kGemmThreads) {
    const int mm = i / BN, nn = i % BN;
    const int gm = m0 + mm, gn = n0 + nn;
    if (gm >= p.M || gn >= p.N) continue;
    float y = rbf(sC[mm][nn]);
    if (p.bias) y = rbf(y + bf2f(p.bias[gn]));
    const long long row = z1 * p.c_rows + gm, col = z2 * p.c_cols + gn;
    if (EPI == kStore) {
      p.out[row * p.ldo + col] = __float2bfloat16(y);
    } else if (EPI == kSwooshL) {
      p.out[row * p.ldo + col] = __float2bfloat16(swoosh_l(y));
    } else if (EPI == kYGate) {
      p.out[row * p.ldo + col] = __float2bfloat16(y * bf2f(p.ygate[row * p.ldy + col]));
    } else {
      const long long o = row * p.ldx + col;
      float r = p.x_res[o] + y;
      if (p.byp) {
        const float xo = p.x_orig[o];
        r = xo + (r - xo) * fminf(fmaxf(p.byp[col], 0.f), 1.f);
      }
      p.x_out[o] = r;
    }
  }
}

template <typename TA, int EPI>
cudaError_t gemm(GemmArgs p, int batches, cudaStream_t st) {
  const dim3 block(kGemmThreads);
  if (p.N <= 16) {
    const dim3 grid((p.N + 15) / 16, (p.M + kBM - 1) / kBM, batches);
    gemm_kernel<TA, 16, EPI><<<grid, block, 0, st>>>(p);
  } else {
    const dim3 grid((p.N + 63) / 64, (p.M + kBM - 1) / kBM, batches);
    gemm_kernel<TA, 64, EPI><<<grid, block, 0, st>>>(p);
  }
  return cudaGetLastError();
}

// A linear: A [M, K] row-major (f32 or bf16), W [K, N] bf16 row-major.
GemmArgs linear_args(const void* a, const void* w, const void* bias, int M, int K,
                     int N) {
  GemmArgs p = {};
  p.a = a;
  p.a_m = K;
  p.a_k = 1;
  p.b = static_cast<const bf16*>(w);
  p.b_k = N;
  p.b_n = 1;
  p.M = M;
  p.N = N;
  p.K = K;
  p.zdiv = 1;
  p.bias = static_cast<const bf16*>(bias);
  return p;
}

// ------------------------------------------------------ attention weights
// out[b, h, s, t] = softmax_s(q[t].k[s] + pq[t].poslin[h, T-1+s-t]) in bf16,
// keys s >= lens[b] scoring -1e9. One thread per query t, 128 queries per
// block; keys are staged in tiles of 64 beside the 64 + 127 position rows
// they need. Pass 1 keeps an online max and sum, pass 2 recomputes and writes
// keys-major, coalesced along t. q, k, pq are the bf16 projection's columns,
// so every product is exact in f32.
constexpr int kQueries = 128;
constexpr int kKeys = 64;
constexpr float kMasked = -1e9f;

template <int QD, int PD>
__global__ void __launch_bounds__(kQueries)
attn_bf16_kernel(const bf16* __restrict__ proj, const bf16* __restrict__ poslin,
                 const int* __restrict__ lens, bf16* __restrict__ out, int H,
                 int T, int prow) {
  __shared__ float s_k[kKeys][QD + 1];
  __shared__ float s_pos[kKeys + kQueries - 1][PD];

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, t0 = blockIdx.x * kQueries, t = t0 + tid;
  const bool live = t < T;
  const int len = lens[b];
  const int P = H * (2 * QD + PD);
  const int n_rows = 2 * T - 1;
  const bf16* rows = proj + (size_t)b * T * P;
  const bf16* pb = poslin + (size_t)h * prow * PD;

  float qr[QD], pr[PD];
#pragma unroll
  for (int d = 0; d < QD; ++d) qr[d] = live ? bf2f(rows[(size_t)t * P + h * QD + d]) : 0.f;
#pragma unroll
  for (int d = 0; d < PD; ++d)
    pr[d] = live ? bf2f(rows[(size_t)t * P + 2 * H * QD + h * PD + d]) : 0.f;

  auto stage = [&](int s0) {
    for (int i = tid; i < kKeys * QD; i += kQueries) {
      const int s = i / QD, d = i % QD;
      s_k[s][d] = (s0 + s < T) ? bf2f(rows[(size_t)(s0 + s) * P + H * QD + h * QD + d]) : 0.f;
    }
    const int jmin = s0 + T - 1 - (t0 + kQueries - 1);
    for (int i = tid; i < (kKeys + kQueries - 1) * PD; i += kQueries) {
      const int r = i / PD, d = i % PD;
      const int j = jmin + r;
      s_pos[r][d] = (j >= 0 && j < n_rows) ? bf2f(pb[(size_t)j * PD + d]) : 0.f;
    }
  };
  auto score = [&](int s0, int si) {
    if (s0 + si >= len) return kMasked;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < QD; ++d) acc = fmaf(qr[d], s_k[si][d], acc);
    float pacc = 0.f;
    const int r = si + (kQueries - 1 - tid);
#pragma unroll
    for (int d = 0; d < PD; ++d) pacc = fmaf(pr[d], s_pos[r][d], pacc);
    return acc + pacc;
  };

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

  bf16* ob = out + (size_t)bh * T * T;
  for (int s0 = 0; s0 < T; s0 += kKeys) {
    __syncthreads();
    stage(s0);
    __syncthreads();
    const int n = min(kKeys, T - s0);
    for (int si = 0; si < n; ++si) {
      const float x = score(s0, si);
      if (live) ob[(size_t)(s0 + si) * T + t] = __float2bfloat16(expf(x - m) / l);
    }
  }
}

template <int QD, int PD>
cudaError_t attn_weights(const bf16* proj, const bf16* poslin, const int* lens,
                         bf16* out, int B, int H, int T, int prow, cudaStream_t st) {
  const dim3 grid((T + kQueries - 1) / kQueries, B * H);
  attn_bf16_kernel<QD, PD><<<grid, kQueries, 0, st>>>(proj, poslin, lens, out, H, T, prow);
  return cudaGetLastError();
}

// ------------------------------------------------------ elementwise passes
// Nonlin gate: v[m, c] = bf16(tanh(s) * v) from pj = [s | v | y] (3 * hna).
__global__ void nonlin_gate_kernel(const bf16* __restrict__ pj, bf16* __restrict__ v,
                                   long long n, int hna) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long m = i / hna;
  const int c = (int)(i % hna);
  const bf16* row = pj + m * 3 * hna;
  v[i] = __float2bfloat16(tanhf(bf2f(row[c])) * bf2f(row[hna + c]));
}

// Conv module middle: hg = bf16(a * sigmoid(g)) from pj = [a | g] (2D),
// zero on rows >= lens and outside [0, T); out = bf16(swoosh_r(sum_k
// hg[t + k - halo] * dw[k] + dwb)) with the K-tap sum in f32.
constexpr int kConvRows = 64, kConvCh = 64, kConvThreads = 256;

__global__ void __launch_bounds__(kConvThreads)
dwconv_kernel(const bf16* __restrict__ pj, const bf16* __restrict__ dw,
              const bf16* __restrict__ dwb, const int* __restrict__ lens,
              bf16* __restrict__ out, int T, int D, int K) {
  extern __shared__ float smem[];
  const int halo = (K - 1) / 2, nrows = kConvRows + K - 1;
  float* s_hg = smem;                     // [nrows][kConvCh]
  float* s_dw = smem + nrows * kConvCh;   // [K][kConvCh]
  const int c0 = blockIdx.x * kConvCh, t0 = blockIdx.y * kConvRows, b = blockIdx.z;
  const int len = min(lens[b], T);
  for (int i = threadIdx.x; i < nrows * kConvCh; i += kConvThreads) {
    const int r = i / kConvCh, c = i % kConvCh;
    const int t = t0 - halo + r, gc = c0 + c;
    float v = 0.f;
    if (t >= 0 && t < len && gc < D) {
      const bf16* row = pj + ((size_t)b * T + t) * 2 * D;
      const float g = bf2f(row[D + gc]);
      v = rbf(bf2f(row[gc]) * (1.f / (1.f + expf(-g))));
    }
    s_hg[i] = v;
  }
  for (int i = threadIdx.x; i < K * kConvCh; i += kConvThreads) {
    const int k = i / kConvCh, c = i % kConvCh;
    s_dw[i] = (c0 + c < D) ? bf2f(dw[(size_t)k * D + c0 + c]) : 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x % kConvCh, gc = c0 + c;
  if (gc >= D) return;
  const float bias = bf2f(dwb[gc]);
  for (int r = threadIdx.x / kConvCh; r < kConvRows; r += kConvThreads / kConvCh) {
    const int t = t0 + r;
    if (t >= T) break;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += s_hg[(r + k) * kConvCh + c] * s_dw[k * kConvCh + c];
    out[((size_t)b * T + t) * D + gc] = __float2bfloat16(swoosh_r(acc + bias));
  }
}

// BiasNorm and the final bypass, one warp per row:
// out = x_orig + (x * exp(log_scale) / rms(x - bias) - x_orig) * clip(byp).
__global__ void biasnorm_bypass_kernel(const float* __restrict__ xw,
                                       const float* __restrict__ x_orig,
                                       const float* __restrict__ nbias,
                                       const float* __restrict__ log_scale,
                                       const float* __restrict__ byp,
                                       float* __restrict__ out, int M, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= M) return;
  const float* xr = xw + (size_t)row * D;
  float ss = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = xr[c] - nbias[c];
    ss += d * d;
  }
  ss = warp_sum(ss);
  const float scale = expf(log_scale[0]) / sqrtf(ss / D + 1e-12f);
  for (int c = lane; c < D; c += 32) {
    const size_t o = (size_t)row * D + c;
    const float xo = x_orig[o];
    out[o] = xo + (xr[c] * scale - xo) * fminf(fmaxf(byp[c], 0.f), 1.f);
  }
}

#define SVT_TRY(call)                   \
  do {                                  \
    const cudaError_t e_ = (call);      \
    if (e_ != cudaSuccess) return e_;   \
  } while (0)

cudaError_t run_layer(const float* x, const int* lens, const bf16* pos,
                      const void* const* w, float* out, bf16* proj, bf16* wts,
                      bf16* wa, bf16* wb, bf16* wc, float* ws_x, int B, int T,
                      int D, int H, int qd, int pd, int vd, int hna, int ff1,
                      int ff2, int ff3, int K, int pos_rows, cudaStream_t st) {
  const int M = B * T, P = H * (2 * qd + pd), HV = H * vd;
  const auto* norm_bias = static_cast<const float*>(w[38]);
  const auto* log_scale = static_cast<const float*>(w[39]);
  const auto* byp_mid = static_cast<const float*>(w[40]);
  const auto* byp_out = static_cast<const float*>(w[41]);

  // x_out = x_res + linear(a), optionally followed by the mid bypass
  auto resid = [&](const bf16* a, int kdim, int wi, const float* x_res,
                   const float* byp) -> cudaError_t {
    auto p = linear_args(a, w[wi], w[wi + 1], M, kdim, D);
    p.x_out = ws_x;
    p.x_res = x_res;
    p.x_orig = x;
    p.byp = byp;
    p.ldx = D;
    return gemm<bf16, kResid>(p, 1, st);
  };
  // linear of an f32 [M, D] stream into a bf16 [M, n] buffer
  auto proj_from = [&](const float* xi, int wi, int n, bf16* o,
                       bool swoosh) -> cudaError_t {
    auto p = linear_args(xi, w[wi], w[wi + 1], M, D, n);
    p.out = o;
    p.ldo = n;
    return swoosh ? gemm<float, kSwooshL>(p, 1, st) : gemm<float, kStore>(p, 1, st);
  };
  auto ff = [&](const float* xi, int wi, int f, const float* byp) -> cudaError_t {
    SVT_TRY(proj_from(xi, wi, f, wa, true));
    return resid(wa, f, wi + 2, xi, byp);
  };
  // attend: o[b, t, h*vd + c] = sum_s wts[b, h, s, t] v[b, s, h*vd + c]
  auto self_attn = [&](int wi) -> cudaError_t {
    SVT_TRY(proj_from(ws_x, wi, HV, wa, false));
    GemmArgs p = {};
    p.a = wts;
    p.a_m = 1;
    p.a_k = T;
    p.a_z1 = (long long)H * T * T;
    p.a_z2 = (long long)T * T;
    p.b = wa;
    p.b_k = HV;
    p.b_n = 1;
    p.b_z1 = (long long)T * HV;
    p.b_z2 = vd;
    p.M = T;
    p.N = vd;
    p.K = T;
    p.zdiv = H;
    p.c_rows = T;
    p.c_cols = vd;
    p.out = wb;
    p.ldo = HV;
    SVT_TRY((gemm<bf16, kStore>(p, B * H, st)));
    return resid(wb, HV, wi + 2, ws_x, nullptr);
  };
  auto conv = [&](int wi) -> cudaError_t {
    SVT_TRY(proj_from(ws_x, wi, 2 * D, wa, false));
    const size_t smem = (size_t)(kConvRows + 2 * K - 1) * kConvCh * sizeof(float);
    SVT_TRY(cudaFuncSetAttribute(dwconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem));
    const dim3 grid((D + kConvCh - 1) / kConvCh, (T + kConvRows - 1) / kConvRows, B);
    dwconv_kernel<<<grid, kConvThreads, smem, st>>>(
        wa, static_cast<const bf16*>(w[wi + 2]), static_cast<const bf16*>(w[wi + 3]), lens,
        wb, T, D, K);
    SVT_TRY(cudaGetLastError());
    return resid(wb, D, wi + 4, ws_x, nullptr);
  };

  // attention projection and the shared weights, from the pre-layer x
  SVT_TRY(proj_from(x, 0, P, proj, false));
  if (qd == 32)
    SVT_TRY((attn_weights<32, 4>(proj, pos, lens, wts, B, H, T, pos_rows, st)));
  else
    SVT_TRY((attn_weights<16, 4>(proj, pos, lens, wts, B, H, T, pos_rows, st)));
  // ff1 reads the layer input and starts the residual stream ws_x
  SVT_TRY(ff(x, 14, ff1, nullptr));
  // nonlin attention on head 0: gate, attend with the y-gate, out_proj
  SVT_TRY(proj_from(ws_x, 2, 3 * hna, wa, false));
  const long long n_gate = (long long)M * hna;
  nonlin_gate_kernel<<<(unsigned)((n_gate + 255) / 256), 256, 0, st>>>(wa, wb, n_gate, hna);
  SVT_TRY(cudaGetLastError());
  GemmArgs p = {};
  p.a = wts;  // head 0
  p.a_m = 1;
  p.a_k = T;
  p.a_z1 = (long long)H * T * T;
  p.b = wb;
  p.b_k = hna;
  p.b_n = 1;
  p.b_z1 = (long long)T * hna;
  p.M = T;
  p.N = hna;
  p.K = T;
  p.zdiv = 1;
  p.c_rows = T;
  p.out = wc;
  p.ldo = hna;
  p.ygate = wa + 2 * hna;
  p.ldy = 3 * hna;
  SVT_TRY((gemm<bf16, kYGate>(p, B, st)));
  SVT_TRY(resid(wc, hna, 4, ws_x, nullptr));
  SVT_TRY(self_attn(6));                // self-attention 1
  SVT_TRY(conv(26));                    // conv 1
  SVT_TRY(ff(ws_x, 18, ff2, byp_mid));  // ff2, then the mid bypass
  SVT_TRY(self_attn(10));               // self-attention 2
  SVT_TRY(conv(32));                    // conv 2
  SVT_TRY(ff(ws_x, 22, ff3, nullptr));  // ff3
  biasnorm_bypass_kernel<<<(M * 32 + 255) / 256, 256, 0, st>>>(ws_x, x, norm_bias, log_scale,
                                                               byp_out, out, M, D);
  return cudaGetLastError();
}

#undef SVT_TRY

}  // namespace

// weights: a HOST array of 42 device pointers in the TPU kernel's operand
// order (see ZipformerLayer.kernel_layout): bf16 weights [d_in, d_out] and
// [n] biases, depthwise kernels [K, D], then f32 norm bias, log-scale, mid
// and final bypass scales. poslin: [H, pos_rows, pd] bf16. Workspaces:
// ws_proj [B*T, H*(2qd+pd)], ws_w [B, H, T, T], ws_a [B*T, max(ff, 3hna,
// 2D, H*vd)], ws_b [B*T, max(hna, H*vd, D)], ws_c [B*T, max(hna, H*vd)],
// all bf16, and ws_x [B*T, D] f32.
extern "C" int svt_encoder_layer_bf16(
    const float* x, const int* lens, const void* poslin, const void* const* w,
    float* out, void* ws_proj, void* ws_w, void* ws_a, void* ws_b, void* ws_c,
    float* ws_x, int B, int T, int D, int H, int qd, int pd, int vd, int hna,
    int ff1, int ff2, int ff3, int K, int pos_rows, void* stream) {
  if (B < 1 || T < 1 || D < 1 || H < 1 || vd < 1 || hna < 1 || K < 1 || K % 2 == 0 ||
      pd != 4 || (qd != 32 && qd != 16) || pos_rows < 2 * T - 1)
    return (int)cudaErrorInvalidValue;
  return (int)run_layer(x, lens, static_cast<const bf16*>(poslin), w, out,
                        static_cast<bf16*>(ws_proj), static_cast<bf16*>(ws_w),
                        static_cast<bf16*>(ws_a), static_cast<bf16*>(ws_b),
                        static_cast<bf16*>(ws_c), ws_x, B, T, D, H, qd, pd, vd, hna,
                        ff1, ff2, ff3, K, pos_rows, (cudaStream_t)stream);
}
