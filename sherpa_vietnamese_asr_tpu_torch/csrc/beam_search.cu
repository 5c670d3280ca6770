// RNN-T modified beam search over all frames of a chunk batch, one launch.
//
// Replaces: sherpa_vietnamese_asr_tpu/ops/beam_search_pallas.py _beam_kernel
// (launcher beam_search_batch_pallas), the TPU kernel that runs the frame
// axis as a sequential grid with the beam state resident in VMEM, and the
// backward walk over its per-frame records that follows it, including the
// kernel's hotword branch (`with_hw`).
//
// Semantics (the plain twin is ops/beam_search.py): per frame, the stateless
// decoder on each beam's 2-token context, the joiner, log-softmax, an exact
// top-`beam` over beam x vocab candidates ordered by (score descending, flat
// index ascending), parent gather and token append, log-add merge of beams
// with identical emitted sequences, entropy metrics of each parent's logits
// (margin 0 on an exact probability tie); frames past a chunk's length are
// no-ops; length-normalised selection at the end.
//
// Hotwords (S > 0): each beam carries an Aho-Corasick state. After top-k a
// candidate whose token is neither blank nor unk gains delta[parent_state,
// tok] and moves to next_state[parent_state, tok]; blank and unk keep the
// parent's state. The merge log-adds the boosted scores and a merged beam
// keeps the canonical (first) beam's state; the recorded token log-prob
// stays the unboosted one. Before the final arg-max every beam gives back
// node_score[state] (the finalize term), and total_logp is reported after
// it. The dense [S, V] tables are read by index from global memory: one
// 4-byte read of each table per beam per frame, which stays in L2, so the
// branch costs nothing next to the joiner's vocab product. The TPU kernel
// had to fetch table columns through one-hot matmuls and cap S at what
// fits in VMEM; here any S with S * V < 2^31 works.
//
// What bounds it on the H100: latency. Frames are sequential and only one
// block per chunk is busy (8 of 132 SMs at B = 8). Each frame re-reads the
// joiner weights through L2 (wo alone is 4 MB in fp32; wdp and we add 1.5
// MB) and does about 10.4 M multiply-adds, then a dozen block barriers for
// the softmax, the eight top-k passes and the merge. Keeping more SMs busy
// (splitting the vocab product across blocks of a cluster) and keeping wo
// closer than L2 are the first targets for later speed work.
//
// Design: the TPU's sequential grid becomes a loop over frames inside one
// block of 512 threads per chunk. The beam state lives in shared memory:
// the emitted tokens (uint16, double-buffered for the parent gather), the
// lengths, scores and 2-token contexts, next to the [beam, V] logits, the
// joiner hidden rows and the decoder rows (about 124 KB at T = 823, V =
// 2000). The decoder's grouped context conv is evaluated directly (8
// multiply-adds per output) from embedding rows read through L2; the dense
// [D, D] matrices were an MXU device. Top-k is `beam` block-wide arg-max
// passes, each taking the best candidate strictly after the previous winner
// in the total order, so ties go to the lowest flat index without marking.
// Per-frame records (parent, token, token log-prob, parent metrics) go to
// global memory and thread 0 walks them backwards after the last frame.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBeam = 8;
constexpr int kMaxCtx = 4;
constexpr int kVPerThread = 4;
constexpr float kNegInf = -1e30f;
constexpr float kAlpha = 1.0f / 3.0f;
constexpr float kTsallisScale = -1.5f;  // 1 / (alpha - 1)

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads, 1)
beam_kernel(const float* __restrict__ enc, const int* __restrict__ lens,
            const float* __restrict__ emb, const float* __restrict__ conv_w,
            const float* __restrict__ we, const float* __restrict__ be,
            const float* __restrict__ wdp, const float* __restrict__ bdp,
            const float* __restrict__ wo, const float* __restrict__ bo,
            const int* __restrict__ hw_next, const float* __restrict__ hw_delta,
            const float* __restrict__ hw_node,
            int* rec_par, int* rec_tok, float* rec_lp, float* rec_met,
            int* out_tokens, int* out_frames, float* out_tok_logp,
            float* out_entropy, int* out_n, float* out_logp, int T, int E,
            int D, int ipg, int K, int J, int V, int beam, int blank, int unk,
            int S, float tsallis_max, float max_entropy) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lp = reinterpret_cast<float*>(smem);     // [kMaxBeam][V] logits -> log-probs
  float* s_h = s_lp + kMaxBeam * V;                 // [J][kMaxBeam] joiner hidden
  float* s_dec = s_h + kMaxBeam * J;                // [D][kMaxBeam] decoder out
  float* s_enc = s_dec + kMaxBeam * D;              // [E] encoder frame
  unsigned short* s_tok = reinterpret_cast<unsigned short*>(s_enc + E);  // [2][kMaxBeam][T]

  __shared__ float s_logp[kMaxBeam];
  __shared__ int s_n[kMaxBeam];
  __shared__ int s_ctx[kMaxBeam][kMaxCtx];
  __shared__ int s_hi[kMaxBeam], s_tk[kMaxBeam], s_newn[kMaxBeam];
  __shared__ int s_newctx[kMaxBeam][kMaxCtx];
  __shared__ float s_score[kMaxBeam];
  __shared__ float s_boost[kMaxBeam];             // s_score + hotword delta
  __shared__ int s_hw[kMaxBeam], s_newhw[kMaxBeam];  // automaton states
  __shared__ float s_met[kMaxBeam][4];
  __shared__ bool s_eq[kMaxBeam][kMaxBeam];
  __shared__ float s_red_s[kWarps];
  __shared__ int s_red_i[kWarps];
  __shared__ int s_cur, s_best;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(lens[b], T);
  const int groups = D / ipg, opg = D / groups;

  if (tid < kMaxBeam) {
    s_logp[tid] = tid == 0 ? 0.f : kNegInf;
    s_n[tid] = 0;
    s_hw[tid] = 0;  // the automaton's root
    for (int k = 0; k < kMaxCtx; ++k) s_ctx[tid][k] = 0;  // [-1, 0] + ys, >= 0
  }
  if (tid == 0) s_cur = 0;
  __syncthreads();

  for (int t = 0; t < len; ++t) {
    const unsigned short* tok_old = s_tok + s_cur * kMaxBeam * T;
    unsigned short* tok_new = s_tok + (s_cur ^ 1) * kMaxBeam * T;

    // ---- encoder frame and the decoder's grouped context conv + ReLU ----
    for (int e = tid; e < E; e += kThreads) s_enc[e] = enc[((size_t)b * T + t) * E + e];
    for (int o = tid; o < D; o += kThreads) {
      const int g = o / opg;
      float acc[kMaxBeam];
#pragma unroll
      for (int bb = 0; bb < kMaxBeam; ++bb) acc[bb] = 0.f;
      for (int k = 0; k < K; ++k)
        for (int i = 0; i < ipg; ++i) {
          const float w = __ldg(conv_w + ((size_t)o * ipg + i) * K + k);
          const int c = g * ipg + i;
#pragma unroll
          for (int bb = 0; bb < kMaxBeam; ++bb)
            acc[bb] = fmaf(__ldg(emb + (size_t)s_ctx[bb][k] * D + c), w, acc[bb]);
        }
#pragma unroll
      for (int bb = 0; bb < kMaxBeam; ++bb) s_dec[o * kMaxBeam + bb] = fmaxf(acc[bb], 0.f);
    }
    __syncthreads();

    // ---- joiner projections: h = tanh(enc @ we + be + dec @ wdp + bdp) ----
    for (int jj = tid; jj < J; jj += kThreads) {
      float ej = 0.f;
      for (int e = 0; e < E; ++e) ej = fmaf(s_enc[e], __ldg(we + (size_t)e * J + jj), ej);
      ej += __ldg(be + jj);
      float acc[kMaxBeam];
#pragma unroll
      for (int bb = 0; bb < kMaxBeam; ++bb) acc[bb] = 0.f;
      for (int o = 0; o < D; ++o) {
        const float w = __ldg(wdp + (size_t)o * J + jj);
        const float4 d0 = *reinterpret_cast<const float4*>(s_dec + o * kMaxBeam);
        const float4 d1 = *reinterpret_cast<const float4*>(s_dec + o * kMaxBeam + 4);
        acc[0] = fmaf(d0.x, w, acc[0]); acc[1] = fmaf(d0.y, w, acc[1]);
        acc[2] = fmaf(d0.z, w, acc[2]); acc[3] = fmaf(d0.w, w, acc[3]);
        acc[4] = fmaf(d1.x, w, acc[4]); acc[5] = fmaf(d1.y, w, acc[5]);
        acc[6] = fmaf(d1.z, w, acc[6]); acc[7] = fmaf(d1.w, w, acc[7]);
      }
      const float bj = __ldg(bdp + jj);
#pragma unroll
      for (int bb = 0; bb < kMaxBeam; ++bb)
        s_h[jj * kMaxBeam + bb] = tanhf((acc[bb] + bj) + ej);
    }
    __syncthreads();

    // ---- vocab logits: [beam, J] x [J, V] ----
    for (int v0 = 0; v0 < V; v0 += kVPerThread * kThreads) {
      float acc[kVPerThread][kMaxBeam];
      int vv[kVPerThread];
#pragma unroll
      for (int r = 0; r < kVPerThread; ++r) {
        vv[r] = min(v0 + r * kThreads + tid, V - 1);
#pragma unroll
        for (int bb = 0; bb < kMaxBeam; ++bb) acc[r][bb] = 0.f;
      }
      for (int j = 0; j < J; ++j) {
        const float4 h0 = *reinterpret_cast<const float4*>(s_h + j * kMaxBeam);
        const float4 h1 = *reinterpret_cast<const float4*>(s_h + j * kMaxBeam + 4);
        const float hb[kMaxBeam] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int r = 0; r < kVPerThread; ++r) {
          const float w = __ldg(wo + (size_t)j * V + vv[r]);
#pragma unroll
          for (int bb = 0; bb < kMaxBeam; ++bb) acc[r][bb] = fmaf(hb[bb], w, acc[r][bb]);
        }
      }
#pragma unroll
      for (int r = 0; r < kVPerThread; ++r) {
        const int v = v0 + r * kThreads + tid;
        if (v < V) {
          const float bv = __ldg(bo + v);
#pragma unroll
          for (int bb = 0; bb < kMaxBeam; ++bb) s_lp[bb * V + v] = acc[r][bb] + bv;
        }
      }
    }
    __syncthreads();

    // ---- per-beam log-softmax and entropy metrics (one warp per beam) ----
    if (warp < beam) {
      float* row = s_lp + warp * V;
      float m = -INFINITY;
      for (int v = lane; v < V; v += 32) m = fmaxf(m, row[v]);
      m = warp_max(m);
      float se = 0.f;
      for (int v = lane; v < V; v += 32) se += expf(row[v] - m);
      se = warp_sum(se);
      const float lse = logf(se);
      float ent = 0.f, ts = 0.f, p1 = -1.f, p2 = -1.f;
      for (int v = lane; v < V; v += 32) {
        const float z = row[v] - m;
        const float p = expf(z) / se;
        ent += p * logf(p + 1e-30f);
        ts += powf(p, kAlpha);
        if (p > p1) { p2 = p1; p1 = p; } else if (p > p2) { p2 = p; }
        row[v] = z - lse;
      }
      ent = warp_sum(ent);
      ts = warp_sum(ts);
      for (int o = 16; o > 0; o >>= 1) {  // merge top-2 (values; ties kept)
        const float q1 = __shfl_xor_sync(0xffffffffu, p1, o);
        const float q2 = __shfl_xor_sync(0xffffffffu, p2, o);
        const float hi = fmaxf(p1, q1);
        p2 = fmaxf(fminf(p1, q1), fmaxf(p2, q2));
        p1 = hi;
      }
      if (lane == 0) {
        s_met[warp][0] = (kTsallisScale * (1.f - ts)) / tsallis_max;
        s_met[warp][1] = p1 - p2;
        s_met[warp][2] = -ent / max_entropy;
        s_met[warp][3] = p1;
      }
    }
    __syncthreads();

    // ---- exact top-beam of lp + logp[parent] over beam x V ----
    float prev_s = INFINITY;
    int prev_i = -1;
    for (int p = 0; p < beam; ++p) {
      float bs = -INFINITY;
      int bi = 0x7fffffff;
      for (int bb = 0; bb < beam; ++bb) {
        const float lp_parent = s_logp[bb];
        for (int v = tid; v < V; v += kThreads) {
          const float s = s_lp[bb * V + v] + lp_parent;
          const int i = bb * V + v;
          if ((s < prev_s || (s == prev_s && i > prev_i)) && better(s, i, bs, bi)) {
            bs = s;
            bi = i;
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float so = __shfl_down_sync(0xffffffffu, bs, o);
        const int io = __shfl_down_sync(0xffffffffu, bi, o);
        if (better(so, io, bs, bi)) { bs = so; bi = io; }
      }
      if (lane == 0) { s_red_s[warp] = bs; s_red_i[warp] = bi; }
      __syncthreads();
      if (warp == 0) {
        bs = lane < kWarps ? s_red_s[lane] : -INFINITY;
        bi = lane < kWarps ? s_red_i[lane] : 0x7fffffff;
        for (int o = 16; o > 0; o >>= 1) {
          const float so = __shfl_down_sync(0xffffffffu, bs, o);
          const int io = __shfl_down_sync(0xffffffffu, bi, o);
          if (better(so, io, bs, bi)) { bs = so; bi = io; }
        }
        if (lane == 0) { s_score[p] = bs; s_hi[p] = bi / V; s_tk[p] = bi % V; }
      }
      __syncthreads();
      prev_s = s_score[p];
      prev_i = s_hi[p] * V + s_tk[p];
    }

    // ---- parent gather, token append, records ----
    for (int j = 0; j < beam; ++j) {
      const int hi = s_hi[j], pn = s_n[hi];
      for (int u = tid; u < pn; u += kThreads)
        tok_new[j * T + u] = tok_old[hi * T + u];
    }
    if (tid < beam) {
      const int j = tid, hi = s_hi[j], tk = s_tk[j], pn = s_n[hi];
      const bool is_blank = tk == blank;
      if (!is_blank) tok_new[j * T + pn] = (unsigned short)tk;
      s_newn[j] = pn + (is_blank ? 0 : 1);
      for (int k = 0; k < K; ++k)
        s_newctx[j][k] = is_blank ? s_ctx[hi][k]
                                  : (k + 1 < K ? s_ctx[hi][k + 1] : tk);
      const int p_hw = s_hw[hi];
      float boost = 0.f;
      int nhw = p_hw;
      if (S > 0 && !is_blank && tk != unk) {
        const size_t cell = (size_t)p_hw * V + tk;
        boost = hw_delta[cell];
        nhw = hw_next[cell];
      }
      s_boost[j] = s_score[j] + boost;
      s_newhw[j] = nhw;
      const size_t r = ((size_t)b * T + t) * beam + j;
      rec_par[r] = hi;
      rec_tok[r] = tk;
      rec_lp[r] = s_lp[hi * V + tk];
      for (int q = 0; q < 4; ++q) rec_met[r * 4 + q] = s_met[hi][q];
    }
    __syncthreads();

    // ---- dedup: which new beams carry identical sequences (warp per pair) ----
    for (int pr = warp; pr < beam * beam; pr += kWarps) {
      const int i = pr / beam, j = pr % beam;
      if (i >= j) continue;
      const int n = s_newn[i];
      bool same = n == s_newn[j];
      if (same)
        for (int u = lane; u < n; u += 32)
          same = same && tok_new[i * T + u] == tok_new[j * T + u];
      same = __all_sync(0xffffffffu, same);
      if (lane == 0) s_eq[i][j] = same;
    }
    __syncthreads();

    // ---- log-add merge into the first beam of each group; commit state ----
    if (tid == 0) {
      int canon[kMaxBeam];
      for (int j = 0; j < beam; ++j) {
        canon[j] = j;
        for (int i = 0; i < j; ++i)
          if (s_eq[i][j]) { canon[j] = i; break; }
      }
      for (int i = 0; i < beam; ++i) {
        float m = kNegInf;
        for (int j = 0; j < beam; ++j) m = fmaxf(m, canon[j] == i ? s_boost[j] : kNegInf);
        float se = 0.f;
        for (int j = 0; j < beam; ++j) se += expf((canon[j] == i ? s_boost[j] : kNegInf) - m);
        s_logp[i] = canon[i] == i ? m + logf(se) : kNegInf;
        s_n[i] = s_newn[i];
        s_hw[i] = s_newhw[i];
        for (int k = 0; k < K; ++k) s_ctx[i][k] = s_newctx[i][k];
      }
      s_cur ^= 1;
    }
    __syncthreads();
  }

  // ---- finalize (hotwords) and length-normalised selection ----
  if (tid == 0) {
    if (S > 0)
      for (int j = 0; j < beam; ++j) s_logp[j] -= hw_node[s_hw[j]];
    int best = 0;
    float best_v = -INFINITY;
    for (int j = 0; j < beam; ++j) {
      const float v = s_logp[j] / (float)max(s_n[j] + K, 1);
      if (v > best_v) { best_v = v; best = j; }
    }
    s_best = best;
    out_n[b] = s_n[best];
    out_logp[b] = s_logp[best];
  }
  __syncthreads();
  const int best = s_best, n_sel = s_n[best];
  const unsigned short* tok_fin = s_tok + s_cur * kMaxBeam * T;
  for (int u = tid; u < T; u += kThreads) {
    const size_t o = (size_t)b * T + u;
    out_tokens[o] = u < n_sel ? (int)tok_fin[best * T + u] : 0;
    out_frames[o] = 0;
    out_tok_logp[o] = 0.f;
    for (int q = 0; q < 4; ++q) out_entropy[o * 4 + q] = 0.f;
  }
  __syncthreads();

  // ---- backward walk over the records of the selected beam ----
  if (tid == 0) {
    int cur = best, idx = n_sel;
    for (int t = len - 1; t >= 0; --t) {
      const size_t r = ((size_t)b * T + t) * beam + cur;
      if (rec_tok[r] != blank) {
        --idx;
        const size_t o = (size_t)b * T + idx;
        out_frames[o] = t;
        out_tok_logp[o] = rec_lp[r];
        for (int q = 0; q < 4; ++q) out_entropy[o * 4 + q] = rec_met[r * 4 + q];
      }
      cur = rec_par[r];
    }
  }
}

}  // namespace

extern "C" int svt_beam_search(
    const float* enc, const int* lens, const float* emb, const float* conv_w,
    const float* we, const float* be, const float* wdp, const float* bdp,
    const float* wo, const float* bo, const int* hw_next, const float* hw_delta,
    const float* hw_node, int* rec_par, int* rec_tok, float* rec_lp,
    float* rec_met, int* out_tokens, int* out_frames, float* out_tok_logp,
    float* out_entropy, int* out_n, float* out_logp, int B, int T, int E, int D,
    int ipg, int K, int J, int V, int beam, int blank, int unk, int S,
    float tsallis_max, float max_entropy, void* stream) {
  if (beam < 1 || beam > kMaxBeam || K < 1 || K > kMaxCtx || V < 2 ||
      V > 65536 || D % ipg != 0 || S < 0 || (long long)S * V >= (1LL << 31) ||
      (S > 0 && (!hw_next || !hw_delta || !hw_node)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kMaxBeam * V + kMaxBeam * J + kMaxBeam * D + E) * 4 +
                      (size_t)2 * kMaxBeam * T * 2;
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  beam_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      enc, lens, emb, conv_w, we, be, wdp, bdp, wo, bo, hw_next, hw_delta, hw_node,
      rec_par, rec_tok, rec_lp, rec_met, out_tokens, out_frames, out_tok_logp,
      out_entropy, out_n, out_logp, T, E, D, ipg, K, J, V, beam, blank, unk, S,
      tsallis_max, max_entropy);
  return (int)cudaGetLastError();
}
