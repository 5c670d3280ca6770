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
// Design: the TPU's sequential grid becomes a loop over frames, and each
// chunk gets a thread-block cluster of kCluster (8, the portable size)
// blocks of 512 threads that split every frame by vocabulary slice and talk
// through distributed shared memory (DSMEM). Block r owns vocab columns
// [r*W, min(V, (r+1)*W)), W = ceil(V / 8), and joiner columns likewise. Per
// frame, with four cluster barriers:
//   1. every block reads the parents' contexts and scores from the leader
//      (rank 0) and evaluates the decoder's grouped context conv + ReLU
//      itself (8 multiply-adds per output, embedding rows through L2);
//   2. each block computes its J/8 columns of the joiner's hidden layer
//      h = tanh(enc.we + be + dec.wdp + bdp); barrier; each copies the
//      whole [J, beam] h from its peers;
//   3. each block takes its slice's logits [beam, J] x [J, V/8] + bo in
//      plain fp32 FMA (wo read through L2), then each row's slice max and
//      sum of exp; barrier; every block combines the 8 partials into the
//      row's lse, turns its slice into log-probs, and takes the slice's
//      entropy, Tsallis and top-2 probability terms (ties kept) and its local
//      exact top-beam (per warp by passes, then over the warps' lists), each
//      candidate with its unboosted log-prob; barrier;
//   4. the leader merges the 8 local lists into the exact global top-beam
//      (the global top-beam lies in the union of the local ones) and the
//      metric partials, then runs the parent gather, token append, hotword
//      step, records, dedup and log-add merge; barrier: the new contexts
//      and scores are published.
// Only the leader holds the emitted tokens (uint16, double-buffered for the
// parent gather); every block holds its [beam, V/8] logit slice, the [J,
// beam] hidden layer and the [D, beam] decoder rows (about 86 KB at T =
// 823, V = 2000). Per-frame records (parent, token, token log-prob, parent
// metrics) go to global memory and the leader walks them backwards after
// the last frame.
//
// SVT_BEAM_CUT (default 0, the kernel as shipped) is a timing instrument:
// a build with bit kCutVocab, kCutHidden, kCutLeader or kCutTopk set skips
// that step of every frame and gives wrong results; tools/beam_stages.py
// times such builds to split a frame's time by step.
//
// What bounds it on the H100: latency. Frames are sequential; each frame
// costs 10.4 M multiply-adds per chunk (8 M of them the vocab product) and a
// re-read of the joiner weights through L2 (wo alone is 4 MB in fp32), now
// spread over 64 SMs at B = 8 instead of 8, plus four cluster barriers and
// the leader's serial merge. Left for later: wo resident on chip (it does
// not fit one cluster's shared memory in fp32), one vocab product for the
// rows of all chunks as the TPU kernel does, and the leader's merge off the
// frame's critical path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#ifndef SVT_BEAM_CUT
#define SVT_BEAM_CUT 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kCut = SVT_BEAM_CUT;
constexpr int kCutVocab = 1;   // the vocab product
constexpr int kCutHidden = 2;  // the hidden layer's products and exchange
constexpr int kCutLeader = 4;  // the leader's gather, records, dedup and merge
constexpr int kCutTopk = 8;    // slice softmax, metric terms and both top-k merges

constexpr int kCluster = 8;  // blocks per chunk: the portable cluster size
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBeam = 8;
constexpr int kMaxCtx = 4;
constexpr int kHCols = 64;                          // hidden columns per pass
constexpr int kHSplits = kThreads / kHCols;         // 8 partial sums each
constexpr int kVPairs = 128;                        // vocab column pairs per pass
constexpr int kVSplits = kThreads / kVPairs;        // 4 partial sums over J
constexpr int kUnroll = 16;                         // weight loads in flight a thread
constexpr int kRowThreads = kThreads / kMaxBeam;    // top-k: 64 threads a row
constexpr int kScratch = kHSplits * kHCols * (kMaxBeam + 1);  // floats
constexpr int kNoIndex = 0x7fffffff;
constexpr float kNegInf = -1e30f;
constexpr float kAlpha = 1.0f / 3.0f;
constexpr float kTsallisScale = -1.5f;  // 1 / (alpha - 1)
static_assert(kHCols * kMaxBeam == kThreads, "hidden reduce: a thread per (column, beam)");
static_assert(2 * 2 * kMaxBeam * kVPairs <= kScratch, "vocab reduce scratch");
static_assert(kCluster * kMaxBeam == 64, "leader merge: two entries a lane");
static_assert(kWarps * kMaxBeam % 32 == 0, "block merge: whole entries a lane");

__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  return sa > sb || (sa == sb && ia < ib);
}

// Strictly after (prev_s, prev_i) in the order of better().
__device__ __forceinline__ bool after(float s, int i, float prev_s, int prev_i) {
  return s < prev_s || (s == prev_s && i > prev_i);
}

// The warp's best (score, index); every lane ends with it.
__device__ __forceinline__ void warp_best(float& s, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float so = __shfl_xor_sync(0xffffffffu, s, o);
    const int io = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(so, io, s, i)) { s = so; i = io; }
  }
}

// The same with a payload that travels with the winner.
__device__ __forceinline__ void warp_best(float& s, int& i, float& pay) {
  for (int o = 16; o > 0; o >>= 1) {
    const float so = __shfl_xor_sync(0xffffffffu, s, o);
    const int io = __shfl_xor_sync(0xffffffffu, i, o);
    const float po = __shfl_xor_sync(0xffffffffu, pay, o);
    if (better(so, io, s, i)) { s = so; i = io; pay = po; }
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void fma8(float* acc, const float* h, float w) {
  const float4 h0 = *reinterpret_cast<const float4*>(h);
  const float4 h1 = *reinterpret_cast<const float4*>(h + 4);
  acc[0] = fmaf(h0.x, w, acc[0]); acc[1] = fmaf(h0.y, w, acc[1]);
  acc[2] = fmaf(h0.z, w, acc[2]); acc[3] = fmaf(h0.w, w, acc[3]);
  acc[4] = fmaf(h1.x, w, acc[4]); acc[5] = fmaf(h1.y, w, acc[5]);
  acc[6] = fmaf(h1.z, w, acc[6]); acc[7] = fmaf(h1.w, w, acc[7]);
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
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const bool leader = rank == 0;
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(lens[b], T);
  const int groups = D / ipg, opg = D / groups;
  const int W = (V + kCluster - 1) / kCluster;  // vocab slice stride
  const int v_lo = min(V, rank * W), width = min(V, v_lo + W) - v_lo;
  const int JW = (J + kCluster - 1) / kCluster;  // hidden slice stride
  const int j_lo = min(J, rank * JW), j_n = min(J, j_lo + JW) - j_lo;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_lp = reinterpret_cast<float*>(smem);     // [kMaxBeam][W] slice logits -> log-probs
  float* s_h = s_lp + kMaxBeam * W;                 // [J][kMaxBeam] joiner hidden, whole
  float* s_dec = s_h + kMaxBeam * J;                // [D][kMaxBeam] decoder out
  float* s_scr = s_dec + kMaxBeam * D;              // [kScratch] partial sums
  float* s_enc = s_scr + kScratch;                  // [E] encoder frame
  unsigned short* s_tok = reinterpret_cast<unsigned short*>(s_enc + E);  // leader: [2][kMaxBeam][T]

  // Beam state: the leader's is the state, a peer's a copy of it per frame.
  __shared__ float s_logp[kMaxBeam];
  __shared__ int s_ctx[kMaxBeam][kMaxCtx];
  // Published to the cluster each frame, one vector load per peer each.
  __shared__ float2 s_part[kMaxBeam];             // slice max, slice sum of exp
  __shared__ float4 s_mpart[kMaxBeam];            // slice entropy, Tsallis, p1, p2
  __shared__ float4 s_cand[kMaxBeam];             // local top-beam: score, index bits, log-prob
  __shared__ float s_ws[kWarps][kMaxBeam];        // per-warp top-beam lists
  __shared__ int s_wi[kWarps][kMaxBeam];
  // The leader's own.
  __shared__ int s_n[kMaxBeam];
  __shared__ int s_hi[kMaxBeam], s_tk[kMaxBeam], s_newn[kMaxBeam];
  __shared__ int s_newctx[kMaxBeam][kMaxCtx];
  __shared__ float s_score[kMaxBeam], s_sel_lp[kMaxBeam];
  __shared__ float s_boost[kMaxBeam];             // s_score + hotword delta
  __shared__ int s_hw[kMaxBeam], s_newhw[kMaxBeam];  // automaton states
  __shared__ float s_met[kMaxBeam][4];
  __shared__ bool s_eq[kMaxBeam][kMaxBeam];
  __shared__ int s_cur, s_best;

  if (tid < kMaxBeam) {
    s_logp[tid] = tid == 0 ? 0.f : kNegInf;
    s_n[tid] = 0;
    s_hw[tid] = 0;  // the automaton's root
    for (int k = 0; k < kMaxCtx; ++k) s_ctx[tid][k] = 0;  // [-1, 0] + ys, >= 0
  }
  if (tid == 0) s_cur = 0;
  cluster.sync();  // every block of the cluster has started: DSMEM is live

  for (int t = 0; t < len; ++t) {
    // ---- the parents' contexts and scores, from the leader ----
    if (!leader && tid < kMaxBeam) {
      s_logp[tid] = *cluster.map_shared_rank(&s_logp[tid], 0);
      for (int k = 0; k < K; ++k) s_ctx[tid][k] = *cluster.map_shared_rank(&s_ctx[tid][k], 0);
    }
    for (int e = tid; e < E; e += kThreads) s_enc[e] = enc[((size_t)b * T + t) * E + e];
    __syncthreads();

    // ---- the decoder's grouped context conv + ReLU, all of it ----
    for (int o = tid; o < D; o += kThreads) {
      const int g = o / opg;
      float acc[kMaxBeam];
#pragma unroll
      for (int bb = 0; bb < kMaxBeam; ++bb) acc[bb] = 0.f;
      for (int k = 0; k < K; ++k)
#pragma unroll 4
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

    // ---- this block's hidden columns: h = tanh(enc @ we + be + dec @ wdp + bdp) ----
    for (int c0 = 0; c0 < j_n; c0 += kHCols) {
      const int col = tid % kHCols, sp = tid / kHCols;
      const int j = j_lo + min(c0 + col, j_n - 1);
      float ej = 0.f, acc[kMaxBeam];
#pragma unroll
      for (int bb = 0; bb < kMaxBeam; ++bb) acc[bb] = 0.f;
      // Rows sp, sp + 8, ... of we and wdp, kUnroll loads issued at a time.
      int e = kCut & kCutHidden ? E : sp;
      for (; e + (kUnroll - 1) * kHSplits < E; e += kUnroll * kHSplits) {
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(we + (size_t)(e + u * kHSplits) * J + j);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) ej = fmaf(s_enc[e + u * kHSplits], w[u], ej);
      }
      for (; e < E; e += kHSplits) ej = fmaf(s_enc[e], __ldg(we + (size_t)e * J + j), ej);
      int o = kCut & kCutHidden ? D : sp;
      for (; o + (kUnroll - 1) * kHSplits < D; o += kUnroll * kHSplits) {
        float w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) w[u] = __ldg(wdp + (size_t)(o + u * kHSplits) * J + j);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) fma8(acc, s_dec + (o + u * kHSplits) * kMaxBeam, w[u]);
      }
      for (; o < D; o += kHSplits) fma8(acc, s_dec + o * kMaxBeam, __ldg(wdp + (size_t)o * J + j));
      float* part = s_scr + (sp * kHCols + col) * (kMaxBeam + 1);
#pragma unroll
      for (int bb = 0; bb < kMaxBeam; ++bb) part[bb] = acc[bb];
      part[kMaxBeam] = ej;
      __syncthreads();
      const int cc = tid / kMaxBeam, bb = tid % kMaxBeam;
      if (c0 + cc < j_n) {
        float a = 0.f, ea = 0.f;
        for (int q = 0; q < kHSplits; ++q) {
          const float* p = s_scr + (q * kHCols + cc) * (kMaxBeam + 1);
          a += p[bb];
          ea += p[kMaxBeam];
        }
        const int jj = j_lo + c0 + cc;
        s_h[jj * kMaxBeam + bb] = tanhf((a + __ldg(bdp + jj)) + (ea + __ldg(be + jj)));
      }
      __syncthreads();
    }
    cluster.sync();  // (1) every block's hidden columns are written

    // ---- the whole hidden layer, from the peers ----
    for (int i = tid; i < J * kMaxBeam / 4 && !(kCut & kCutHidden); i += kThreads) {
      const int r = (i * 4 / kMaxBeam) / JW;
      if (r != rank)
        reinterpret_cast<float4*>(s_h)[i] =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(s_h, r))[i];
    }
    __syncthreads();

    // ---- this block's vocab slice: [beam, J] x [J, width] + bo ----
    for (int c0 = 0; c0 < width; c0 += 2 * kVPairs) {
      const int g = tid % kVPairs, sp = tid / kVPairs;
      const int va = v_lo + min(c0 + g, width - 1);
      const int vb = v_lo + min(c0 + g + kVPairs, width - 1);
      const int jn = (J + kVSplits - 1) / kVSplits, ja = min(J, sp * jn), jz = min(J, ja + jn);
      float acc_a[kMaxBeam], acc_b[kMaxBeam];
#pragma unroll
      for (int bb = 0; bb < kMaxBeam; ++bb) acc_a[bb] = acc_b[bb] = 0.f;
      int j = kCut & kCutVocab ? jz : ja;
      for (; j + kUnroll <= jz; j += kUnroll) {
        float wa[kUnroll], wb[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          wa[u] = __ldg(wo + (size_t)(j + u) * V + va);
          wb[u] = __ldg(wo + (size_t)(j + u) * V + vb);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          fma8(acc_a, s_h + (j + u) * kMaxBeam, wa[u]);
          fma8(acc_b, s_h + (j + u) * kMaxBeam, wb[u]);
        }
      }
      for (; j < jz; ++j) {
        fma8(acc_a, s_h + j * kMaxBeam, __ldg(wo + (size_t)j * V + va));
        fma8(acc_b, s_h + j * kMaxBeam, __ldg(wo + (size_t)j * V + vb));
      }
      // The four partial sums over J, added as (s0 + s2) + (s1 + s3).
      float* red = s_scr;  // [2 splits][2 columns][kMaxBeam][kVPairs]
      if (sp >= 2)
#pragma unroll
        for (int bb = 0; bb < kMaxBeam; ++bb) {
          red[(((sp - 2) * 2 + 0) * kMaxBeam + bb) * kVPairs + g] = acc_a[bb];
          red[(((sp - 2) * 2 + 1) * kMaxBeam + bb) * kVPairs + g] = acc_b[bb];
        }
      __syncthreads();
      if (sp < 2)
#pragma unroll
        for (int bb = 0; bb < kMaxBeam; ++bb) {
          acc_a[bb] += red[((sp * 2 + 0) * kMaxBeam + bb) * kVPairs + g];
          acc_b[bb] += red[((sp * 2 + 1) * kMaxBeam + bb) * kVPairs + g];
        }
      __syncthreads();
      if (sp == 1)
#pragma unroll
        for (int bb = 0; bb < kMaxBeam; ++bb) {
          red[(0 * kMaxBeam + bb) * kVPairs + g] = acc_a[bb];
          red[(1 * kMaxBeam + bb) * kVPairs + g] = acc_b[bb];
        }
      __syncthreads();
      if (sp == 0) {
        const int ca = c0 + g, cb = c0 + g + kVPairs;
#pragma unroll
        for (int bb = 0; bb < kMaxBeam; ++bb) {
          if (ca < width)
            s_lp[bb * W + ca] = (acc_a[bb] + red[(0 * kMaxBeam + bb) * kVPairs + g]) + __ldg(bo + va);
          if (cb < width)
            s_lp[bb * W + cb] = (acc_b[bb] + red[(1 * kMaxBeam + bb) * kVPairs + g]) + __ldg(bo + vb);
        }
      }
      __syncthreads();
    }

    // ---- each row's slice max and sum of exp (one warp per beam row) ----
    if (warp < beam && !(kCut & kCutTopk)) {
      const float* row = s_lp + warp * W;
      float m = -INFINITY;
      for (int c = lane; c < width; c += 32) m = fmaxf(m, row[c]);
      m = warp_max(m);
      float se = 0.f;
      for (int c = lane; c < width; c += 32) se += expf(row[c] - m);
      se = warp_sum(se);
      if (lane == 0) s_part[warp] = make_float2(m, se);
    }
    cluster.sync();  // (2) every slice's partials are written

    // ---- row lse from the partials (in rank order); slice log-probs and metric terms ----
    if (warp < beam && !(kCut & kCutTopk)) {
      const float2 q = lane < kCluster ? *cluster.map_shared_rank(&s_part[warp], lane)
                                       : make_float2(-INFINITY, 0.f);
      const float m = warp_max(q.x);
      const float term = lane < kCluster ? q.y * expf(q.x - m) : 0.f;
      float se = 0.f;
      for (int r = 0; r < kCluster; ++r) se += __shfl_sync(0xffffffffu, term, r);
      const float lse = logf(se);
      float* row = s_lp + warp * W;
      float ent = 0.f, ts = 0.f, p1 = -1.f, p2 = -1.f;
      for (int c = lane; c < width; c += 32) {
        const float z = row[c] - m;
        const float p = expf(z) / se;
        ent += p * logf(p + 1e-30f);
        ts += powf(p, kAlpha);
        if (p > p1) { p2 = p1; p1 = p; } else if (p > p2) { p2 = p; }
        row[c] = z - lse;
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
      if (lane == 0) s_mpart[warp] = make_float4(ent, ts, p1, p2);
    }
    __syncthreads();

    // ---- local exact top-beam of lp + logp[parent] over beam x width ----
    if (!(kCut & kCutTopk)) {
      // 64 threads a row: warp w scans row w / 2, columns (w % 2) * 32 + lane + 64k.
      const int bb = tid / kRowThreads;
      const float lp_parent = bb < beam ? s_logp[bb] : 0.f;
      const float* row = s_lp + bb * W;
      float prev_s = INFINITY;
      int prev_i = -1;
      for (int p = 0; p < beam; ++p) {
        float bs = -INFINITY;
        int bi = kNoIndex;
        if (bb < beam)
          for (int c = tid % kRowThreads; c < width; c += kRowThreads) {
            const float s = row[c] + lp_parent;
            const int i = bb * V + v_lo + c;
            if (after(s, i, prev_s, prev_i) && better(s, i, bs, bi)) { bs = s; bi = i; }
          }
        warp_best(bs, bi);
        if (lane == 0) { s_ws[warp][p] = bs; s_wi[warp][p] = bi; }
        prev_s = bs;
        prev_i = bi;
      }
      __syncthreads();
      if (warp == 0) {  // the block's top-beam over the warps' lists
        constexpr int kPer = kWarps * kMaxBeam / 32;  // list entries a lane
        float es[kPer];
        int ei[kPer];
#pragma unroll
        for (int q = 0; q < kPer; ++q) {  // entry e: list e / 8, place e % 8
          const int e = lane + 32 * q;
          const bool ok = e % kMaxBeam < beam;
          es[q] = ok ? s_ws[e / kMaxBeam][e % kMaxBeam] : -INFINITY;
          ei[q] = ok ? s_wi[e / kMaxBeam][e % kMaxBeam] : kNoIndex;
        }
        prev_s = INFINITY;
        prev_i = -1;
        for (int p = 0; p < beam; ++p) {
          float bs = -INFINITY;
          int bi = kNoIndex;
#pragma unroll
          for (int q = 0; q < kPer; ++q)
            if (after(es[q], ei[q], prev_s, prev_i) && better(es[q], ei[q], bs, bi)) {
              bs = es[q];
              bi = ei[q];
            }
          warp_best(bs, bi);
          if (lane == p) {  // with its unboosted log-prob, which only this block has
            const float lp = bi == kNoIndex ? 0.f : s_lp[(bi / V) * W + (bi % V - v_lo)];
            s_cand[p] = make_float4(bs, __int_as_float(bi), lp, 0.f);
          }
          prev_s = bs;
          prev_i = bi;
        }
      }
    }
    cluster.sync();  // (3) every block's top-beam and metric terms are written

    if (leader) {
      if (kCut & kCutTopk) {
        if (tid < beam) { s_score[tid] = 0.f; s_hi[tid] = tid; s_tk[tid] = blank; s_sel_lp[tid] = 0.f; }
      } else if (warp == 0) {
        // ---- exact global top-beam over the kCluster local lists ----
        float es[2], el[2];
        int ei[2];
        for (int q = 0; q < 2; ++q) {  // entry e: rank e / 8, place e % 8
          const int e = lane + 32 * q;
          const float4 c = e % kMaxBeam < beam
                               ? *cluster.map_shared_rank(&s_cand[e % kMaxBeam], e / kMaxBeam)
                               : make_float4(-INFINITY, __int_as_float(kNoIndex), 0.f, 0.f);
          es[q] = c.x;
          ei[q] = __float_as_int(c.y);
          el[q] = c.z;
        }
        float prev_s = INFINITY;
        int prev_i = -1;
        for (int p = 0; p < beam; ++p) {
          float bs = -INFINITY, bl = 0.f;
          int bi = kNoIndex;
          for (int q = 0; q < 2; ++q)
            if (after(es[q], ei[q], prev_s, prev_i) && better(es[q], ei[q], bs, bi)) {
              bs = es[q];
              bi = ei[q];
              bl = el[q];
            }
          warp_best(bs, bi, bl);
          if (lane == 0) {
            s_score[p] = bs;
            s_hi[p] = bi / V;
            s_tk[p] = bi % V;
            s_sel_lp[p] = bl;
          }
          prev_s = bs;
          prev_i = bi;
        }
      } else if (warp <= beam) {
        // ---- parent row warp - 1's metrics from the slices' terms, in rank order ----
        const int row = warp - 1;
        const float4 q = lane < kCluster ? *cluster.map_shared_rank(&s_mpart[row], lane)
                                         : make_float4(0.f, 0.f, -1.f, -1.f);
        float ent = 0.f, ts = 0.f, p1 = -1.f, p2 = -1.f;
        for (int r = 0; r < kCluster; ++r) {
          ent += __shfl_sync(0xffffffffu, q.x, r);
          ts += __shfl_sync(0xffffffffu, q.y, r);
          const float a = __shfl_sync(0xffffffffu, q.z, r);
          const float c = __shfl_sync(0xffffffffu, q.w, r);
          const float hi = fmaxf(p1, a);
          p2 = fmaxf(fminf(p1, a), fmaxf(p2, c));
          p1 = hi;
        }
        if (lane == 0) {
          s_met[row][0] = (kTsallisScale * (1.f - ts)) / tsallis_max;
          s_met[row][1] = p1 - p2;
          s_met[row][2] = -ent / max_entropy;
          s_met[row][3] = p1;
        }
      }
      __syncthreads();

      const unsigned short* tok_old = s_tok + s_cur * kMaxBeam * T;
      unsigned short* tok_new = s_tok + (s_cur ^ 1) * kMaxBeam * T;

      // ---- parent gather, token append, records ----
      for (int j = 0; j < beam && !(kCut & kCutLeader); ++j) {
        const int hi = s_hi[j], pn = s_n[hi];
        for (int u = tid; u < pn; u += kThreads)
          tok_new[j * T + u] = tok_old[hi * T + u];
      }
      if (tid < beam && !(kCut & kCutLeader)) {
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
        rec_lp[r] = s_sel_lp[j];
        for (int q = 0; q < 4; ++q) rec_met[r * 4 + q] = s_met[hi][q];
      }
      __syncthreads();

      // ---- dedup: which new beams carry identical sequences (warp per pair) ----
      for (int pr = warp; pr < beam * beam && !(kCut & kCutLeader); pr += kWarps) {
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
      if (tid == 0 && !(kCut & kCutLeader)) {
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
    }
    cluster.sync();  // (4) the leader's new state is published
  }
  cluster.sync();  // no block leaves while a peer may still read its shared memory
  if (!leader) return;

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
  const int W = (V + kCluster - 1) / kCluster;
  const size_t smem = (size_t)(kMaxBeam * (W + J + D) + kScratch + E) * 4 +
                      (size_t)2 * kMaxBeam * T * 2;
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, beam_kernel, enc, lens, emb, conv_w, we, be, wdp, bdp, wo, bo, hw_next,
      hw_delta, hw_node, rec_par, rec_tok, rec_lp, rec_met, out_tokens, out_frames,
      out_tok_logp, out_entropy, out_n, out_logp, T, E, D, ipg, K, J, V, beam, blank,
      unk, S, tsallis_max, max_entropy);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
