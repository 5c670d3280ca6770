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
// Beam caps: the kernel is a template over its beam cap MB, instantiated at
// 8 and 16; the entry point takes the smallest that holds `beam` and every
// block computes all MB rows (rows past `beam` stay at -1e30). The state
// above lives in shared memory (about 86 and 167 KB at T 823, V 2000, E
// 512).
//
// Beams past 16: beam_kernel_tiled (entry svt_beam_search_tiled). A cap of
// 32 or more cannot keep that layout: at 32 the state would take about 337
// KB, the hidden layer and the decoder rows alone 128 KB each at 64, and
// the per-warp and merge lists of the top-beam live in registers. So the
// tiled kernel runs the beam's rows in tiles of kTile (32) rows through the
// cap steps (decoder_rows, hidden_cols, vocab_slice, the same functions and
// sums at MB 32, where a thread keeps 8 vocab weight loads in flight
// instead of 16), and every array that grows with the beam lives in a
// per-chunk global workspace (`Tiled`, sized by the wrapper through
// svt_beam_tiled_workspace_bytes): the hidden layer of all tiles (each
// block writes its columns, every block reads the tiles back), the slice
// partials, each block's log-probs and candidate scores, the candidate
// lists, the beam state, the token histories (rows padded to 8 tokens,
// copied 16 bytes a thread). A block's shared memory is one tile's hidden
// layer and decoder rows, the tile's logit slice in the decoder rows' space
// (dead once the hidden layer is taken), partial sums and the encoder frame
// (about 196 KB at E 512) plus 5.5 KB of fixed arrays, whatever the beam
// and T. Per frame, with the same four barriers:
//   A. per tile: the decoder rows and the block's hidden columns, written
//      to the workspace; barrier;
//   B. per tile: the whole hidden tile read back, the slice's logits, each
//      row's slice max and sum of exp; barrier;
//   C. per row: lse, log-probs, metric terms and candidate scores; then the
//      slice's exact top-beam without register lists: a radix select of the
//      beam-th largest score key (four passes of an 8-bit digit, block
//      histograms in shared memory), and among the keys equal to it, when
//      they are more than needed, of the needed count of lowest flat
//      indices; the selected candidates are appended unordered; barrier;
//   D. the leader ranks the 8 lists' entries by counting the entries that
//      beat each (keys staged in shared memory 512 at a time); an entry of
//      rank < beam is new beam `rank` (the global top-beam lies in the
//      union of the local ones, so union ranks are global ranks). Then
//      gather, append, hotword step and records as at the caps; the dedup
//      compares two beams' tokens only when their lengths and a 64-bit hash
//      of the emitted sequence (kept on each append) agree, a warp per beam
//      scanning the earlier beams for the first exact match; the log-add
//      merge is the caps' (a thread per beam, sums over j in order).
// Score keys map a float to an unsigned int in the same order (-0 taken as
// +0), and a candidate's key is (score key, ~flat index): the twin's stable
// descending sort exactly, the -1e30 padding candidates included. Run at a
// beam of 16 or less, the tiled kernel computes what the caps compute, bit
// for bit, and at beams 17 to 32 what the cap-32 kernel it replaced
// computed (chip_smoke.py checks both).
//
// SVT_BEAM_CUT (default 0, the kernel as shipped) is a timing instrument:
// a build with bit kCutVocab, kCutHidden, kCutLeader or kCutTopk set skips
// that step of every frame of the cap kernels and gives wrong results;
// tools/beam_stages.py times such builds to split a frame's time by step.
//
// What bounds it on the H100: latency. Frames are sequential; each frame
// costs 10.4 M multiply-adds per chunk at beam 8 (8 M of them the vocab
// product, which grows with the rows: 33 M at a 32-row tile, 131 M at beam
// 128) and a re-read of the joiner weights through L2 (wo alone is 4 MB in
// fp32, once a tile in the tiled kernel), now spread over 64 SMs at B = 8
// instead of 8, plus four cluster barriers and the leader's merge. Left for
// later: wo resident on chip (it does not fit one cluster's shared memory
// in fp32), one vocab product for the rows of all chunks as the TPU kernel
// does, and the leader's merge off the frame's critical path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
constexpr int kMaxCap = 16;  // the largest beam cap instantiated
constexpr int kTile = 32;    // rows a tile of the tiled kernel
constexpr int kMaxCtx = 4;
constexpr int kHCols = 64;                          // hidden columns per pass
constexpr int kHSplits = kThreads / kHCols;         // 8 partial sums each
constexpr int kVPairs = 128;                        // vocab column pairs per pass
constexpr int kVSplits = kThreads / kVPairs;        // 4 partial sums over J
constexpr int kUnroll = 16;                         // weight loads in flight a thread
constexpr int kNoIndex = 0x7fffffff;
constexpr float kNegInf = -1e30f;
constexpr float kAlpha = 1.0f / 3.0f;
constexpr float kTsallisScale = -1.5f;  // 1 / (alpha - 1)

// The layout of one beam cap MB, or of the tiled kernel's tile (MB kTile).
template <int MB>
struct Cap {
  static constexpr int kRowThreads = kThreads / MB;  // top-k: threads a row
  static constexpr int kScratch = kHSplits * kHCols * (MB + 1);  // floats
  static constexpr int kVUnroll = MB > 16 ? 8 : kUnroll;  // vocab loads in flight
  static constexpr int kBlockPer = kWarps * MB / 32;      // block merge: entries a lane
  static constexpr int kLeadPer = kCluster * MB / 32;     // leader merge: entries a lane
  static_assert(kThreads % MB == 0 && kRowThreads % 16 == 0, "top-k: whole rows a warp");
  static_assert(2 * 2 * MB * kVPairs <= kScratch, "vocab reduce scratch");
  static_assert(kWarps * MB % 32 == 0 && kCluster * MB % 32 == 0, "merges: whole entries a lane");
  static_assert(MB % 4 == 0 && (MB <= kMaxCap || MB == kTile), "rows of float4");

  // Dynamic shared memory of one block of the cap kernel
  // (ops/beam_search_cuda._kernel_smem_bytes).
  static size_t smem(int T, int E, int D, int J, int V) {
    const int W = (V + kCluster - 1) / kCluster;
    return (size_t)(MB * (W + J + D) + kScratch + E) * 4 + (size_t)2 * MB * T * 2;
  }
};

// Dynamic shared memory of one block of the tiled kernel: a tile's hidden
// layer, its decoder rows or logit slice, partial sums, the encoder frame.
size_t tiled_smem(int E, int D, int J, int V) {
  const int W = (V + kCluster - 1) / kCluster;
  return (size_t)(kTile * (J + (D > W ? D : W)) + Cap<kTile>::kScratch + E) * 4;
}

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

// acc[bb] += h[bb] * w for the MB rows of one hidden (or decoder) column.
template <int MB>
__device__ __forceinline__ void fma_rows(float* acc, const float* h, float w) {
#pragma unroll
  for (int q = 0; q < MB; q += 4) {
    const float4 hq = *reinterpret_cast<const float4*>(h + q);
    acc[q] = fmaf(hq.x, w, acc[q]); acc[q + 1] = fmaf(hq.y, w, acc[q + 1]);
    acc[q + 2] = fmaf(hq.z, w, acc[q + 2]); acc[q + 3] = fmaf(hq.w, w, acc[q + 3]);
  }
}

// ---- the steps of a frame that the caps and the tiled kernel share ----

// The decoder's grouped context conv + ReLU for MB rows: s_dec[o * MB + bb].
template <int MB>
__device__ __forceinline__ void decoder_rows(float* s_dec, const int (*ctx)[kMaxCtx],
                                             const float* __restrict__ emb,
                                             const float* __restrict__ conv_w, int D,
                                             int ipg, int K, int opg, int tid) {
  for (int o = tid; o < D; o += kThreads) {
    const int g = o / opg;
    float acc[MB];
#pragma unroll
    for (int bb = 0; bb < MB; ++bb) acc[bb] = 0.f;
    for (int k = 0; k < K; ++k)
#pragma unroll 4
      for (int i = 0; i < ipg; ++i) {
        const float w = __ldg(conv_w + ((size_t)o * ipg + i) * K + k);
        const int c = g * ipg + i;
#pragma unroll
        for (int bb = 0; bb < MB; ++bb)
          acc[bb] = fmaf(__ldg(emb + (size_t)ctx[bb][k] * D + c), w, acc[bb]);
      }
#pragma unroll
    for (int bb = 0; bb < MB; ++bb) s_dec[o * MB + bb] = fmaxf(acc[bb], 0.f);
  }
}

// This block's hidden columns [j_lo, j_lo + j_n) of MB rows:
// s_h[j * MB + bb] = tanh(enc @ we + be + dec @ wdp + bdp). Ends synchronised.
template <int MB>
__device__ __forceinline__ void hidden_cols(float* s_h, const float* s_dec, const float* s_enc,
                                            float* s_scr, const float* __restrict__ we,
                                            const float* __restrict__ be,
                                            const float* __restrict__ wdp,
                                            const float* __restrict__ bdp, int E, int D, int J,
                                            int j_lo, int j_n, int tid) {
  for (int c0 = 0; c0 < j_n; c0 += kHCols) {
    const int col = tid % kHCols, sp = tid / kHCols;
    const int j = j_lo + min(c0 + col, j_n - 1);
    float ej = 0.f, acc[MB];
#pragma unroll
    for (int bb = 0; bb < MB; ++bb) acc[bb] = 0.f;
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
      for (int u = 0; u < kUnroll; ++u) fma_rows<MB>(acc, s_dec + (o + u * kHSplits) * MB, w[u]);
    }
    for (; o < D; o += kHSplits) fma_rows<MB>(acc, s_dec + o * MB, __ldg(wdp + (size_t)o * J + j));
    float* part = s_scr + (sp * kHCols + col) * (MB + 1);
#pragma unroll
    for (int bb = 0; bb < MB; ++bb) part[bb] = acc[bb];
    part[MB] = ej;
    __syncthreads();
    for (int q = tid; q < kHCols * MB; q += kThreads) {  // a thread per (column, beam)
      const int cc = q / MB, bb = q % MB;
      if (c0 + cc < j_n) {
        float a = 0.f, ea = 0.f;
        for (int r = 0; r < kHSplits; ++r) {
          const float* pr = s_scr + (r * kHCols + cc) * (MB + 1);
          a += pr[bb];
          ea += pr[MB];
        }
        const int jj = j_lo + c0 + cc;
        s_h[jj * MB + bb] = tanhf((a + __ldg(bdp + jj)) + (ea + __ldg(be + jj)));
      }
    }
    __syncthreads();
  }
}

// This block's vocab slice of MB rows: s_lp[bb * W + c] = ([MB, J] x
// [J, width] + bo)[bb, c]. Ends synchronised.
template <int MB>
__device__ __forceinline__ void vocab_slice(float* s_lp, const float* s_h, float* s_scr,
                                            const float* __restrict__ wo,
                                            const float* __restrict__ bo, int J, int V, int W,
                                            int v_lo, int width, int tid) {
  for (int c0 = 0; c0 < width; c0 += 2 * kVPairs) {
    constexpr int kVU = Cap<MB>::kVUnroll;
    const int g = tid % kVPairs, sp = tid / kVPairs;
    const int va = v_lo + min(c0 + g, width - 1);
    const int vb = v_lo + min(c0 + g + kVPairs, width - 1);
    const int jn = (J + kVSplits - 1) / kVSplits, ja = min(J, sp * jn), jz = min(J, ja + jn);
    float acc_a[MB], acc_b[MB];
#pragma unroll
    for (int bb = 0; bb < MB; ++bb) acc_a[bb] = acc_b[bb] = 0.f;
    int j = kCut & kCutVocab ? jz : ja;
    for (; j + kVU <= jz; j += kVU) {
      float wa[kVU], wb[kVU];
#pragma unroll
      for (int u = 0; u < kVU; ++u) {
        wa[u] = __ldg(wo + (size_t)(j + u) * V + va);
        wb[u] = __ldg(wo + (size_t)(j + u) * V + vb);
      }
#pragma unroll
      for (int u = 0; u < kVU; ++u) {
        fma_rows<MB>(acc_a, s_h + (j + u) * MB, wa[u]);
        fma_rows<MB>(acc_b, s_h + (j + u) * MB, wb[u]);
      }
    }
    for (; j < jz; ++j) {
      fma_rows<MB>(acc_a, s_h + j * MB, __ldg(wo + (size_t)j * V + va));
      fma_rows<MB>(acc_b, s_h + j * MB, __ldg(wo + (size_t)j * V + vb));
    }
    // The four partial sums over J, added as (s0 + s2) + (s1 + s3).
    float* red = s_scr;  // [2 splits][2 columns][MB][kVPairs]
    if (sp >= 2)
#pragma unroll
      for (int bb = 0; bb < MB; ++bb) {
        red[(((sp - 2) * 2 + 0) * MB + bb) * kVPairs + g] = acc_a[bb];
        red[(((sp - 2) * 2 + 1) * MB + bb) * kVPairs + g] = acc_b[bb];
      }
    __syncthreads();
    if (sp < 2)
#pragma unroll
      for (int bb = 0; bb < MB; ++bb) {
        acc_a[bb] += red[((sp * 2 + 0) * MB + bb) * kVPairs + g];
        acc_b[bb] += red[((sp * 2 + 1) * MB + bb) * kVPairs + g];
      }
    __syncthreads();
    if (sp == 1)
#pragma unroll
      for (int bb = 0; bb < MB; ++bb) {
        red[(0 * MB + bb) * kVPairs + g] = acc_a[bb];
        red[(1 * MB + bb) * kVPairs + g] = acc_b[bb];
      }
    __syncthreads();
    if (sp == 0) {
      const int ca = c0 + g, cb = c0 + g + kVPairs;
#pragma unroll
      for (int bb = 0; bb < MB; ++bb) {
        if (ca < width)
          s_lp[bb * W + ca] = (acc_a[bb] + red[(0 * MB + bb) * kVPairs + g]) + __ldg(bo + va);
        if (cb < width)
          s_lp[bb * W + cb] = (acc_b[bb] + red[(1 * MB + bb) * kVPairs + g]) + __ldg(bo + vb);
      }
    }
    __syncthreads();
  }
}

// A row's slice max and sum of exp (a warp; every lane ends with them).
__device__ __forceinline__ float2 slice_max_sumexp(const float* row, int width, int lane) {
  float m = -INFINITY;
  for (int c = lane; c < width; c += 32) m = fmaxf(m, row[c]);
  m = warp_max(m);
  float se = 0.f;
  for (int c = lane; c < width; c += 32) se += expf(row[c] - m);
  se = warp_sum(se);
  return make_float2(m, se);
}

// A row's lse from the slices' partials (lane r holds rank r's; in rank
// order), its slice turned into log-probs in place, and the slice's
// entropy, Tsallis and top-2 probability terms (a warp; lane 0's result).
__device__ __forceinline__ float4 slice_terms(float* row, int width, float2 q, int lane) {
  const float m = warp_max(q.x);
  const float term = lane < kCluster ? q.y * expf(q.x - m) : 0.f;
  float se = 0.f;
  for (int r = 0; r < kCluster; ++r) se += __shfl_sync(0xffffffffu, term, r);
  const float lse = logf(se);
  float ent = 0.f, ts_sum = 0.f, p1 = -1.f, p2 = -1.f;
  for (int c = lane; c < width; c += 32) {
    const float z = row[c] - m;
    const float p = expf(z) / se;
    ent += p * logf(p + 1e-30f);
    ts_sum += powf(p, kAlpha);
    if (p > p1) { p2 = p1; p1 = p; } else if (p > p2) { p2 = p; }
    row[c] = z - lse;
  }
  ent = warp_sum(ent);
  ts_sum = warp_sum(ts_sum);
  for (int o = 16; o > 0; o >>= 1) {  // merge top-2 (values; ties kept)
    const float q1 = __shfl_xor_sync(0xffffffffu, p1, o);
    const float q2 = __shfl_xor_sync(0xffffffffu, p2, o);
    const float hi = fmaxf(p1, q1);
    p2 = fmaxf(fminf(p1, q1), fmaxf(p2, q2));
    p1 = hi;
  }
  return make_float4(ent, ts_sum, p1, p2);
}

// A parent row's metrics from the slices' terms (lane r holds rank r's), in
// rank order (a warp; lane 0's result).
__device__ __forceinline__ float4 parent_metrics(float4 q, float tsallis_max, float max_entropy) {
  float ent = 0.f, ts_sum = 0.f, p1 = -1.f, p2 = -1.f;
  for (int r = 0; r < kCluster; ++r) {
    ent += __shfl_sync(0xffffffffu, q.x, r);
    ts_sum += __shfl_sync(0xffffffffu, q.y, r);
    const float a = __shfl_sync(0xffffffffu, q.z, r);
    const float c = __shfl_sync(0xffffffffu, q.w, r);
    const float hi = fmaxf(p1, a);
    p2 = fmaxf(fminf(p1, a), fmaxf(p2, c));
    p1 = hi;
  }
  return make_float4((kTsallisScale * (1.f - ts_sum)) / tsallis_max, p1 - p2,
                     -ent / max_entropy, p1);
}

// The leader after the last frame: the finalize term (hotwords), the
// length-normalised choice, its tokens, and the backward walk over its
// records for each token's frame, log-prob and metrics.
__device__ __forceinline__ void finish_chunk(
    float* logp, const int* n, const int* hw, const unsigned short* tok_fin, int ts, int beam,
    int K, int S, const float* __restrict__ hw_node, int b, int T, int len, int blank,
    const int* rec_par, const int* rec_tok, const float* rec_lp, const float* rec_met,
    int* out_tokens, int* out_frames, float* out_tok_logp, float* out_entropy, int* out_n,
    float* out_logp, int* s_best, int tid) {
  if (tid == 0) {
    if (S > 0)
      for (int j = 0; j < beam; ++j) logp[j] -= hw_node[hw[j]];
    int best = 0;
    float best_v = -INFINITY;
    for (int j = 0; j < beam; ++j) {
      const float v = logp[j] / (float)max(n[j] + K, 1);
      if (v > best_v) { best_v = v; best = j; }
    }
    *s_best = best;
    out_n[b] = n[best];
    out_logp[b] = logp[best];
  }
  __syncthreads();
  const int best = *s_best, n_sel = n[best];
  for (int u = tid; u < T; u += kThreads) {
    const size_t o = (size_t)b * T + u;
    out_tokens[o] = u < n_sel ? (int)tok_fin[best * ts + u] : 0;
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

template <int MB>
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
  using C = Cap<MB>;
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
  float* s_lp = reinterpret_cast<float*>(smem);  // [MB][W] slice logits -> log-probs
  float* s_h = s_lp + MB * W;                    // [J][MB] joiner hidden
  float* s_dec = s_h + MB * J;                   // [D][MB] decoder out
  float* s_scr = s_dec + MB * D;                 // [kScratch] partial sums
  float* s_enc = s_scr + C::kScratch;            // [E] encoder frame
  // The leader's [2][MB][T] token histories.
  unsigned short* s_tok = reinterpret_cast<unsigned short*>(s_enc + E);
  const int ts = T;  // a history row's stride

  // Beam state: the leader's is the state, a peer's a copy of it per frame.
  __shared__ float s_logp[MB];
  __shared__ int s_ctx[MB][kMaxCtx];
  // Published to the cluster each frame, one vector load per peer each.
  __shared__ float2 s_part[MB];             // slice max, slice sum of exp
  __shared__ float4 s_mpart[MB];            // slice entropy, Tsallis, p1, p2
  __shared__ float4 s_cand[MB];             // local top-beam: score, index bits, log-prob
  __shared__ float s_ws[kWarps][MB];        // per-warp top-beam lists
  __shared__ int s_wi[kWarps][MB];
  // The leader's own.
  __shared__ int s_n[MB];
  __shared__ int s_hi[MB], s_tk[MB], s_newn[MB], s_canon[MB];
  __shared__ int s_newctx[MB][kMaxCtx];
  __shared__ float s_score[MB], s_sel_lp[MB];
  __shared__ float s_boost[MB];             // s_score + hotword delta
  __shared__ int s_hw[MB], s_newhw[MB];     // automaton states
  __shared__ float s_met[MB][4];
  __shared__ bool s_eq[MB][MB];
  __shared__ int s_cur, s_best;

  if (tid < MB) {
    s_logp[tid] = tid == 0 ? 0.f : kNegInf;
    s_n[tid] = 0;
    s_hw[tid] = 0;  // the automaton's root
    for (int k = 0; k < kMaxCtx; ++k) s_ctx[tid][k] = 0;  // [-1, 0] + ys, >= 0
  }
  if (tid == 0) s_cur = 0;
  cluster.sync();  // every block of the cluster has started: DSMEM is live

  for (int t = 0; t < len; ++t) {
    // ---- the parents' contexts and scores, from the leader ----
    if (!leader && tid < MB) {
      s_logp[tid] = *cluster.map_shared_rank(&s_logp[tid], 0);
      for (int k = 0; k < K; ++k) s_ctx[tid][k] = *cluster.map_shared_rank(&s_ctx[tid][k], 0);
    }
    for (int e = tid; e < E; e += kThreads) s_enc[e] = enc[((size_t)b * T + t) * E + e];
    __syncthreads();

    // ---- the decoder's grouped context conv + ReLU, all of it ----
    decoder_rows<MB>(s_dec, s_ctx, emb, conv_w, D, ipg, K, opg, tid);
    __syncthreads();

    // ---- this block's hidden columns: h = tanh(enc @ we + be + dec @ wdp + bdp) ----
    hidden_cols<MB>(s_h, s_dec, s_enc, s_scr, we, be, wdp, bdp, E, D, J, j_lo, j_n, tid);
    cluster.sync();  // (1) every block's hidden columns are written

    // ---- the whole hidden layer, from the peers ----
    for (int i = tid; i < J * MB / 4 && !(kCut & kCutHidden); i += kThreads) {
      const int r = (i * 4 / MB) / JW;
      if (r != rank)
        reinterpret_cast<float4*>(s_h)[i] =
            reinterpret_cast<const float4*>(cluster.map_shared_rank(s_h, r))[i];
    }
    __syncthreads();

    // ---- this block's vocab slice: [beam, J] x [J, width] + bo ----
    vocab_slice<MB>(s_lp, s_h, s_scr, wo, bo, J, V, W, v_lo, width, tid);

    // ---- each row's slice max and sum of exp (a warp per beam row) ----
    for (int rw = warp; rw < beam && !(kCut & kCutTopk); rw += kWarps) {
      const float2 part = slice_max_sumexp(s_lp + rw * W, width, lane);
      if (lane == 0) s_part[rw] = part;
    }
    cluster.sync();  // (2) every slice's partials are written

    // ---- row lse from the partials (in rank order); slice log-probs and metric terms ----
    for (int rw = warp; rw < beam && !(kCut & kCutTopk); rw += kWarps) {
      const float2 q = lane < kCluster ? *cluster.map_shared_rank(&s_part[rw], lane)
                                       : make_float2(-INFINITY, 0.f);
      const float4 terms = slice_terms(s_lp + rw * W, width, q, lane);
      if (lane == 0) s_mpart[rw] = terms;
    }
    __syncthreads();

    // ---- local exact top-beam of lp + logp[parent] over beam x width ----
    if (!(kCut & kCutTopk)) {
      // kRowThreads a row: at MB 8 warp w scans row w / 2, columns (w % 2) *
      // 32 + lane + 64k; at MB 16 a warp scans one row.
      const int bb = tid / C::kRowThreads;
      const float lp_parent = bb < beam ? s_logp[bb] : 0.f;
      const float* row = s_lp + bb * W;
      float prev_s = INFINITY;
      int prev_i = -1;
      for (int p = 0; p < beam; ++p) {
        float bs = -INFINITY;
        int bi = kNoIndex;
        if (bb < beam)
          for (int c = tid % C::kRowThreads; c < width; c += C::kRowThreads) {
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
        float es[C::kBlockPer];
        int ei[C::kBlockPer];
#pragma unroll
        for (int q = 0; q < C::kBlockPer; ++q) {  // entry e: list e / MB, place e % MB
          const int e = lane + 32 * q;
          const bool ok = e % MB < beam;
          es[q] = ok ? s_ws[e / MB][e % MB] : -INFINITY;
          ei[q] = ok ? s_wi[e / MB][e % MB] : kNoIndex;
        }
        prev_s = INFINITY;
        prev_i = -1;
        for (int p = 0; p < beam; ++p) {
          float bs = -INFINITY;
          int bi = kNoIndex;
#pragma unroll
          for (int q = 0; q < C::kBlockPer; ++q)
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
        float es[C::kLeadPer], el[C::kLeadPer];
        int ei[C::kLeadPer];
#pragma unroll
        for (int q = 0; q < C::kLeadPer; ++q) {  // entry e: rank e / MB, place e % MB
          const int e = lane + 32 * q;
          const float4 c = e % MB < beam
                               ? *cluster.map_shared_rank(&s_cand[e % MB], e / MB)
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
#pragma unroll
          for (int q = 0; q < C::kLeadPer; ++q)
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
      } else {
        // ---- parent row's metrics from the slices' terms, in rank order ----
        for (int row = warp - 1; row < beam; row += kWarps - 1) {
          const float4 q = lane < kCluster ? *cluster.map_shared_rank(&s_mpart[row], lane)
                                           : make_float4(0.f, 0.f, -1.f, -1.f);
          const float4 met = parent_metrics(q, tsallis_max, max_entropy);
          if (lane == 0) {
            s_met[row][0] = met.x;
            s_met[row][1] = met.y;
            s_met[row][2] = met.z;
            s_met[row][3] = met.w;
          }
        }
      }
      __syncthreads();

      const unsigned short* tok_old = s_tok + s_cur * MB * ts;
      unsigned short* tok_new = s_tok + (s_cur ^ 1) * MB * ts;

      // ---- parent gather, token append, records ----
      for (int j = 0; j < beam && !(kCut & kCutLeader); ++j) {
        const int hi = s_hi[j], pn = s_n[hi];
        for (int u = tid; u < pn; u += kThreads)
          tok_new[j * ts + u] = tok_old[hi * ts + u];
      }
      if (tid < beam && !(kCut & kCutLeader)) {
        const int j = tid, hi = s_hi[j], tk = s_tk[j], pn = s_n[hi];
        const bool is_blank = tk == blank;
        if (!is_blank) tok_new[j * ts + pn] = (unsigned short)tk;
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
            same = same && tok_new[i * ts + u] == tok_new[j * ts + u];
        same = __all_sync(0xffffffffu, same);
        if (lane == 0) s_eq[i][j] = same;
      }
      __syncthreads();

      // ---- log-add merge into the first beam of each group; commit state ----
      // A thread per beam; each group's max and sum run over j in order.
      if (tid < beam && !(kCut & kCutLeader)) {
        int canon = tid;
        for (int i = 0; i < tid; ++i)
          if (s_eq[i][tid]) { canon = i; break; }
        s_canon[tid] = canon;
      }
      __syncthreads();
      if (tid < beam && !(kCut & kCutLeader)) {
        const int i = tid;
        float m = kNegInf;
        for (int j = 0; j < beam; ++j) m = fmaxf(m, s_canon[j] == i ? s_boost[j] : kNegInf);
        float se = 0.f;
        for (int j = 0; j < beam; ++j) se += expf((s_canon[j] == i ? s_boost[j] : kNegInf) - m);
        s_logp[i] = s_canon[i] == i ? m + logf(se) : kNegInf;
        s_n[i] = s_newn[i];
        s_hw[i] = s_newhw[i];
        for (int k = 0; k < K; ++k) s_ctx[i][k] = s_newctx[i][k];
      }
      if (tid == 0 && !(kCut & kCutLeader)) s_cur ^= 1;
    }
    cluster.sync();  // (4) the leader's new state is published
  }
  cluster.sync();  // no block leaves while a peer may still read its shared memory
  if (!leader) return;

  // ---- finalize (hotwords) and length-normalised selection ----
  finish_chunk(s_logp, s_n, s_hw, s_tok + s_cur * MB * ts, ts, beam, K, S, hw_node, b, T, len,
               blank, rec_par, rec_tok, rec_lp, rec_met, out_tokens, out_frames, out_tok_logp,
               out_entropy, out_n, out_logp, &s_best, tid);
}

// ---- the tiled kernel (beams past the largest cap) ----

// A score's key: larger score, larger key (-0 taken as +0 first).
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A candidate's key: (score key, ~flat index), larger is better; the
// padding entry (-inf, kNoIndex) is below every candidate.
__device__ __forceinline__ unsigned long long cand_key(float4 c) {
  return ((unsigned long long)score_key(c.x) << 32) | (unsigned)~__float_as_int(c.y);
}

__device__ __forceinline__ unsigned long long hash_step(unsigned long long h, int tok) {
  h = (h ^ (unsigned long long)(tok + 1)) * 0x9E3779B97F4A7C15ull;
  return h ^ (h >> 29);
}

// Byte offsets, in one chunk's workspace, of the tiled kernel's arrays
// (every array 16-byte aligned); `bytes` is a chunk's size
// (svt_beam_tiled_workspace_bytes).
struct Tiled {
  size_t h, part, mpart, cand, logp, ctx, lp, sc, n, hw, newn, newhw, hi, tk, canon, score,
      sel_lp, boost, met, newctx, hash, newhash, hist, bytes;

  static __host__ __device__ size_t take(size_t& at, size_t n) {
    const size_t o = at;
    at += (n + 15) & ~(size_t)15;
    return o;
  }

  __host__ __device__ Tiled(int T, int J, int V, int beam) {
    const size_t nb = beam, w = (V + kCluster - 1) / kCluster, ts = (T + 7) & ~7;
    size_t at = 0;
    h = take(at, (nb + kTile - 1) / kTile * kTile * J * 4);  // [tiles][J][kTile] hidden
    part = take(at, kCluster * nb * 8);                      // [rank][beam] float2
    mpart = take(at, kCluster * nb * 16);                    // [rank][beam] float4
    cand = take(at, kCluster * nb * 16);                     // [rank][beam] local lists
    logp = take(at, nb * 4);                                 // the beams' scores
    ctx = take(at, nb * kMaxCtx * 4);                        // and contexts
    lp = take(at, kCluster * nb * w * 4);                    // [rank][beam][width] log-probs
    sc = take(at, kCluster * nb * w * 4);                    // and candidate scores
    n = take(at, nb * 4);
    hw = take(at, nb * 4);
    newn = take(at, nb * 4);
    newhw = take(at, nb * 4);
    hi = take(at, nb * 4);
    tk = take(at, nb * 4);
    canon = take(at, nb * 4);
    score = take(at, nb * 4);
    sel_lp = take(at, nb * 4);
    boost = take(at, nb * 4);
    met = take(at, nb * 16);
    newctx = take(at, nb * kMaxCtx * 4);
    hash = take(at, nb * 8);
    newhash = take(at, nb * 8);
    hist = take(at, 2 * nb * ts * 2);                        // [2][beam][ts] tokens
    bytes = at;
  }
};

// Block-wide: the k-th largest of the 32-bit keys that key(e, u) gives for
// the elements e < n it accepts (1 <= k <= their count), by four passes of
// an 8-bit digit from the top, each a histogram in shared memory (lanes
// with the same digit add once). On return `above` is how many keys exceed
// it and `equal` how many equal it.
template <class KeyFn>
__device__ unsigned kth_largest(KeyFn key, int n, int k, unsigned* hist, int* s_pick,
                                int& above, int& equal) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned prefix = 0, mask = 0;
  int kk = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += kThreads) {
      const int e = base + tid;
      unsigned u = 0;
      const bool ok = e < n && key(e, u) && (u & mask) == prefix;
      const int d = ok ? (int)((u >> shift) & 255u) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (ok && lane == __ffs(peers) - 1) atomicAdd(&hist[d], (unsigned)__popc(peers));
    }
    __syncthreads();
    if (warp == 0) {  // the digit where the count from the top reaches kk
      unsigned c[8], tot = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = hist[lane * 8 + q];
        tot += c[q];
      }
      unsigned suf = tot;  // this lane's bins and those above
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += x;
      }
      unsigned top = suf - tot;
      if (top < (unsigned)kk && (unsigned)kk <= suf)
        for (int q = 7; q >= 0; --q) {
          if (top + c[q] >= (unsigned)kk) {
            s_pick[0] = lane * 8 + q;
            s_pick[1] = kk - (int)top;
            s_pick[2] = (int)c[q];
            break;
          }
          top += c[q];
        }
    }
    __syncthreads();
    prefix |= (unsigned)s_pick[0] << shift;
    mask |= 255u << shift;
    kk = s_pick[1];
    equal = s_pick[2];
  }
  above = k - kk;
  return prefix;
}

// Block-wide: the exact top-beam of a slice's candidates (sc, lp: [beam]
// [width], dense), unordered, into cand[0, min(beam, beam * width)) as
// (score, flat index bits, log-prob, 0); the rest of cand[0, beam) is
// padding.
__device__ void slice_top(const float* sc, const float* lp, int beam, int width, int V,
                          int v_lo, float4* cand, unsigned* hist, int* s_pick, int* s_count) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = beam * width, k = min(beam, n);
  auto flat = [&](int e) {
    const int r = e / width;
    return r * V + v_lo + (e - r * width);
  };
  const bool all = n <= beam;
  bool all_ties = true;
  unsigned t_hi = 0, t_lo = 0;
  if (!all) {
    int above, equal;
    t_hi = kth_largest([&](int e, unsigned& u) { u = score_key(sc[e]); return true; }, n, k,
                       hist, s_pick, above, equal);
    const int need = k - above;
    if (need < equal) {  // the `need` lowest flat indices among the ties
      all_ties = false;
      t_lo = kth_largest(
          [&](int e, unsigned& u) {
            if (score_key(sc[e]) != t_hi) return false;
            u = ~(unsigned)flat(e);
            return true;
          },
          n, need, hist, s_pick, above, equal);
    }
  }
  if (tid == 0) *s_count = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kThreads) {
    const int e = base + tid;
    bool take = false;
    if (e < n) {
      const unsigned u = score_key(sc[e]);
      take = all || u > t_hi || (u == t_hi && (all_ties || ~(unsigned)flat(e) >= t_lo));
    }
    const unsigned bal = __ballot_sync(0xffffffffu, take);
    int at = 0;
    if (lane == 0 && bal) at = atomicAdd(s_count, __popc(bal));
    at = __shfl_sync(0xffffffffu, at, 0) + __popc(bal & ((1u << lane) - 1));
    if (take) cand[at] = make_float4(sc[e], __int_as_float(flat(e)), lp[e], 0.f);
  }
  for (int i = k + tid; i < beam; i += kThreads)
    cand[i] = make_float4(-INFINITY, __int_as_float(kNoIndex), 0.f, 0.f);
}

// Block-wide (the leader): each of the n entries of `cand` ranked by how
// many entries beat it, keys staged kThreads at a time in s_keys; the entry
// of rank p < beam is new beam p.
__device__ void rank_merge(const float4* cand, int n, int beam, int V,
                           unsigned long long* s_keys, float* score, int* hi, int* tk,
                           float* sel_lp) {
  const int tid = threadIdx.x;
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + tid;
    const float4 c = i < n ? __ldcg(cand + i)
                           : make_float4(-INFINITY, __int_as_float(kNoIndex), 0.f, 0.f);
    const unsigned long long key = cand_key(c);
    int rank = 0;
    for (int j0 = 0; j0 < n; j0 += kThreads) {
      __syncthreads();
      if (j0 + tid < n) s_keys[tid] = cand_key(__ldcg(cand + j0 + tid));
      __syncthreads();
      const int nj = min(kThreads, n - j0);
      for (int j = 0; j < nj; ++j) rank += s_keys[j] > key;
    }
    const int idx = __float_as_int(c.y);
    if (i < n && idx != kNoIndex && rank < beam) {
      score[rank] = c.x;
      hi[rank] = idx / V;
      tk[rank] = idx % V;
      sel_lp[rank] = c.z;
    }
  }
}

// Whether two token rows agree on their first n tokens (a warp; rows
// 16-byte aligned).
__device__ __forceinline__ bool same_tokens(const unsigned short* a, const unsigned short* b,
                                            int n, int lane) {
  bool same = true;
  const int n8 = n >> 3;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  for (int q = lane; q < n8; q += 32) {
    const uint4 x = a4[q], y = b4[q];
    same = same && x.x == y.x && x.y == y.y && x.z == y.z && x.w == y.w;
  }
  for (int u = 8 * n8 + lane; u < n; u += 32) same = same && a[u] == b[u];
  return __all_sync(0xffffffffu, same);
}

__global__ void __launch_bounds__(kThreads, 1)
beam_kernel_tiled(const float* __restrict__ enc, const int* __restrict__ lens,
                  const float* __restrict__ emb, const float* __restrict__ conv_w,
                  const float* __restrict__ we, const float* __restrict__ be,
                  const float* __restrict__ wdp, const float* __restrict__ bdp,
                  const float* __restrict__ wo, const float* __restrict__ bo,
                  const int* __restrict__ hw_next, const float* __restrict__ hw_delta,
                  const float* __restrict__ hw_node,
                  int* rec_par, int* rec_tok, float* rec_lp, float* rec_met, unsigned char* ws,
                  int* out_tokens, int* out_frames, float* out_tok_logp,
                  float* out_entropy, int* out_n, float* out_logp, int T, int E,
                  int D, int ipg, int K, int J, int V, int beam, int blank, int unk,
                  int S, float tsallis_max, float max_entropy) {
  constexpr int MB = kTile;
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
  const int ts = (T + 7) & ~7, tiles = (beam + kTile - 1) / kTile;

  // This chunk's workspace. Arrays a peer wrote are read with __ldcg (L2,
  // never a stale L1 line) after the cluster barrier that orders them.
  const Tiled L(T, J, V, beam);
  unsigned char* base = ws + (size_t)b * L.bytes;
  float* g_h = reinterpret_cast<float*>(base + L.h);
  float2* g_part = reinterpret_cast<float2*>(base + L.part);
  float4* g_mpart = reinterpret_cast<float4*>(base + L.mpart);
  float4* g_cand = reinterpret_cast<float4*>(base + L.cand);
  float* g_logp = reinterpret_cast<float*>(base + L.logp);
  int* g_ctx = reinterpret_cast<int*>(base + L.ctx);
  float* g_lp = reinterpret_cast<float*>(base + L.lp) + (size_t)rank * beam * W;
  float* g_sc = reinterpret_cast<float*>(base + L.sc) + (size_t)rank * beam * W;
  // The leader's own.
  int* g_n = reinterpret_cast<int*>(base + L.n);
  int* g_hw = reinterpret_cast<int*>(base + L.hw);
  int* g_newn = reinterpret_cast<int*>(base + L.newn);
  int* g_newhw = reinterpret_cast<int*>(base + L.newhw);
  int* g_hi = reinterpret_cast<int*>(base + L.hi);
  int* g_tk = reinterpret_cast<int*>(base + L.tk);
  int* g_canon = reinterpret_cast<int*>(base + L.canon);
  float* g_score = reinterpret_cast<float*>(base + L.score);
  float* g_sel_lp = reinterpret_cast<float*>(base + L.sel_lp);
  float* g_boost = reinterpret_cast<float*>(base + L.boost);
  float4* g_met = reinterpret_cast<float4*>(base + L.met);
  int* g_newctx = reinterpret_cast<int*>(base + L.newctx);
  unsigned long long* g_hash = reinterpret_cast<unsigned long long*>(base + L.hash);
  unsigned long long* g_newhash = reinterpret_cast<unsigned long long*>(base + L.newhash);
  unsigned short* g_hist = reinterpret_cast<unsigned short*>(base + L.hist);

  // One tile (tiled_smem): [J][MB] hidden, [D][MB] decoder rows / [MB][W]
  // logits, partial sums, the encoder frame.
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_h = reinterpret_cast<float*>(smem);
  float* s_dec = s_h + MB * J;
  float* s_lp = s_dec;
  float* s_scr = s_dec + MB * max(D, W);
  float* s_enc = s_scr + Cap<MB>::kScratch;
  __shared__ int s_ctx[kTile][kMaxCtx];
  __shared__ unsigned s_hist[256];
  __shared__ unsigned long long s_keys[kThreads];
  __shared__ int s_pick[3], s_count, s_cur, s_best;

  if (leader) {
    for (int i = tid; i < beam; i += kThreads) {
      g_logp[i] = i == 0 ? 0.f : kNegInf;
      g_n[i] = 0;
      g_hw[i] = 0;  // the automaton's root
      g_hash[i] = 0;
      for (int k = 0; k < kMaxCtx; ++k) g_ctx[i * kMaxCtx + k] = 0;  // [-1, 0] + ys, >= 0
    }
    if (tid == 0) s_cur = 0;
  }
  cluster.sync();

  for (int t = 0; t < len; ++t) {
    for (int e = tid; e < E; e += kThreads) s_enc[e] = enc[((size_t)b * T + t) * E + e];

    // ---- A: per tile, the decoder rows and this block's hidden columns ----
    for (int tile = 0; tile < tiles; ++tile) {
      const int r0 = tile * kTile;
      if (tid < kTile * kMaxCtx) {
        const int bb = tid / kMaxCtx, k = tid % kMaxCtx;
        s_ctx[bb][k] = r0 + bb < beam ? __ldcg(g_ctx + (r0 + bb) * kMaxCtx + k) : 0;
      }
      __syncthreads();
      decoder_rows<MB>(s_dec, s_ctx, emb, conv_w, D, ipg, K, opg, tid);
      __syncthreads();
      hidden_cols<MB>(s_h, s_dec, s_enc, s_scr, we, be, wdp, bdp, E, D, J, j_lo, j_n, tid);
      float4* dst = reinterpret_cast<float4*>(g_h + (size_t)tile * kTile * J);
      for (int i = j_lo * MB / 4 + tid; i < (j_lo + j_n) * MB / 4; i += kThreads)
        dst[i] = reinterpret_cast<const float4*>(s_h)[i];
    }
    cluster.sync();  // (1) every block's hidden columns are written

    // ---- B: per tile, the whole hidden tile, the slice's logits, row partials ----
    for (int tile = 0; tile < tiles; ++tile) {
      const int r0 = tile * kTile, nt = min(kTile, beam - r0);
      __syncthreads();
      const float4* src = reinterpret_cast<const float4*>(g_h + (size_t)tile * kTile * J);
      for (int i = tid; i < J * MB / 4; i += kThreads)
        reinterpret_cast<float4*>(s_h)[i] = __ldcg(src + i);
      __syncthreads();
      vocab_slice<MB>(s_lp, s_h, s_scr, wo, bo, J, V, W, v_lo, width, tid);
      for (int rw = warp; rw < nt; rw += kWarps) {
        const float* row = s_lp + rw * W;
        float* out = g_lp + (size_t)(r0 + rw) * width;
        for (int c = lane; c < width; c += 32) out[c] = row[c];
        const float2 part = slice_max_sumexp(row, width, lane);
        if (lane == 0) g_part[rank * beam + r0 + rw] = part;
      }
    }
    cluster.sync();  // (2) every slice's partials are written

    // ---- C: per row, lse, log-probs, metric terms, candidate scores ----
    for (int rw = warp; rw < beam; rw += kWarps) {
      const float2 q = lane < kCluster ? __ldcg(g_part + lane * beam + rw)
                                       : make_float2(-INFINITY, 0.f);
      float* row = g_lp + (size_t)rw * width;
      const float4 terms = slice_terms(row, width, q, lane);
      if (lane == 0) g_mpart[rank * beam + rw] = terms;
      const float lp_parent = __ldcg(g_logp + rw);
      float* sc = g_sc + (size_t)rw * width;
      for (int c = lane; c < width; c += 32) sc[c] = row[c] + lp_parent;
    }
    __syncthreads();
    slice_top(g_sc, g_lp, beam, width, V, v_lo, g_cand + rank * beam, s_hist, s_pick, &s_count);
    cluster.sync();  // (3) every block's top-beam and metric terms are written

    if (leader) {
      // ---- D: the exact global top-beam; parent rows' metrics ----
      rank_merge(g_cand, kCluster * beam, beam, V, s_keys, g_score, g_hi, g_tk, g_sel_lp);
      for (int row = warp; row < beam; row += kWarps) {
        const float4 q = lane < kCluster ? __ldcg(g_mpart + lane * beam + row)
                                         : make_float4(0.f, 0.f, -1.f, -1.f);
        const float4 met = parent_metrics(q, tsallis_max, max_entropy);
        if (lane == 0) g_met[row] = met;
      }
      __syncthreads();

      const unsigned short* tok_old = g_hist + (size_t)s_cur * beam * ts;
      unsigned short* tok_new = g_hist + (size_t)(s_cur ^ 1) * beam * ts;

      // ---- parent gather: 16 bytes (8 tokens) a copy, loads batched ahead of stores ----
      {
        constexpr int kBatch = 4;
        const int q = ts / 8, n_copy = beam * q;
        const uint4* src = reinterpret_cast<const uint4*>(tok_old);
        uint4* dst = reinterpret_cast<uint4*>(tok_new);
        for (int i0 = tid; i0 < n_copy; i0 += kBatch * kThreads) {
          uint4 v[kBatch];
          int at[kBatch];
#pragma unroll
          for (int c = 0; c < kBatch; ++c) {
            const int i = i0 + c * kThreads, j = i / q, u = i - j * q;
            at[c] = -1;
            if (i < n_copy && 8 * u < g_n[g_hi[j]]) {
              v[c] = src[(size_t)g_hi[j] * q + u];
              at[c] = i;
            }
          }
#pragma unroll
          for (int c = 0; c < kBatch; ++c)
            if (at[c] >= 0) dst[at[c]] = v[c];
        }
      }
      __syncthreads();

      // ---- token append, contexts, hotword step, sequence hash, records ----
      for (int j = tid; j < beam; j += kThreads) {
        const int hi = g_hi[j], tk = g_tk[j], pn = g_n[hi];
        const bool is_blank = tk == blank;
        if (!is_blank) tok_new[(size_t)j * ts + pn] = (unsigned short)tk;
        g_newn[j] = pn + (is_blank ? 0 : 1);
        for (int k = 0; k < K; ++k)
          g_newctx[j * kMaxCtx + k] = is_blank ? g_ctx[hi * kMaxCtx + k]
                                               : (k + 1 < K ? g_ctx[hi * kMaxCtx + k + 1] : tk);
        const int p_hw = g_hw[hi];
        float boost = 0.f;
        int nhw = p_hw;
        if (S > 0 && !is_blank && tk != unk) {
          const size_t cell = (size_t)p_hw * V + tk;
          boost = hw_delta[cell];
          nhw = hw_next[cell];
        }
        g_boost[j] = g_score[j] + boost;
        g_newhw[j] = nhw;
        g_newhash[j] = is_blank ? g_hash[hi] : hash_step(g_hash[hi], tk);
        const size_t r = ((size_t)b * T + t) * beam + j;
        rec_par[r] = hi;
        rec_tok[r] = tk;
        rec_lp[r] = g_sel_lp[j];
        const float4 met = g_met[hi];
        rec_met[r * 4 + 0] = met.x;
        rec_met[r * 4 + 1] = met.y;
        rec_met[r * 4 + 2] = met.z;
        rec_met[r * 4 + 3] = met.w;
      }
      __syncthreads();

      // ---- dedup: each beam's first earlier beam with the same sequence ----
      // A warp per beam j; tokens compared only where length and hash agree.
      for (int j = warp; j < beam; j += kWarps) {
        const int nj = g_newn[j];
        const unsigned long long hj = g_newhash[j];
        int canon = j;
        for (int i0 = 0; i0 < j && canon == j; i0 += 32) {
          const int i = i0 + lane;
          unsigned bal =
              __ballot_sync(0xffffffffu, i < j && g_newn[i] == nj && g_newhash[i] == hj);
          while (bal && canon == j) {
            const int c = i0 + __ffs(bal) - 1;
            bal &= bal - 1;
            if (same_tokens(tok_new + (size_t)c * ts, tok_new + (size_t)j * ts, nj, lane))
              canon = c;
          }
        }
        if (lane == 0) g_canon[j] = canon;
      }
      __syncthreads();

      // ---- log-add merge into the first beam of each group; commit state ----
      // A thread per beam; each group's max and sum run over j in order.
      for (int i = tid; i < beam; i += kThreads) {
        float m = kNegInf;
        for (int j = 0; j < beam; ++j) m = fmaxf(m, g_canon[j] == i ? g_boost[j] : kNegInf);
        float se = 0.f;
        for (int j = 0; j < beam; ++j) se += expf((g_canon[j] == i ? g_boost[j] : kNegInf) - m);
        g_logp[i] = g_canon[i] == i ? m + logf(se) : kNegInf;
        g_n[i] = g_newn[i];
        g_hw[i] = g_newhw[i];
        g_hash[i] = g_newhash[i];
        for (int k = 0; k < K; ++k) g_ctx[i * kMaxCtx + k] = g_newctx[i * kMaxCtx + k];
      }
      if (tid == 0) s_cur ^= 1;
    }
    cluster.sync();  // (4) the leader's new state is published
  }
  cluster.sync();
  if (!leader) return;
  finish_chunk(g_logp, g_n, g_hw, g_hist + (size_t)s_cur * beam * ts, ts, beam, K, S, hw_node,
               b, T, len, blank, rec_par, rec_tok, rec_lp, rec_met, out_tokens, out_frames,
               out_tok_logp, out_entropy, out_n, out_logp, &s_best, tid);
}

// A cluster of kCluster blocks a chunk, `smem` bytes of dynamic shared
// memory a block; the status of the launch.
template <class Kernel, class... Args>
cudaError_t launch_cluster(Kernel kernel, int B, size_t smem, cudaStream_t st, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MB>
cudaError_t launch_beam(const float* enc, const int* lens, const float* emb,
                        const float* conv_w, const float* we, const float* be,
                        const float* wdp, const float* bdp, const float* wo, const float* bo,
                        const int* hw_next, const float* hw_delta, const float* hw_node,
                        int* rec_par, int* rec_tok, float* rec_lp, float* rec_met,
                        int* out_tokens, int* out_frames,
                        float* out_tok_logp, float* out_entropy, int* out_n, float* out_logp,
                        int B, int T, int E, int D, int ipg, int K, int J, int V, int beam,
                        int blank, int unk, int S, float tsallis_max, float max_entropy,
                        cudaStream_t st) {
  return launch_cluster(beam_kernel<MB>, B, Cap<MB>::smem(T, E, D, J, V), st, enc, lens, emb,
                        conv_w, we, be, wdp, bdp, wo, bo, hw_next, hw_delta, hw_node, rec_par,
                        rec_tok, rec_lp, rec_met, out_tokens, out_frames, out_tok_logp,
                        out_entropy, out_n, out_logp, T, E, D, ipg, K, J, V, beam, blank, unk,
                        S, tsallis_max, max_entropy);
}

bool bad_args(int beam, int K, int V, int D, int ipg, int S, const int* hw_next,
              const float* hw_delta, const float* hw_node) {
  return beam < 1 || K < 1 || K > kMaxCtx || V < 2 || V > 65536 || D % ipg != 0 || S < 0 ||
         (long long)S * V >= (1LL << 31) || (long long)beam * V >= (1LL << 31) ||
         (S > 0 && (!hw_next || !hw_delta || !hw_node));
}

}  // namespace

// The cap kernels, beams 1 to 16.
extern "C" int svt_beam_search(
    const float* enc, const int* lens, const float* emb, const float* conv_w,
    const float* we, const float* be, const float* wdp, const float* bdp,
    const float* wo, const float* bo, const int* hw_next, const float* hw_delta,
    const float* hw_node, int* rec_par, int* rec_tok, float* rec_lp,
    float* rec_met, int* out_tokens, int* out_frames, float* out_tok_logp,
    float* out_entropy, int* out_n, float* out_logp, int B, int T, int E, int D,
    int ipg, int K, int J, int V, int beam, int blank, int unk, int S,
    float tsallis_max, float max_entropy, void* stream) {
  if (beam > kMaxCap || bad_args(beam, K, V, D, ipg, S, hw_next, hw_delta, hw_node))
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
#define SVT_BEAM_ARGS                                                                      \
  enc, lens, emb, conv_w, we, be, wdp, bdp, wo, bo, hw_next, hw_delta, hw_node, rec_par,  \
      rec_tok, rec_lp, rec_met, out_tokens, out_frames, out_tok_logp, out_entropy,        \
      out_n, out_logp, B, T, E, D, ipg, K, J, V, beam, blank, unk, S, tsallis_max,        \
      max_entropy, st
  if (beam <= 8) return (int)launch_beam<8>(SVT_BEAM_ARGS);
  return (int)launch_beam<16>(SVT_BEAM_ARGS);
#undef SVT_BEAM_ARGS
}

// Bytes of one chunk's workspace of the tiled kernel.
extern "C" long long svt_beam_tiled_workspace_bytes(int T, int J, int V, int beam) {
  return (long long)Tiled(T, J, V, beam).bytes;
}

// The tiled kernel at any beam >= 1 (the wrapper sends it the beams past
// 16). ws: the per-chunk workspaces, B x svt_beam_tiled_workspace_bytes
// bytes (ws_bytes, checked).
extern "C" int svt_beam_search_tiled(
    const float* enc, const int* lens, const float* emb, const float* conv_w,
    const float* we, const float* be, const float* wdp, const float* bdp,
    const float* wo, const float* bo, const int* hw_next, const float* hw_delta,
    const float* hw_node, int* rec_par, int* rec_tok, float* rec_lp,
    float* rec_met, void* ws, long long ws_bytes, int* out_tokens, int* out_frames,
    float* out_tok_logp, float* out_entropy, int* out_n, float* out_logp, int B, int T, int E,
    int D, int ipg, int K, int J, int V, int beam, int blank, int unk, int S,
    float tsallis_max, float max_entropy, void* stream) {
  if (bad_args(beam, K, V, D, ipg, S, hw_next, hw_delta, hw_node) || ws == nullptr ||
      ws_bytes < (long long)B * (long long)Tiled(T, J, V, beam).bytes)
    return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(beam_kernel_tiled, B, tiled_smem(E, D, J, V),
                             (cudaStream_t)stream, enc, lens, emb, conv_w, we, be, wdp, bdp,
                             wo, bo, hw_next, hw_delta, hw_node, rec_par, rec_tok, rec_lp,
                             rec_met, static_cast<unsigned char*>(ws), out_tokens, out_frames,
                             out_tok_logp, out_entropy, out_n, out_logp, T, E, D, ipg, K, J, V,
                             beam, blank, unk, S, tsallis_max, max_entropy);
}
