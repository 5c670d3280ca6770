// clusterkit — native host-side clustering math for the Senko long-audio
// diarization path.
//
// The reference app's >= 20 min clustering route is UMAP + HDBSCAN
// (reference core/speaker_diarization_senko_campp.py:263-281) via the
// third-party `umap-learn`/`hdbscan` packages (numba-compiled). This is the
// framework's first-party equivalent of the one piece that cannot be
// vectorized in numpy: the UMAP stochastic-gradient layout loop
// (optimize_layout_euclidean in the UMAP paper / reference open-source
// implementation). Everything around it (kNN graph, fuzzy simplicial set,
// spectral init, HDBSCAN tree) lives in utils/clustering.py.
//
// Exposed as a C ABI consumed via ctypes (utils/native.py) with a pure-numpy
// fallback when the shared library has not been built.
//
// Build: g++ -O3 -shared -fPIC clusterkit.cpp -o libclusterkit.so

#include <cmath>
#include <cstdint>

extern "C" {

// Deterministic xorshift64* RNG — the layout must be reproducible across
// runs/hosts (the third-party implementation is not; we pin a seed).
static inline uint64_t xs64(uint64_t* s) {
  uint64_t x = *s;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *s = x;
  return x * 0x2545F4914F6CDD1DULL;
}

static inline float clip4(float v) {
  return v > 4.0f ? 4.0f : (v < -4.0f ? -4.0f : v);
}

// UMAP layout optimization (euclidean output metric, move_other=true).
//
// emb:       [n, dim] float32, updated in place.
// head/tail: [n_edges] int32 edge endpoints of the fuzzy simplicial set
//            (directed; both orientations present after symmetrization).
// eps:       [n_edges] double epochs_per_sample schedule.
// Per-epoch semantics match the reference algorithm: an edge fires when its
// epoch_of_next_sample <= epoch; each firing applies one attractive update
// and `neg_rate`-scheduled repulsive updates against uniform random points;
// learning rate decays linearly from initial_alpha to 0.
int ck_umap_layout(float* emb, int64_t n, int32_t dim, const int32_t* head,
                   const int32_t* tail, const double* eps, int64_t n_edges,
                   int32_t n_epochs, float a, float b, float initial_alpha,
                   int32_t neg_rate, uint64_t seed) {
  if (n <= 0 || dim <= 0 || n_edges < 0) return -1;
  double* next_sample = new double[n_edges];
  double* next_neg = new double[n_edges];
  for (int64_t i = 0; i < n_edges; ++i) {
    next_sample[i] = eps[i];
    next_neg[i] = eps[i] / neg_rate;
  }
  uint64_t rng = seed ? seed : 0x9E3779B97F4A7C15ULL;
  for (int32_t epoch = 0; epoch < n_epochs; ++epoch) {
    const float alpha =
        initial_alpha * (1.0f - (float)epoch / (float)n_epochs);
    for (int64_t e = 0; e < n_edges; ++e) {
      if (next_sample[e] > epoch) continue;
      float* cur = emb + (int64_t)head[e] * dim;
      float* oth = emb + (int64_t)tail[e] * dim;
      float d2 = 0.0f;
      for (int32_t k = 0; k < dim; ++k) {
        const float diff = cur[k] - oth[k];
        d2 += diff * diff;
      }
      if (d2 > 0.0f) {
        // attractive: -2ab d^{2(b-1)} / (1 + a d^{2b})
        float coeff = (-2.0f * a * b * powf(d2, b - 1.0f)) /
                      (a * powf(d2, b) + 1.0f);
        for (int32_t k = 0; k < dim; ++k) {
          const float g = clip4(coeff * (cur[k] - oth[k]));
          cur[k] += g * alpha;
          oth[k] -= g * alpha;
        }
      }
      next_sample[e] += eps[e];
      const double eps_neg = eps[e] / neg_rate;
      const int32_t n_neg = (int32_t)((epoch - next_neg[e]) / eps_neg);
      for (int32_t s = 0; s < n_neg; ++s) {
        const int64_t other = (int64_t)(xs64(&rng) % (uint64_t)n);
        float* neg = emb + other * dim;
        float nd2 = 0.0f;
        for (int32_t k = 0; k < dim; ++k) {
          const float diff = cur[k] - neg[k];
          nd2 += diff * diff;
        }
        if (nd2 > 0.0f) {
          // repulsive: 2b / ((0.001 + d^2)(1 + a d^{2b}))
          const float coeff =
              (2.0f * b) / ((0.001f + nd2) * (a * powf(nd2, b) + 1.0f));
          for (int32_t k = 0; k < dim; ++k)
            cur[k] += clip4(coeff * (cur[k] - neg[k])) * alpha;
        } else if (other != head[e]) {
          for (int32_t k = 0; k < dim; ++k) cur[k] += 4.0f * alpha;
        }
      }
      next_neg[e] += n_neg * eps_neg;
    }
  }
  delete[] next_sample;
  delete[] next_neg;
  return 0;
}

// Prim MST over the implicit mutual-reachability graph:
//   mr(i, j) = max(core[i], core[j], ||x_i - x_j||)
// x: [n, dim] float32, core: [n] float32. Outputs (n-1) edges as
// (mst_a[i], mst_b[i], mst_w[i]). O(n^2 dim) time, O(n) memory.
int ck_mr_mst(const float* x, const float* core, int64_t n, int32_t dim,
              int32_t* mst_a, int32_t* mst_b, float* mst_w) {
  if (n <= 1) return n == 1 ? 0 : -1;
  float* best = new float[n];
  int32_t* src = new int32_t[n];
  bool* in_tree = new bool[n];
  for (int64_t i = 0; i < n; ++i) {
    best[i] = 3.4e38f;
    src[i] = 0;
    in_tree[i] = false;
  }
  int64_t cur = 0;
  in_tree[0] = true;
  for (int64_t t = 0; t < n - 1; ++t) {
    const float* xc = x + cur * dim;
    const float cc = core[cur];
    float pick_w = 3.4e38f;
    int64_t pick = -1;
    for (int64_t j = 0; j < n; ++j) {
      if (in_tree[j]) continue;
      float d2 = 0.0f;
      const float* xj = x + j * dim;
      for (int32_t k = 0; k < dim; ++k) {
        const float diff = xc[k] - xj[k];
        d2 += diff * diff;
      }
      float mr = sqrtf(d2);
      if (cc > mr) mr = cc;
      if (core[j] > mr) mr = core[j];
      if (mr < best[j]) {
        best[j] = mr;
        src[j] = (int32_t)cur;
      }
      if (best[j] < pick_w) {
        pick_w = best[j];
        pick = j;
      }
    }
    mst_a[t] = src[pick];
    mst_b[t] = (int32_t)pick;
    mst_w[t] = pick_w;
    in_tree[pick] = true;
    cur = pick;
  }
  delete[] best;
  delete[] src;
  delete[] in_tree;
  return 0;
}

}  // extern "C"
