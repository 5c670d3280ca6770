// Kaldi log-mel of windowed frames: real FFT -> power -> mel -> log, one kernel.
//
// Replaces: sherpa_vietnamese_asr_tpu/ops/fbank.py:149 _logmel_kernel (launcher
// _logmel_pallas), the TPU kernel that multiplies a 256-frame tile by cos and
// sin DFT bases padded to 384 lanes in a 3-pass bf16 split. The TPU wrote the
// transform as a matrix product because its matrix unit is its only fast path.
//
// What bounds it on the H100: bytes. A 512-point real FFT is about 10 kFLOP a
// frame (the DFT was 526 kFLOP), so a batch of 8 x 33 s (26,400 frames) is
// well under 1 GFLOP against 54 MB of frames read and 8.4 MB of features
// written: about 19 us at 3.35 TB/s. Inside the SM the work is shared-memory
// traffic, one read and one write of the frame per FFT stage.
//
// Design: a persistent grid (as many blocks as fit on every SM) walks over
// tiles of 4096 / n_fft frames (8 at n_fft 512). Each block double-buffers its
// tiles: 16-byte cp.async copies bring the next tile into shared memory while
// it transforms the current one. A frame's n_fft reals are read as n_fft / 2
// complex points z[i] = x[2i] + i x[2i+1]; a Stockham autosort FFT (radix 4,
// then one radix-2 stage when log2(n_fft / 2) is odd) ping-pongs each tile
// between its buffer and a work buffer, the threads taking frames fastest and
// the rows padded by 4 floats so that a warp's accesses fall in distinct
// banks. The real-split step turns the n_fft / 2 complex bins into the real
// spectrum's bins 0 .. n_fft / 2 - 1 (Kaldi's mel bank is zero at the Nyquist
// bin) and writes their power to shared memory; then each mel filter sums
// only its own bins (the compact form built on the host, at most 16 a filter
// at the three configs) and the kernel writes log(max(mel, floor)). There is
// one instantiation per n_fft (64 .. 1024), so every stage's shifts, strides
// and trip counts are constants. Twiddles come from a table computed in
// float64 on the host. All arithmetic is full fp32 with the accurate logf:
// the DFT's cancellation is a recorded trap, and the FFT's rounding error
// grows as log2 n_fft where the DFT's grows as sqrt(n_fft).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFloats = 4096;  // floats of frames per tile
constexpr int kRowPad = 4;         // floats of padding after each row in shared memory

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) {  // a * -i
  return make_float2(a.y, -a.x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for every group but the one committed last.
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts copying tile `tile` (frames tile*ft ..) into rows of n_fft + kRowPad
// floats at `dst`, as one cp.async group. Pieces past the last frame are
// zero-filled (source size 0), so a ragged tile transforms zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ frames,
                                          long long tile, int row, int lpieces,
                                          long long total) {
  const long long base = tile * kTileFloats;
  for (int c = threadIdx.x; c < kTileFloats / 4; c += kThreads) {
    const long long g = base + 4LL * c;
    const bool in = g < total;
    const int f = c >> lpieces, q = c & ((1 << lpieces) - 1);
    cp_async16(dst + f * row + 4 * q, frames + (in ? g : 0), in ? 16 : 0);
  }
  cp_async_commit();
}

// One Stockham stage, radix 2^kLr at sub-transform size 2^kLns, over every
// frame of the tile: thread p takes frame p % ft and butterfly p / ft, so a
// warp's accesses fall in distinct banks. Every shift is a constant.
template <int kLogFft, int kLns, int kLr>
__device__ __forceinline__ void fft_stage(const float* src, float* dst, const float2* s_tw) {
  constexpr int lft = 12 - kLogFft, ft = 1 << lft;  // frames per tile (kTileFloats = 2^12)
  constexpr int row = (1 << kLogFft) + kRowPad;
  constexpr int per = 1 << (kLogFft - 1 - kLr);      // butterflies per frame
  constexpr int ns = 1 << kLns;
  constexpr int ltstep = kLogFft - kLns - kLr;       // twiddle step n_fft / (ns * radix)
  constexpr int count = ft * per;
  static_assert(count % kThreads == 0, "whole passes of the block");
#pragma unroll
  for (int i = 0; i < count / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int f = p & (ft - 1), j = p >> lft;
    const int k = j & (ns - 1);
    const float2* s = reinterpret_cast<const float2*>(src + f * row);
    float2* d = reinterpret_cast<float2*>(dst + f * row);
    const int dj = ((j - k) << kLr) + k;
    const int t = k << ltstep;
    if constexpr (kLr == 2) {
      const float2 v0 = s[j];
      const float2 v1 = cmul(s[j + per], s_tw[t]);
      const float2 v2 = cmul(s[j + 2 * per], s_tw[2 * t]);
      const float2 v3 = cmul(s[j + 3 * per], s_tw[3 * t]);
      const float2 a0 = cadd(v0, v2), a1 = csub(v0, v2);
      const float2 a2 = cadd(v1, v3), a3 = mul_neg_i(csub(v1, v3));
      d[dj] = cadd(a0, a2);
      d[dj + ns] = cadd(a1, a3);
      d[dj + 2 * ns] = csub(a0, a2);
      d[dj + 3 * ns] = csub(a1, a3);
    } else {
      const float2 v0 = s[j];
      const float2 v1 = cmul(s[j + per], s_tw[t]);
      d[dj] = cadd(v0, v1);
      d[dj + ns] = csub(v0, v1);
    }
  }
}

// The stages from sub-transform size 2^kLns on: radix 4 while two or more
// factors of 2 remain, then radix 2. Ping-pongs between the two buffers and
// returns the one that holds the transform.
template <int kLogFft, int kLns>
__device__ __forceinline__ float* fft(float* src, float* dst, const float2* s_tw) {
  constexpr int lm = kLogFft - 1;  // log2 of the complex points per frame
  if constexpr (kLns >= lm) {
    return src;
  } else {
    constexpr int lr = lm - kLns >= 2 ? 2 : 1;
    fft_stage<kLogFft, kLns, lr>(src, dst, s_tw);
    __syncthreads();
    return fft<kLogFft, kLns + lr>(dst, src, s_tw);
  }
}

template <int kLogFft>
__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ frames, const float2* __restrict__ twiddle,
              const int* __restrict__ mel_first, const int* __restrict__ mel_offset,
              const float* __restrict__ mel_weight, float* __restrict__ out, int n_frames,
              int n_mel, int n_weights, float log_floor) {
  constexpr int n_fft = 1 << kLogFft;
  constexpr int m = n_fft >> 1, lm = kLogFft - 1;  // complex points per frame
  constexpr int lft = 12 - kLogFft, ft = 1 << lft;  // frames per tile (kTileFloats = 2^12)
  constexpr int row = n_fft + kRowPad;              // floats per frame row
  constexpr int prow = m + kRowPad;                 // floats per power row
  const int tid = threadIdx.x;

  extern __shared__ float4 smem4[];
  float* s_tile0 = reinterpret_cast<float*>(smem4);
  float* s_tile1 = s_tile0 + ft * row;
  float* s_work = s_tile1 + ft * row;
  float2* s_tw = reinterpret_cast<float2*>(s_work + ft * row);
  int* s_first = reinterpret_cast<int*>(s_tw + n_fft);
  int* s_off = s_first + n_mel;
  float* s_w = reinterpret_cast<float*>(s_off + n_mel + 1);

  const int tiles = (n_frames + ft - 1) / ft;
  const long long total = static_cast<long long>(n_frames) * n_fft;
  int tile = blockIdx.x;  // the grid never exceeds the tile count
  load_tile(s_tile0, frames, tile, row, kLogFft - 2, total);
  for (int i = tid; i < n_fft; i += kThreads) s_tw[i] = twiddle[i];
  for (int i = tid; i < n_mel; i += kThreads) s_first[i] = mel_first[i];
  for (int i = tid; i <= n_mel; i += kThreads) s_off[i] = mel_offset[i];
  for (int i = tid; i < n_weights; i += kThreads) s_w[i] = mel_weight[i];

  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    float* cur = (it & 1) ? s_tile1 : s_tile0;
    const int next = tile + gridDim.x;
    if (next < tiles)
      load_tile((it & 1) ? s_tile0 : s_tile1, frames, next, row, kLogFft - 2, total);
    else
      cp_async_commit();  // an empty group: "all but the last" is still this tile
    cp_async_wait_all_but_last();
    __syncthreads();

    // 1. Stockham FFT of the m complex points of every frame of the tile.
    const float* z_tile = fft<kLogFft, 0>(cur, s_work, s_tw);
    float* power = z_tile == cur ? s_work : cur;

    // 2. Real split: with Z the FFT of z, the even samples' spectrum is
    // E[k] = (Z[k] + conj Z[m-k]) / 2, the odd samples' O[k] = (Z[k] -
    // conj Z[m-k]) / 2i, and X[k] = E[k] + W^k O[k]. Power rows go to `power`.
    static_assert((ft << lm) % kThreads == 0, "whole passes of the block");
#pragma unroll
    for (int i = 0; i < (ft << lm) / kThreads; ++i) {
      const int p = tid + i * kThreads;
      const int f = p & (ft - 1), k = p >> lft;
      const float2* z = reinterpret_cast<const float2*>(z_tile + f * row);
      const float2 a = z[k], c = z[(m - k) & (m - 1)];
      const float2 b = make_float2(c.x, -c.y);
      const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y + b.y));
      const float2 diff = csub(a, b);
      const float2 o = make_float2(0.5f * diff.y, -0.5f * diff.x);
      const float2 x = cadd(e, cmul(s_tw[k], o));
      power[f * prow + k] = x.x * x.x + x.y * x.y;
    }
    __syncthreads();

    // 3. Mel filters over their own bins, then log(max(mel, floor)). Threads
    // take frames fastest, so a warp holds a few neighbouring filters, of
    // about the same length, and its bin loops stay in step.
    const int f0 = tile * ft;
    const int nf = min(ft, n_frames - f0);
    for (int p = tid; p < (n_mel << lft); p += kThreads) {
      const int f = p & (ft - 1), b = p >> lft;
      if (f >= nf) continue;
      const float* pw = power + f * prow + s_first[b];
      const float* w = s_w + s_off[b];
      const int len = s_off[b + 1] - s_off[b];
      float acc = 0.f;
#pragma unroll 4
      for (int i = 0; i < len; ++i) acc = fmaf(pw[i], w[i], acc);
      out[static_cast<long long>(f0 + f) * n_mel + b] = logf(fmaxf(acc, log_floor));
    }
    __syncthreads();  // the next iteration's copy overwrites this tile's buffer
  }
}

template <int kLogFft>
cudaError_t launch(const float* frames, const float* twiddle, const int* mel_first,
                   const int* mel_offset, const float* mel_weight, float* out, int n_frames,
                   int n_mel, int n_weights, float log_floor, cudaStream_t stream) {
  constexpr int n_fft = 1 << kLogFft, ft = kTileFloats / n_fft;
  const size_t smem = 3 * sizeof(float) * ft * (n_fft + kRowPad) + sizeof(float2) * n_fft +
                      sizeof(int) * (2 * n_mel + 1) + sizeof(float) * n_weights;
  cudaError_t err = cudaFuncSetAttribute(
      logmel_kernel<kLogFft>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, logmel_kernel<kLogFft>,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles = (n_frames + ft - 1) / ft;
  const int grid = tiles < per_sm * sms ? tiles : per_sm * sms;
  logmel_kernel<kLogFft><<<grid, kThreads, smem, stream>>>(
      frames, reinterpret_cast<const float2*>(twiddle), mel_first, mel_offset, mel_weight, out,
      n_frames, n_mel, n_weights, log_floor);
  return cudaGetLastError();
}

}  // namespace

extern "C" int svt_fbank_logmel(const float* frames, const float* twiddle,
                                const int* mel_first, const int* mel_offset,
                                const float* mel_weight, float* out, int n_frames,
                                int n_fft, int n_mel, int n_weights, float log_floor,
                                void* stream) {
  if (n_frames <= 0 || n_mel <= 0 || n_weights < 0 ||
      reinterpret_cast<size_t>(frames) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (n_fft) {  // the powers of two from 64 to 1024
    case 64:
      err = launch<6>(frames, twiddle, mel_first, mel_offset, mel_weight, out, n_frames, n_mel,
                      n_weights, log_floor, s);
      break;
    case 128:
      err = launch<7>(frames, twiddle, mel_first, mel_offset, mel_weight, out, n_frames, n_mel,
                      n_weights, log_floor, s);
      break;
    case 256:
      err = launch<8>(frames, twiddle, mel_first, mel_offset, mel_weight, out, n_frames, n_mel,
                      n_weights, log_floor, s);
      break;
    case 512:
      err = launch<9>(frames, twiddle, mel_first, mel_offset, mel_weight, out, n_frames, n_mel,
                      n_weights, log_floor, s);
      break;
    case 1024:
      err = launch<10>(frames, twiddle, mel_first, mel_offset, mel_weight, out, n_frames, n_mel,
                       n_weights, log_floor, s);
      break;
  }
  return static_cast<int>(err);
}

extern "C" const char* svt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
