// Kaldi log-mel of windowed frames: DFT -> power -> mel -> log, one kernel.
//
// Replaces: sherpa_vietnamese_asr_tpu/ops/fbank.py _logmel_kernel (launcher
// _logmel_pallas), the TPU kernel that multiplies a 256-frame tile by cos and
// sin DFT bases padded to 384 lanes in a 3-pass bf16 split.
//
// What bounds it on the H100: arithmetic. Per frame the DFT is
// 2 x 512 x 257 multiply-adds (the mel projection adds 257 x 80), about
// 14 GFLOP for a batch of 8 x 33 s (26,400 frames), against 54 MB of frames
// read and 8.4 MB of features written. The DFT has catastrophic
// cancellation, so the kernel keeps full fp32 FMA: no TF32 and no
// low-precision pass (a single low-precision DFT pass is a recorded failure,
// 1.54 max-abs log-mel error).
//
// Design: one block of 128 threads per tile of 16 frames. The tile is staged
// in shared memory (32 KB, reused for the power spectrum); thread i owns
// real bins i, i+128, i+256 for all 16 frames and runs the 512-deep DFT in registers (16 x 3 cos and sin
// sums), reading each basis row once per block, coalesced and L2-resident
// (1 MB for both bases). Only the 257 real bins are computed, not the 384
// lanes of TPU padding. The epilogue is fused: power goes to shared memory,
// then each thread projects onto the 80 mel filters and writes
// log(max(mel, floor)). SIMT fp32 rather than tensor cores keeps exact fp32
// products; a 3xTF32 tensor-core version is later speed work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFrames = 16;     // frames per block
constexpr int kThreads = 128;   // threads per block
constexpr int kMaxFft = 512;
constexpr int kBinsPerThread = 3;  // 3 x 128 = 384 >= 257 real bins

__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ frames, const float* __restrict__ cosb,
              const float* __restrict__ sinb, const float* __restrict__ mel,
              float* __restrict__ out, int n_frames, int n_fft, int n_spec,
              int n_mel, float log_floor) {
  // The frame tile, then (after the DFT) the power spectrum: 32 KB either way.
  __shared__ float s_buf[kFrames * kMaxFft];
  float (*s_frames)[kMaxFft] = reinterpret_cast<float (*)[kMaxFft]>(s_buf);
  constexpr int kSpecPad = kBinsPerThread * kThreads;
  float (*s_power)[kSpecPad] = reinterpret_cast<float (*)[kSpecPad]>(s_buf);

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kFrames;
  const int nf = min(kFrames, n_frames - f0);

  for (int i = tid; i < kFrames * n_fft; i += kThreads) {
    const int f = i / n_fft, k = i % n_fft;
    s_frames[f][k] = f < nf ? frames[(size_t)(f0 + f) * n_fft + k] : 0.f;
  }
  __syncthreads();

  float re[kFrames][kBinsPerThread];
  float im[kFrames][kBinsPerThread];
#pragma unroll
  for (int f = 0; f < kFrames; ++f)
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) re[f][j] = im[f][j] = 0.f;

  int bin[kBinsPerThread];
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) bin[j] = min(tid + j * kThreads, n_spec - 1);

  for (int k = 0; k < n_fft; ++k) {
    float c[kBinsPerThread], s[kBinsPerThread];
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j) {
      c[j] = __ldg(cosb + (size_t)k * n_spec + bin[j]);
      s[j] = __ldg(sinb + (size_t)k * n_spec + bin[j]);
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      const float x = s_frames[f][k];  // broadcast read
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j) {
        re[f][j] = fmaf(x, c[j], re[f][j]);
        im[f][j] = fmaf(x, s[j], im[f][j]);
      }
    }
  }
  __syncthreads();  // every thread is done reading the frames
#pragma unroll
  for (int f = 0; f < kFrames; ++f)
#pragma unroll
    for (int j = 0; j < kBinsPerThread; ++j)
      s_power[f][tid + j * kThreads] =
          re[f][j] * re[f][j] + im[f][j] * im[f][j];
  __syncthreads();

  for (int o = tid; o < nf * n_mel; o += kThreads) {
    const int f = o / n_mel, m = o % n_mel;
    float acc = 0.f;
    for (int k = 0; k < n_spec; ++k)
      acc = fmaf(s_power[f][k], __ldg(mel + (size_t)k * n_mel + m), acc);
    out[(size_t)(f0 + f) * n_mel + m] = logf(fmaxf(acc, log_floor));
  }
}

}  // namespace

extern "C" int svt_fbank_logmel(const float* frames, const float* cosb,
                                const float* sinb, const float* mel, float* out,
                                int n_frames, int n_fft, int n_spec, int n_mel,
                                float log_floor, void* stream) {
  if (n_fft > kMaxFft || n_spec > kBinsPerThread * kThreads)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_frames + kFrames - 1) / kFrames;
  logmel_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      frames, cosb, sinb, mel, out, n_frames, n_fft, n_spec, n_mel, log_floor);
  return (int)cudaGetLastError();
}

extern "C" const char* svt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
