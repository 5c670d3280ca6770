// Copied from sherpa_vietnamese_asr_tpu/native/audiokit.cpp (host C++; only the package path changes).
// audiokit — native host-side audio frontend.
//
// The reference app's audio I/O substrate is third-party native code
// (ffmpeg/soxr pipes, kaldi-native-fbank C++; see SURVEY.md section 2.4).
// This is the framework's first-party equivalent for the host-bound work
// that should not ride the TPU: WAV (RIFF) decode with mono mixdown and a
// Kaiser-windowed polyphase resampler. Exposed as a C ABI consumed via
// ctypes (sherpa_vietnamese_asr_tpu_torch/utils/native.py) with a pure-numpy
// fallback when the shared library has not been built.
//
// Build: g++ -O3 -march=native -shared -fPIC audiokit.cpp -o libaudiokit.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

// Parse a RIFF/WAVE file from memory. Returns 0 on success.
// Outputs: *out_rate, *out_channels, *out_frames. If out_pcm is non-null it
// must hold out_frames floats; the decoded MONO (averaged) float32 samples
// are written there.
int audiokit_wav_decode(const uint8_t* buf, int64_t len, int32_t* out_rate,
                        int32_t* out_channels, int64_t* out_frames,
                        float* out_pcm) {
  if (len < 12 || memcmp(buf, "RIFF", 4) != 0 ||
      memcmp(buf + 8, "WAVE", 4) != 0)
    return -1;
  int64_t pos = 12;
  int fmt_tag = 0, channels = 0, rate = 0, bits = 0;
  const uint8_t* data = nullptr;
  int64_t data_len = 0;
  while (pos + 8 <= len) {
    const uint8_t* cid = buf + pos;
    uint32_t size;
    memcpy(&size, buf + pos + 4, 4);
    pos += 8;
    if (memcmp(cid, "fmt ", 4) == 0 && pos + 16 <= len) {
      uint16_t tag, ch, b;
      uint32_t r;
      memcpy(&tag, buf + pos, 2);
      memcpy(&ch, buf + pos + 2, 2);
      memcpy(&r, buf + pos + 4, 4);
      memcpy(&b, buf + pos + 14, 2);
      fmt_tag = tag;
      channels = ch;
      rate = (int)r;
      bits = b;
      if (fmt_tag == 0xFFFE && size >= 40 && pos + 26 <= len) {
        uint16_t sub;
        memcpy(&sub, buf + pos + 24, 2);
        fmt_tag = sub;
      }
    } else if (memcmp(cid, "data", 4) == 0) {
      data = buf + pos;
      data_len = size;
      if (pos + data_len > len) data_len = len - pos;
    }
    pos += size + (size & 1);
    if (data && fmt_tag) break;
  }
  if (!data || channels <= 0 || rate <= 0) return -2;

  int bytes_per = bits / 8;
  int64_t total = data_len / (bytes_per * channels);
  *out_rate = rate;
  *out_channels = channels;
  *out_frames = total;
  if (!out_pcm) return 0;

  const double inv_ch = 1.0 / channels;
  for (int64_t i = 0; i < total; i++) {
    double acc = 0.0;
    for (int c = 0; c < channels; c++) {
      const uint8_t* p = data + (i * channels + c) * bytes_per;
      double v = 0.0;
      if (fmt_tag == 1) {  // PCM
        if (bits == 16) {
          int16_t s;
          memcpy(&s, p, 2);
          v = s / 32768.0;
        } else if (bits == 24) {
          int32_t s = (p[0] | (p[1] << 8) | (p[2] << 16));
          if (s >= (1 << 23)) s -= (1 << 24);
          v = s / 8388608.0;
        } else if (bits == 32) {
          int32_t s;
          memcpy(&s, p, 4);
          v = s / 2147483648.0;
        } else if (bits == 8) {
          v = ((int)p[0] - 128) / 128.0;
        } else {
          return -3;
        }
      } else if (fmt_tag == 3) {  // IEEE float
        if (bits == 32) {
          float f;
          memcpy(&f, p, 4);
          v = f;
        } else if (bits == 64) {
          double d;
          memcpy(&d, p, 8);
          v = d;
        } else {
          return -3;
        }
      } else {
        return -4;
      }
      acc += v;
    }
    out_pcm[i] = (float)(acc * inv_ch);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Polyphase resampler (Kaiser-windowed sinc), mono float32.
// ---------------------------------------------------------------------------

static double bessel_i0(double x) {
  // series expansion; converges quickly for |x| <= 20 (kaiser beta 8)
  double sum = 1.0, term = 1.0;
  double x2 = x * x / 4.0;
  for (int k = 1; k < 64; k++) {
    term *= x2 / (k * (double)k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

static int64_t gcd64(int64_t a, int64_t b) {
  while (b) {
    int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Output length for resampling n samples from sr_in to sr_out.
int64_t audiokit_resample_len(int64_t n, int32_t sr_in, int32_t sr_out) {
  int64_t g = gcd64(sr_in, sr_out);
  int64_t up = sr_out / g, down = sr_in / g;
  return (n * up) / down;  // floor, matches polyphase decimation grid
}

// Resample x[n] -> out (length audiokit_resample_len). num_zeros controls
// filter length (16 default). Returns 0 on success.
int audiokit_resample(const float* x, int64_t n, int32_t sr_in,
                      int32_t sr_out, int32_t num_zeros, float* out) {
  if (sr_in == sr_out) {
    memcpy(out, x, n * sizeof(float));
    return 0;
  }
  int64_t g = gcd64(sr_in, sr_out);
  int64_t up = sr_out / g, down = sr_in / g;
  int64_t maxud = up > down ? up : down;
  double cutoff = 0.475 / (double)maxud;
  int64_t half = num_zeros * maxud;
  int64_t klen = 2 * half + 1;

  // Kaiser(beta=8) windowed sinc, gain up (zero-stuffing compensation)
  std::vector<double> kernel(klen);
  double beta = 8.0, denom = bessel_i0(beta);
  for (int64_t i = 0; i < klen; i++) {
    double t = (double)(i - half);
    double sinc = (t == 0.0) ? 2 * cutoff
                             : sin(2 * M_PI * cutoff * t) / (M_PI * t);
    double w = (2.0 * i) / (klen - 1) - 1.0;
    double kais = bessel_i0(beta * sqrt(1.0 - w * w > 0 ? 1.0 - w * w : 0.0))
                  / denom;
    kernel[i] = sinc * kais * (double)up;
  }

  int64_t out_len = (n * up) / down;
  // Polyphase: out[j] corresponds to upsampled index j*down; the "same"
  // convolution centers the kernel, i.e. upsampled position j*down reads
  // kernel taps at (j*down - i*up + half) for input sample i.
  for (int64_t j = 0; j < out_len; j++) {
    int64_t center = j * down;  // position in upsampled grid
    // input samples i with |center - i*up| <= half
    int64_t i_lo = (center - half + up - 1) / up;
    if (i_lo < 0) i_lo = 0;
    int64_t i_hi = (center + half) / up;
    if (i_hi >= n) i_hi = n - 1;
    double acc = 0.0;
    for (int64_t i = i_lo; i <= i_hi; i++) {
      int64_t k = center - i * up + half;
      acc += (double)x[i] * kernel[k];
    }
    out[j] = (float)acc;
  }
  return 0;
}

}  // extern "C"
