# Copied from sherpa_vietnamese_asr_tpu/utils/audio_io.py (host numpy; only the package path
# changes), except resample_poly, rewritten as a polyphase sum (see its docstring).
# Audio loading: WAV fast path, ffmpeg subprocess fallback, polyphase resample.
#
# Mirrors the reference's load_audio strategy (reference core/asr_engine.py:
# 467-518 + core/audio_decode.py): WAV at the target rate reads directly;
# anything else decodes through an ffmpeg pipe (one pass decode + resample +
# mono) when ffmpeg is available. Environments without ffmpeg (like this one)
# still handle WAV of any rate/width via the pure-numpy reader + windowed-sinc
# polyphase resampler below. Decode is host I/O work and stays off-device.

from __future__ import annotations

import os
import shutil
import struct
import subprocess

import numpy as np

SAMPLE_RATE = 16000


def read_wav(path):
    """Minimal RIFF/WAVE reader: PCM 8/16/24/32-bit and float32/64.

    Returns (float32 array [T, C], sample_rate).
    """
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        fmt = None
        data = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            cid, size = head[:4], struct.unpack("<I", head[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"missing fmt/data chunk: {path}")
    (wformat, channels, rate, _brate, _align, bits) = struct.unpack(
        "<HHIIHH", fmt[:16])
    if wformat == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        wformat = struct.unpack("<H", fmt[24:26])[0]
    if wformat == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            as32 = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            as32 = np.where(as32 >= 1 << 23, as32 - (1 << 24), as32)
            x = as32.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM width: {bits}")
    elif wformat == 3:  # IEEE float
        x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAVE format tag: {wformat}")
    return x.reshape(-1, channels), rate


def write_wav(path, audio, sample_rate=SAMPLE_RATE):
    """Write mono/multichannel float32 [-1, 1] as 16-bit PCM WAV."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[:, None]
    pcm = np.round(np.clip(audio * 32767.0, -32768, 32767)).astype("<i2")
    data = pcm.tobytes()
    ch = audio.shape[1]
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, sample_rate,
                                      sample_rate * ch * 2, ch * 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def is_int16_exact(audio) -> bool:
    """True when every sample is exactly k/32768 with k in int16 range.

    Audio decoded from 16-bit PCM (the overwhelmingly common case — WAV and
    the ffmpeg s16le pipe both produce k/32768 floats) round-trips through
    an int16 device transfer bit-identically, so the half-bytes upload path
    is LOSSLESS for it: quantize x*32768 -> k (exact in fp32), dequantize
    k/32768 -> the original float. Float-valued audio (RMS-normalized, WPE,
    float WAVs) fails this test and must ship as float32."""
    audio = np.asarray(audio)
    v = audio * np.float32(32768.0)
    return bool(np.logical_and(
        np.logical_and(v >= -32768.0, v <= 32767.0),
        v == np.rint(v)).all())


def resample_poly(x, sr_in, sr_out, num_zeros=16):
    """Windowed-sinc polyphase resampler (Kaiser-windowed), mono float32.

    Not a copy: the JAX package's resample_poly (same name, same module)
    zero-stuffs the input to `up` x its length and convolves it with the
    whole 2*num_zeros*max(up, down)+1-tap kernel. This computes the same
    output as a polyphase sum over the non-zero taps only: for each output
    sample, the input samples j whose j*up falls inside the kernel's support
    around it, in float64 with the same Kaiser kernel (beta 8.0, cutoff
    0.475 / max(up, down)), the same "same"-mode alignment and the same
    output grid (every `down`-th filtered sample). An empty input raises
    ValueError, as np.convolve does there."""
    if sr_in == sr_out:
        return x.astype(np.float32)
    from math import gcd
    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    # Lowpass at min(sr_in, sr_out)/2 with transition margin.
    cutoff = 0.475 / max(up, down)
    half = num_zeros * max(up, down)
    n = np.arange(-half, half + 1, dtype=np.float64)
    kernel = 2 * cutoff * np.sinc(2 * cutoff * n) * np.kaiser(len(n), 8.0)
    x64 = x.astype(np.float64) * up
    n_in = len(x64)
    if n_in == 0:
        raise ValueError("resample_poly: empty input")
    # np.convolve(ups, kernel, "same") over the zero-stuffed ups (length
    # n_in * up): out[i] = full[i + off], full[k] = sum_j x64[j] *
    # kernel[k - j * up] over 0 <= k - j * up <= 2 * half.
    n_ups, n_k = n_in * up, len(kernel)
    off = (min(n_ups, n_k) - 1) // 2
    n_out = -(-max(n_ups, n_k) // down)
    taps = 2 * half // up + 1
    out = np.empty(n_out, np.float64)
    block = max(1, (1 << 22) // taps)  # outputs a block: bounded memory
    for q0 in range(0, n_out, block):
        k = np.arange(q0, min(q0 + block, n_out), dtype=np.int64) * down + off
        j = -(-(k - 2 * half) // up)[:, None] + np.arange(taps)  # first tap on
        d = k[:, None] - j * up
        ok = (j >= 0) & (j < n_in) & (d >= 0) & (d <= 2 * half)
        out[q0: q0 + len(k)] = np.where(
            ok, x64[np.clip(j, 0, n_in - 1)] * kernel[np.clip(d, 0, 2 * half)],
            0.0).sum(axis=1)
    return out.astype(np.float32)


def find_ffmpeg():
    return shutil.which("ffmpeg")


def load_audio_ffmpeg(path, sample_rate=SAMPLE_RATE):
    """Decode any container via ffmpeg pipe -> mono float32 at sample_rate.
    Uses the soxr resampler like the reference (core/audio_decode.py:20)."""
    ffmpeg = find_ffmpeg()
    if ffmpeg is None:
        raise FileNotFoundError("ffmpeg not found")
    cmd = [ffmpeg, "-v", "error", "-i", path,
           "-af", "aresample=resampler=soxr:precision=20",
           "-f", "f32le", "-acodec", "pcm_f32le",
           "-ac", "1", "-ar", str(sample_rate), "pipe:1"]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except subprocess.CalledProcessError:
        # Fallback without soxr (some builds lack it).
        cmd = [ffmpeg, "-v", "error", "-i", path, "-f", "f32le",
               "-acodec", "pcm_f32le", "-ac", "1", "-ar", str(sample_rate),
               "pipe:1"]
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, np.float32).copy()


def load_audio(path, sample_rate=SAMPLE_RATE, progress_callback=None):
    """Load any audio file to mono float32 at sample_rate, peak-boosted.

    Strategy (reference core/asr_engine.py:467-518): WAV reads directly
    (downmix + resample as needed); other formats require ffmpeg. Quiet audio
    (peak < 0.5) is peak-normalized to 0.95.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        # Prefer the native decoder/resampler (native/audiokit.cpp); fall
        # back to the pure-python implementations below.
        audio = rate = None
        try:
            from sherpa_vietnamese_asr_tpu_torch.utils.native import (
                resample_native, wav_decode_native,
            )
            decoded = wav_decode_native(path)
            if decoded is not None:
                audio, rate = decoded
                if rate != sample_rate:
                    if progress_callback:
                        progress_callback("PHASE:LoadAudio|Resampling|10")
                    audio = resample_native(audio, rate, sample_rate)
        except Exception:
            audio = None
        if audio is None:
            x, rate = read_wav(path)
            audio = x.mean(axis=1) if x.shape[1] > 1 else x[:, 0]
            if rate != sample_rate:
                if progress_callback:
                    progress_callback("PHASE:LoadAudio|Resampling|10")
                audio = resample_poly(audio, rate, sample_rate)
    else:
        if progress_callback:
            progress_callback("PHASE:LoadAudio|Decoding (ffmpeg)|5")
        audio = load_audio_ffmpeg(path, sample_rate)

    audio = np.ascontiguousarray(audio, np.float32)
    peak = float(np.max(np.abs(audio))) if audio.size else 0.0
    if 0.0 < peak < 0.5:
        audio = audio / peak * 0.95
    return audio
