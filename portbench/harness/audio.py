"""Audio content of the traffic mixes, made from the seed. Each kind is
a function (seconds, numpy Generator, **params) -> float32 samples at
16 kHz; a mix's "content_params" are its params."""

from __future__ import annotations

import functools
import struct

import numpy as np

RATE = 16000


def _tone(seconds, parts):
    """sum of a * sin(2 pi f t) * (0.5 + 0.5 sin(2 pi am t)) (am None: no
    modulation) over `seconds`, float64."""
    t = np.arange(int(RATE * seconds), dtype=np.float64) / RATE
    out = np.zeros_like(t)
    for a, f, am in parts:
        out += a * np.sin(2 * np.pi * f * t) * (1.0 if am is None else 0.5 + 0.5 * np.sin(2 * np.pi * am * t))
    return out


@functools.lru_cache(maxsize=1)
def _two_speaker_period():
    """The 60 s after which two_speakers' tones repeat (12 s of turns, AM
    periods dividing 10 s, carriers dividing 50 samples)."""
    t = np.arange(60 * RATE) / RATE
    turn = (t // 6).astype(np.int64)
    x = np.where(turn % 2 == 1, _tone(60, [(0.3, 320.0, 3.3)]), _tone(60, [(0.3, 180.0, 2.1)]))
    x[(t - 6 * turn) >= 5.0] = 0.0
    return x.astype(np.float32)


def two_speakers(seconds, rng):
    """Two alternating "speakers" in 6 s turns (5 s of AM tone at 180 Hz /
    2.1 Hz and 320 Hz / 3.3 Hz, then 1 s of gap), noise at 0.01; a last
    turn cut short by the end is silent."""
    n = int(RATE * seconds)
    x = np.resize(_two_speaker_period(), n)
    x[(int(seconds) // 6) * 6 * RATE:] = 0.0
    return x + np.float32(0.01) * rng.standard_normal(n, dtype=np.float32)


@functools.lru_cache(maxsize=1)
def _speechlike_period():
    return _tone(1, [(0.3, 220.0, 3.0), (0.15, 1200.0, None)]).astype(np.float32)


def speechlike(seconds, rng):
    """An AM tone at 220 Hz / 3 Hz, a 1200 Hz partial (both repeat every
    second) and noise at 0.05."""
    n = int(RATE * seconds)
    return np.resize(_speechlike_period(), n) + np.float32(0.05) * rng.standard_normal(n, dtype=np.float32)


@functools.lru_cache(maxsize=1)
def _speaker_periods():
    """10 s of each "speaker" of two_speakers, after which its tone repeats
    (carriers and AM rates whole cycles in 10 s)."""
    return (_tone(10, [(0.3, 180.0, 2.1)]).astype(np.float32),
            _tone(10, [(0.3, 320.0, 3.3)]).astype(np.float32))


def turn_lengths(seconds, turn_s, gap_s):
    """The turn lengths of a recording of `seconds`: evenly spaced over
    [turn_s[0], turn_s[1]], as many as fill it; the same set for every seed."""
    lo, hi = turn_s
    n = int(np.ceil(seconds / ((lo + hi) / 2 + gap_s))) + 1
    return np.linspace(lo, hi, n)


def two_speaker_turns(seconds, rng, turn_s=(5.0, 20.0), gap_s=1.0, noise=0.01):
    """Two alternating "speakers" (the AM tones of two_speakers) in turns
    whose lengths, the set of turn_lengths, come in an order drawn from rng,
    each followed by `gap_s` of silence; the last turn is cut by the end;
    noise at `noise` everywhere."""
    n = int(RATE * seconds)
    a, b = (np.resize(p, n) for p in _speaker_periods())
    x = np.zeros(n, np.float32)
    pos = 0
    for k, length in enumerate(rng.permutation(turn_lengths(seconds, turn_s, gap_s))):
        end = min(n, pos + int(round(RATE * length)))
        x[pos:end] = (a if k % 2 == 0 else b)[pos:end]
        pos = end + int(round(RATE * gap_s))
        if pos >= n:
            break
    return x + np.float32(noise) * rng.standard_normal(n, dtype=np.float32)


KINDS = {"two_speakers": two_speakers, "speechlike": speechlike, "two_speaker_turns": two_speaker_turns}


def write_wav(path, audio):
    """Mono float32 in [-1, 1] as 16-bit PCM."""
    pcm = np.round(np.clip(np.asarray(audio, np.float32) * 32767.0, -32768, 32767)).astype("<i2")
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, RATE, RATE * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)
