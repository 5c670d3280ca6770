# The golden test signal of sherpa_vietnamese_asr_tpu/models/golden.py,
# copied (formula, no RNG) so that this package can make it without JAX.

from __future__ import annotations

import numpy as np

GOLDEN_SR = 16000
GOLDEN_DURATION_SEC = 6.0


def golden_audio(duration_sec: float = GOLDEN_DURATION_SEC,
                 sr: int = GOLDEN_SR) -> np.ndarray:
    """Deterministic speech-band test signal: three AM voiced 'syllable'
    bands with a pitch glide and a quiet gap."""
    n = int(duration_sec * sr)
    t = np.arange(n, dtype=np.float64) / sr
    x = np.zeros(n, np.float64)
    for (a, b, f0, am) in ((0.2, 2.1, 220.0, 3.0),
                           (2.5, 4.2, 340.0, 2.2),
                           (4.5, 5.8, 180.0, 4.0)):
        seg = (t >= a) & (t < b)
        ts = t[seg] - a
        glide = f0 * (1.0 + 0.12 * np.sin(2 * np.pi * 0.5 * ts))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * am * ts)
        x[seg] += (0.28 * np.sin(2 * np.pi * glide * ts) * env
                   + 0.1 * np.sin(2 * np.pi * 2.0 * glide * ts) * env)
    return x.astype(np.float32)
