# The port's polyphase resample_poly (utils/audio_io.py) against the JAX
# package's resample_poly, which convolves the zero-stuffed signal with the
# whole Kaiser kernel: the same output length and samples within 1e-6 (on
# this host's numpy the two are bit-equal at every case below), at
# 44.1k / 32k / 22.05k / 8k / 48k -> 16k and 16k -> 8k, on 0.05-0.1 s
# random signals and on lengths 1 and `up`; an empty input raises in both.
from math import gcd

import numpy as np
import pytest

RATES = [(44100, 16000), (32000, 16000), (22050, 16000), (8000, 16000), (48000, 16000),
         (16000, 8000)]


def _pair():
    from threadpoolctl import threadpool_limits

    from sherpa_vietnamese_asr_tpu.utils.audio_io import resample_poly as jax_convolution

    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import resample_poly

    def jax_resample(*args):
        # np.convolve's dot products run on OpenBLAS threads; beside the
        # other test workers those threads contend and one call can take
        # minutes instead of a second. One thread keeps it to its own cost.
        with threadpool_limits(1):
            return jax_convolution(*args)

    return resample_poly, jax_resample


@pytest.mark.parametrize("sr_in,sr_out", RATES)
@pytest.mark.parametrize("length", ["1", "up", "0.05 s", "0.1 s"])
def test_resample_equals_jax(sr_in, sr_out, length):
    resample_poly, jax_resample = _pair()
    up = sr_out // gcd(sr_in, sr_out)
    n = {"1": 1, "up": up, "0.05 s": int(0.05 * sr_in), "0.1 s": int(0.1 * sr_in)}[length]
    x = np.random.default_rng(n + sr_in).standard_normal(n).astype(np.float32)
    got, ref = resample_poly(x, sr_in, sr_out), jax_resample(x, sr_in, sr_out)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_empty_input_raises_like_jax_and_equal_rates_pass_through():
    resample_poly, jax_resample = _pair()
    empty = np.zeros(0, np.float32)
    for fn in (resample_poly, jax_resample):
        with pytest.raises(ValueError):
            fn(empty, 44100, 16000)
    x = np.arange(5, dtype=np.float64)
    assert resample_poly(x, 16000, 16000).dtype == np.float32
    np.testing.assert_array_equal(resample_poly(x, 16000, 16000), jax_resample(x, 16000, 16000))
