# The port's fbank (sherpa_vietnamese_asr_tpu_torch/ops/fbank.py) against the
# JAX package's fbank (XLA path and the Pallas kernel in interpret mode) and
# the numpy Kaldi oracle, on the CPU. On CPU tensors the kernel wrapper runs
# its plain twin; the CUDA kernel itself is checked by chip_smoke.py.
import dataclasses

import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu.ops import fbank as jfb
from sherpa_vietnamese_asr_tpu.utils import fbank_ref
from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib
from sherpa_vietnamese_asr_tpu_torch.ops import fbank as tfb

torch.set_num_threads(2)

CONFIGS = [tfb.ASR_FBANK, tfb.RESNET_EMB_FBANK, tfb.CAMPP_FBANK]


def _speechlike(rng, n, sr=16000):
    t = np.arange(n) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
         + 0.15 * np.sin(2 * np.pi * 1200 * t)
         + 0.05 * rng.standard_normal(n))
    return x.astype(np.float32)


def _port(audio, cfg):
    return tfb.compute_fbank(torch.from_numpy(audio), cfg).numpy()


@pytest.mark.parametrize("cfg", CONFIGS, ids=["asr", "resnet", "campp"])
def test_port_matches_jax_xla_fbank(cfg):
    """Same float32 matmul-DFT formulation: agreement to 1e-3."""
    audio = _speechlike(np.random.default_rng(1), 16000 * 2 + 133)
    ref = np.asarray(jfb.compute_fbank(audio, cfg, use_pallas=False))
    got = _port(audio, cfg)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 1e-3


def test_port_matches_jax_pallas_interpret():
    """The TPU kernel's 3-pass bf16 DFT differs by up to ~1e-2: 2e-2 gate."""
    from jax.experimental.pallas import tpu as pltpu

    audio = _speechlike(np.random.default_rng(2), 16000)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfb.compute_fbank(audio, tfb.ASR_FBANK,
                                           use_pallas=True))
    assert np.max(np.abs(_port(audio, tfb.ASR_FBANK) - ref)) < 2e-2


@pytest.mark.parametrize("cfg", CONFIGS, ids=["asr", "resnet", "campp"])
def test_port_matches_kaldi_oracle(cfg):
    audio = _speechlike(np.random.default_rng(3), 16000 * 2 + 7)
    ref = fbank_ref.compute_fbank(audio, cfg)
    got = _port(audio, cfg)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) < 2e-2
    num = (got * ref).sum(-1)
    den = np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1) + 1e-9
    assert np.min(num / den) > 0.9999


@pytest.mark.parametrize("n", [399, 511, 1600, 16080])
def test_frame_count_and_short_inputs(n):
    """Both framing branches (strided slices and the reflect gather used
    when the signal is shorter than a frame) match the JAX package."""
    audio = _speechlike(np.random.default_rng(n), n)
    ref = np.asarray(jfb.compute_fbank(audio, tfb.ASR_FBANK, use_pallas=False))
    got = _port(audio, tfb.ASR_FBANK)
    assert got.shape == ref.shape == ((n + 80) // 160, 80)
    assert np.max(np.abs(got - ref)) < 1e-3


def test_batched_matches_single():
    rng = np.random.default_rng(4)
    batch = np.stack([_speechlike(rng, 16000) for _ in range(3)])
    got = _port(batch, tfb.ASR_FBANK)
    for i in range(3):
        np.testing.assert_allclose(got[i], _port(batch[i], tfb.ASR_FBANK),
                                   rtol=0, atol=1e-4)


def test_cpu_tensor_runs_plain_twin_without_launch(monkeypatch):
    """On a CPU tensor the wrapper never touches the kernel library."""
    def no_library():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    tfb.launches = 0
    frames = torch.from_numpy(
        np.random.default_rng(5).standard_normal((7, 512)).astype(np.float32))
    out = tfb.logmel(frames, tfb.ASR_FBANK)
    assert out.shape == (7, 80) and tfb.launches == 0
    torch.testing.assert_close(out, tfb._logmel_plain(frames, tfb.ASR_FBANK))


def _kernel_model(frames, cfg):
    """float32 numpy model of csrc/fbank_logmel.cu, step for step: the n_fft
    reals as n_fft/2 complex points, the Stockham stages (radix 4, then one
    radix 2 when log2(n_fft/2) is odd) indexing the same twiddle table, the
    real split to bins 0 .. n_fft/2 - 1, and the compact mel bank."""
    n = cfg.n_fft
    m, lfft = n // 2, n.bit_length() - 1
    lm = lfft - 1
    tw = tfb.twiddle_table(n)
    w = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    src = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)
    lns = 0
    while lns < lm:
        lr = 2 if lm - lns >= 2 else 1
        ns, per = 1 << lns, m >> lr
        j = np.arange(per)
        k = j & (ns - 1)
        t = k << (lfft - lns - lr)
        v = [src[:, j]] + [src[:, j + r * per] * w[r * t] for r in range(1, 1 << lr)]
        if lr == 2:
            a0, a1 = v[0] + v[2], v[0] - v[2]
            a2, a3 = v[1] + v[3], (v[1] - v[3]) * np.complex64(-1j)
            y = [a0 + a2, a1 + a3, a0 - a2, a1 - a3]
        else:
            y = [v[0] + v[1], v[0] - v[1]]
        dst = np.empty_like(src)
        for r, yr in enumerate(y):
            dst[:, ((j - k) << lr) + k + r * ns] = yr
        src, lns = dst, lns + lr
    k = np.arange(m)
    a, b = src[:, k], np.conj(src[:, (m - k) & (m - 1)])
    x = np.complex64(0.5) * (a + b) + w[k] * (np.complex64(-0.5j) * (a - b))
    power = (x.real * x.real + x.imag * x.imag).astype(np.float32)
    first, offsets, weights = tfb.compact_mel(cfg)
    mel = np.stack([power[:, f: f + hi - lo] @ weights[lo:hi]
                    for f, lo, hi in zip(first, offsets[:-1], offsets[1:])], axis=1)
    return np.log(np.maximum(mel, np.float32(cfg.log_floor)))


def _frames(audio, cfg):
    return tfb._frame_signal(torch.from_numpy(audio), cfg).reshape(-1, cfg.n_fft).contiguous()


def _errors(got, ref):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    return d.mean(), d.max()


@pytest.mark.parametrize("cfg", CONFIGS, ids=["asr", "resnet", "campp"])
def test_compact_mel_rebuilds_dense_bank(cfg):
    first, offsets, weights = tfb.compact_mel(cfg)
    dense = tfb.kaldi_mel_banks(cfg)
    rebuilt = np.zeros_like(dense)
    for b, (f, lo, hi) in enumerate(zip(first, offsets[:-1], offsets[1:])):
        rebuilt[b, f: f + hi - lo] = weights[lo:hi]
    np.testing.assert_array_equal(rebuilt, dense)
    lengths = np.diff(offsets)
    assert first.dtype == offsets.dtype == np.int32 and weights.dtype == np.float32
    assert lengths.max() <= 17 and (first + lengths).max() <= cfg.n_fft // 2


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024])
def test_twiddle_table_within_one_ulp(n_fft):
    tw = tfb.twiddle_table(n_fft)
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    ref = np.stack([np.cos(ang), -np.sin(ang)], axis=-1)
    assert tw.shape == (n_fft, 2) and tw.dtype == np.float32
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(tw - ref) <= ulp)


@pytest.mark.parametrize("n_fft", [64, 128, 256, 512, 1024])
def test_kernel_fft_schedule_matches_float64_rfft(n_fft):
    """Both radix patterns (all radix 4, radix 4 then 2): the power spectrum
    within 1e-6 of its peak, a few float32 roundings per stage."""
    cfg = tfb.FbankConfig(n_fft=n_fft, frame_length=n_fft, num_bins=16)
    frames = np.random.default_rng(n_fft).standard_normal((6, n_fft)).astype(np.float32)
    got = np.exp(_kernel_model(frames, cfg))
    spec = np.abs(np.fft.rfft(frames.astype(np.float64))) ** 2
    ref = spec @ tfb.kaldi_mel_banks(cfg).T.astype(np.float64)
    assert np.abs(got - ref).max() <= 1e-6 * ref.max()


@pytest.mark.parametrize("cfg", CONFIGS, ids=["asr", "resnet", "campp"])
def test_kernel_fft_schedule_matches_twin_and_oracle(cfg):
    """The kernel's schedule against the plain twin: mean |diff| within
    1e-5 (measured about 8e-7); the max (measured up to 6e-4) sits in the
    lowest-energy mel bins, where any float32 transform loses digits, so it
    is held to 2e-3. Against the float64 Kaldi oracle its mean |error| is
    no farther than the twin's, with the margin chip_smoke.py holds the
    kernel to (measured 0.96 of the twin's), and its max stays in the same
    float32 range (measured 0.4 to 6.8 times the twin's across seeds)."""
    import chip_smoke

    audio = _speechlike(np.random.default_rng(3), 16000 * 2 + 7)
    frames = _frames(audio, cfg)
    got = _kernel_model(frames.numpy(), cfg)
    twin = tfb._logmel_plain(frames, cfg).numpy()
    mean, mx = _errors(got, twin)
    assert mean <= 1e-5 and mx <= 2e-3
    oracle = fbank_ref.compute_fbank(audio, dataclasses.replace(cfg, cmvn=False))
    k_mean, k_max = _errors(got, oracle)
    t_mean, t_max = _errors(twin, oracle)
    assert k_mean <= chip_smoke.FBANK_ORACLE_MARGIN * t_mean
    assert k_max <= 2e-3 and t_max <= 2e-3


@pytest.mark.parametrize("cfg", CONFIGS, ids=["asr", "resnet", "campp"])
def test_chip_gate_passes_kernel_schedule_and_fails_planted_faults(cfg):
    """chip_smoke.py's fbank gate with the numpy model standing in for the
    kernel, on audio with all-zero frames: the model passes, each planted
    fault of the twin fails."""
    import chip_smoke

    audio = np.stack([_speechlike(np.random.default_rng(6 + i), 16000 * 3) for i in range(2)])
    audio[1, -16000:] = 0.0
    frames = _frames(audio, cfg)
    got = torch.from_numpy(_kernel_model(frames.numpy(), cfg))
    assert chip_smoke.fbank_gate(*chip_smoke.fbank_errors(got, tfb._logmel_plain(frames, cfg)))
    faults = chip_smoke.fbank_faults(tfb, cfg)
    assert len(faults) == 4
    for name, fault in faults.items():
        errs = chip_smoke.fbank_errors(got, fault(frames))
        assert not chip_smoke.fbank_gate(*errs), (name, errs)


@pytest.mark.parametrize("n_fft", [32, 400, 2048])
def test_kernel_args_reject_unsupported_n_fft(n_fft):
    cfg = dataclasses.replace(tfb.ASR_FBANK, n_fft=n_fft)
    with pytest.raises(ValueError, match="power of two"):
        tfb.check_kernel_args(torch.zeros((3, n_fft)), cfg)


def test_kernel_args_accept_powers_of_two_and_reject_bad_frames():
    for n_fft in (64, 128, 256, 512, 1024):
        cfg = dataclasses.replace(tfb.ASR_FBANK, n_fft=n_fft)
        tfb.check_kernel_args(torch.zeros((3, n_fft)), cfg)
    for frames in (torch.zeros((3, 400)), torch.zeros((3, 512), dtype=torch.float64),
                   torch.zeros((512, 3)).t(), torch.zeros((2, 3, 512))):
        with pytest.raises(ValueError, match="frames"):
            tfb.check_kernel_args(frames, tfb.ASR_FBANK)


def test_build_without_nvcc_names_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_lib, "library_path",
                        lambda: tmp_path / "libsvt_kernels_missing.so")
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib, "TOOLKIT_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lib.build()
