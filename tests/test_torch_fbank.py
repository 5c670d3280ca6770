# The port's fbank (sherpa_vietnamese_asr_tpu_torch/ops/fbank.py) against the
# JAX package's fbank (XLA path and the Pallas kernel in interpret mode) and
# the numpy Kaldi oracle, on the CPU. On CPU tensors the kernel wrapper runs
# its plain twin; the CUDA kernel itself is checked by chip_smoke.py.
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


def test_build_without_nvcc_names_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_lib, "library_path",
                        lambda: tmp_path / "libsvt_kernels_missing.so")
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib, "TOOLKIT_NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_lib.build()
