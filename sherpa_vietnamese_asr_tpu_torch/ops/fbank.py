# Kaldi log-mel fbank in PyTorch: framing as plain tensor ops, then one
# hand-written CUDA kernel (csrc/fbank_logmel.cu) for
# real FFT -> power spectrum -> mel -> log.
#
# Port of sherpa_vietnamese_asr_tpu/ops/fbank.py. The plain twin keeps the
# JAX package's formulation, the 512-point real DFT as two products against
# constant cos/sin bases over the 257 real bins. The kernel computes the same
# spectrum with a real FFT in shared memory instead; its constants (the
# twiddle table and the mel bank in compact form) are made here on the host.
# logmel() is the kernel's wrapper: for a CPU tensor it runs the plain twin
# _logmel_plain, for a CUDA tensor it launches the kernel (or raises).
#
# Numeric oracle: sherpa_vietnamese_asr_tpu_torch.utils.fbank_ref.compute_fbank.

from __future__ import annotations

import functools

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib
from sherpa_vietnamese_asr_tpu_torch.utils.fbank_ref import (
    ASR_FBANK,
    CAMPP_FBANK,
    RESNET_EMB_FBANK,
    FbankConfig,
    feature_window,
    kaldi_mel_banks,
    num_frames,
)

__all__ = [
    "ASR_FBANK",
    "CAMPP_FBANK",
    "RESNET_EMB_FBANK",
    "FbankConfig",
    "check_kernel_args",
    "compact_mel",
    "compute_fbank",
    "logmel",
    "num_frames",
    "twiddle_table",
]

# Kernel launches of logmel() on CUDA tensors (never counts the plain twin).
launches = 0


@functools.lru_cache(maxsize=8)
def _constants_np(cfg: FbankConfig):
    """Window [frame_length], DFT bases [n_fft, n_spec], mel bank [n_spec, num_bins]."""
    n_fft = cfg.n_fft
    n_spec = n_fft // 2 + 1
    k = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_spec, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * k * f / n_fft
    wc = np.cos(ang).astype(np.float32)
    ws = np.sin(ang).astype(np.float32)
    mel = np.ascontiguousarray(kaldi_mel_banks(cfg).T)  # [n_spec, num_bins]
    return feature_window(cfg), wc, ws, mel


@functools.lru_cache(maxsize=16)
def _constants(cfg: FbankConfig, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _constants_np(cfg))


def twiddle_table(n_fft: int) -> np.ndarray:
    """[n_fft, 2] float32: (cos, -sin) of 2*pi*t/n_fft for t < n_fft, that is
    exp(-2*pi*i*t/n_fft), computed in float64 and rounded once. The kernel's
    FFT stages and its real-split step both index it."""
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)


def compact_mel(cfg: FbankConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Kaldi's mel bank as each filter's own bins: (first bin [num_bins] int32,
    offsets [num_bins + 1] int32, weights float32), filter b's weights being
    weights[offsets[b]:offsets[b + 1]] for the bins from first[b] on. The
    triangles are contiguous and never reach the Nyquist bin."""
    dense = kaldi_mel_banks(cfg)  # [num_bins, n_fft // 2 + 1]
    first = np.zeros(cfg.num_bins, np.int32)
    offsets = np.zeros(cfg.num_bins + 1, np.int32)
    rows = []
    for b, row in enumerate(dense):
        nz = np.flatnonzero(row)
        lo, hi = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        first[b] = lo
        rows.append(row[lo:hi])
        offsets[b + 1] = offsets[b] + hi - lo
    weights = np.concatenate(rows).astype(np.float32)
    assert int((first + np.diff(offsets)).max()) <= cfg.n_fft // 2
    return first, offsets, weights


@functools.lru_cache(maxsize=16)
def _kernel_constants(cfg: FbankConfig, device: torch.device):
    arrays = (twiddle_table(cfg.n_fft), *compact_mel(cfg))
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _frame_signal(audio: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """[..., L] -> [..., F, n_fft] windowed frames (zero-padded past frame_length).

    snip_edges=False frames are framed with Kaldi edge reflection; when the
    frame shift divides the left pad, framing is a reshape into shift-sized
    rows plus ceil(frame_length/shift) shifted row views (strided slices).
    """
    n = audio.shape[-1]
    f = num_frames(n, cfg)
    shift, wlen = cfg.frame_shift, cfg.frame_length
    start0 = 0 if cfg.snip_edges else shift // 2 - wlen // 2
    pad_left = max(0, -start0)
    if (pad_left + start0) % shift == 0 and n >= wlen:
        nrows = -(-wlen // shift)
        total = (f + nrows) * shift
        pieces = []
        if pad_left:
            # Kaldi edge reflection: sample at index -k-1 is audio[k]
            pieces.append(torch.flip(audio[..., :pad_left], dims=(-1,)))
        pieces.append(audio)
        pad_right = total - pad_left - n
        if pad_right > 0:
            k = min(pad_right, n)
            tail = torch.flip(audio[..., n - k:], dims=(-1,))
            if k < pad_right:  # beyond one reflection: never read
                tail = torch.nn.functional.pad(tail, (0, pad_right - k))
            pieces.append(tail)
        ap = torch.cat(pieces, dim=-1) if len(pieces) > 1 else audio
        r2d = ap.reshape(*audio.shape[:-1], f + nrows, shift)
        frames = torch.cat([r2d[..., i: i + f, :] for i in range(nrows)],
                           dim=-1)[..., :wlen]
    else:
        starts = torch.arange(f, device=audio.device) * shift + start0
        idx = starts[:, None] + torch.arange(wlen, device=audio.device)
        # Kaldi reflection; one step suffices for frame_length << n.
        idx = torch.where(idx < 0, -idx - 1, idx)
        idx = torch.where(idx >= n, 2 * n - 1 - idx, idx)
        frames = audio[..., idx]  # [..., F, frame_length]
    if cfg.input_scale != 1.0:
        frames = frames * cfg.input_scale
    if cfg.remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if cfg.preemph != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemph * prev
    win = _constants(cfg, audio.device)[0]
    frames = frames * win
    pad = cfg.n_fft - cfg.frame_length
    if pad > 0:
        frames = torch.nn.functional.pad(frames, (0, pad))
    return frames


def _logmel_plain(frames: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    """Plain twin of the kernel: [F, n_fft] -> [F, num_bins], full fp32."""
    _, wc, ws, mel = _constants(cfg, frames.device)
    c = frames @ wc
    s = frames @ ws
    power = c * c + s * s
    return torch.log(torch.clamp_min(power @ mel, cfg.log_floor))


def check_kernel_args(frames: torch.Tensor, cfg: FbankConfig) -> None:
    """Raise ValueError unless the kernel takes these frames and config:
    contiguous float32 [F, n_fft] with n_fft a power of two in [64, 1024]."""
    n_fft = cfg.n_fft
    if not (64 <= n_fft <= 1024 and n_fft & (n_fft - 1) == 0):
        raise ValueError("logmel kernel takes n_fft a power of two from 64 to "
                         f"1024, got {n_fft}")
    if frames.dtype != torch.float32 or frames.dim() != 2 \
            or frames.shape[1] != n_fft or not frames.is_contiguous():
        raise ValueError("logmel kernel takes contiguous float32 [F, n_fft] "
                         f"frames, got {frames.dtype} {tuple(frames.shape)}")


def _logmel_cuda(frames: torch.Tensor, cfg: FbankConfig) -> torch.Tensor:
    global launches
    check_kernel_args(frames, cfg)
    if frames.data_ptr() % 16:  # the kernel loads frames in 16-byte pieces
        frames = frames.clone()
    twiddle, first, offsets, weights = _kernel_constants(cfg, frames.device)
    n = frames.shape[0]
    out = torch.empty((n, cfg.num_bins), dtype=torch.float32,
                      device=frames.device)
    if n == 0:
        return out
    lib = cuda_lib.library()
    status = lib.svt_fbank_logmel(
        frames.data_ptr(), twiddle.data_ptr(), first.data_ptr(),
        offsets.data_ptr(), weights.data_ptr(), out.data_ptr(), n, cfg.n_fft,
        cfg.num_bins, weights.numel(), float(cfg.log_floor),
        cuda_lib.stream(frames.device))
    cuda_lib.check(status, "svt_fbank_logmel")
    launches += 1
    return out


def logmel(frames: torch.Tensor, cfg: FbankConfig = ASR_FBANK) -> torch.Tensor:
    """[F, n_fft] windowed frames -> [F, num_bins] log-mel.

    CPU tensors run the plain twin; CUDA tensors launch csrc/fbank_logmel.cu.
    """
    if frames.device.type == "cpu":
        return _logmel_plain(frames, cfg)
    if frames.device.type != "cuda":
        raise ValueError(f"logmel: unsupported device {frames.device}")
    return _logmel_cuda(frames, cfg)


def compute_fbank(audio: torch.Tensor,
                  cfg: FbankConfig = ASR_FBANK) -> torch.Tensor:
    """Kaldi log-mel fbank.

    Args:
        audio: [L] or [B, L] float32 waveform(s) at cfg.sample_rate.
        cfg: one of ASR_FBANK / RESNET_EMB_FBANK / CAMPP_FBANK or custom.

    Returns:
        [F, num_bins] or [B, F, num_bins] float32 log-mel features. CMVN (if
        cfg.cmvn) is per utterance over all F frames.
    """
    batched = audio.dim() == 2
    frames = _frame_signal(audio, cfg)  # [..., F, n_fft]
    flat = frames.reshape(-1, cfg.n_fft)
    feats = logmel(flat.contiguous(), cfg)
    if batched:
        feats = feats.reshape(audio.shape[0], -1, cfg.num_bins)
    if cfg.cmvn:
        feats = feats - feats.mean(dim=-2, keepdim=True)
    return feats
