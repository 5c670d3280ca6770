# Silero-VAD-style model in PyTorch: per-512-sample-window speech
# probabilities.
#
# Port of sherpa_vietnamese_asr_tpu/models/silero_vad.py, with the same
# semantics: 576-sample windows (64 samples of context from the previous
# window, zeros for the first) -> STFT magnitude as two products with the
# cos and sin bases, sqrt(re^2 + im^2 + 1e-9) -> four k=3 same-padded convs
# with ReLU -> mean over frames -> LSTM (gate order i, f, g, o, one bias) ->
# sigmoid head. The reference has no Pallas kernel here (an XLA conv and a
# lax.scan), so the port runs library calls: each block's features in one
# batched pass, the recurrence as one torch.nn.LSTM call a block (its
# second bias held at zero).
#
# On CUDA every product, convolution and the cuDNN LSTM run in full float32:
# the module turns TF32 off when it is placed on a card (the float32 tier's
# policy, models.zipformer.use_full_fp32) and refuses to run if either flag
# is back on, because thresholded probabilities turn a TF32 rounding into
# moved segment edges.

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
from sherpa_vietnamese_asr_tpu_torch.models.zipformer import (
    _check_full_fp32,
    use_full_fp32,
)

WINDOW = 512
CONTEXT = 64
STATE_DIM = 128
IN_FLIGHT = 3  # blocks enqueued on the card ahead of the host


@dataclasses.dataclass(frozen=True)
class SileroVadConfig:
    window: int = WINDOW
    context: int = CONTEXT
    stft_filter_len: int = 256
    stft_hop: int = 128
    n_freq: int = 129
    encoder_channels: tuple = (128, 64, 64, 128)
    lstm_dim: int = STATE_DIM


class SileroVad(nn.Module):
    """Parameters in torch layout: stft_cos/stft_sin [n_freq, filter_len],
    encoder.{i} Conv1d [C_out, C_in, 3], lstm an nn.LSTM (bias_hh_l0 zero),
    head Linear(lstm_dim, 1)."""

    def __init__(self, cfg: SileroVadConfig = SileroVadConfig(), device=None):
        super().__init__()
        self.cfg = cfg
        shape = (cfg.n_freq, cfg.stft_filter_len)
        self.stft_cos = nn.Parameter(torch.empty(shape, device=device))
        self.stft_sin = nn.Parameter(torch.empty(shape, device=device))
        chans = (cfg.n_freq,) + tuple(cfg.encoder_channels)
        self.encoder = nn.ModuleList(
            nn.Conv1d(c_in, c_out, 3, padding=1, device=device)
            for c_in, c_out in zip(chans[:-1], chans[1:]))
        self.lstm = nn.LSTM(chans[-1], cfg.lstm_dim, batch_first=True,
                            device=device)
        self.head = nn.Linear(cfg.lstm_dim, 1, device=device)

    @property
    def device(self) -> torch.device:
        return self.stft_cos.device

    def to(self, *args, **kwargs) -> "SileroVad":
        super().to(*args, **kwargs)
        if self.device.type == "cuda":
            use_full_fp32()
            self.lstm.flatten_parameters()
        return self.eval()


def random_silero_vad(cfg: SileroVadConfig = SileroVadConfig(), seed: int = 0,
                      device="cuda",
                      generator: torch.Generator | None = None) -> SileroVad:
    """Random weights with the reference's init scheme: a fixed DFT basis,
    conv weights N(0, 1/(3 C_in)), LSTM input and recurrent weights N(0,
    1/fan_in), head N(0, 1/H), biases zero. Values come from `generator`, or
    from a CPU generator seeded with `seed`."""
    device = model_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    vad = SileroVad(cfg)
    k = np.arange(cfg.stft_filter_len)[None, :]
    f = np.arange(cfg.n_freq)[:, None]
    ang = -2.0 * np.pi * f * k / cfg.stft_filter_len

    def normal(p, fan_in):
        p.normal_(generator=generator).mul_(1.0 / math.sqrt(fan_in))

    with torch.no_grad():
        vad.stft_cos.copy_(torch.from_numpy(np.cos(ang)))
        vad.stft_sin.copy_(torch.from_numpy(np.sin(ang)))
        for conv in vad.encoder:
            normal(conv.weight, 3 * conv.in_channels)
            conv.bias.zero_()
        d = cfg.lstm_dim
        normal(vad.lstm.weight_ih_l0, vad.lstm.input_size)
        normal(vad.lstm.weight_hh_l0, d)
        vad.lstm.bias_ih_l0.zero_()
        vad.lstm.bias_hh_l0.zero_()
        normal(vad.head.weight, d)
        vad.head.bias.zero_()
    return vad.to(device)


def window_features(vad: SileroVad, windows: torch.Tensor) -> torch.Tensor:
    """Conv front-end for a batch of windows.

    windows: [N, context + window] float32 (64 left-context + 512 samples).
    Returns [N, C] features, parallel over windows.
    """
    cfg = vad.cfg
    # STFT magnitude: frames of filter_len, hop stft_hop -> [N, T, F]
    frames = windows.unfold(1, cfg.stft_filter_len, cfg.stft_hop)
    re = frames @ vad.stft_cos.t()
    im = frames @ vad.stft_sin.t()
    h = torch.sqrt(re * re + im * im + 1e-9).transpose(1, 2)  # [N, F, T]
    # Conv encoder over the (short) frame axis, k=3 same-pad + ReLU.
    for conv in vad.encoder:
        h = torch.relu(conv(h))
    return h.mean(dim=2)


def lstm_scan(vad: SileroVad, feats: torch.Tensor, state=None):
    """Sequential LSTM over window features, one library call.

    feats: [N, C] in window order. state: optional (h, c) each [D].
    Returns (probs [N], (h, c)).
    """
    d = vad.cfg.lstm_dim
    if state is None:
        zeros = feats.new_zeros(d)
        state = (zeros, zeros)
    h0, c0 = (s.reshape(1, 1, d) for s in state)
    hs, (h, c) = vad.lstm(feats[None], (h0, c0))
    logits = vad.head(hs[0])[:, 0]
    return torch.sigmoid(logits), (h.reshape(d), c.reshape(d))


def _check_device(vad: SileroVad):
    if vad.device.type == "cuda":
        _check_full_fp32()


def vad_step(vad: SileroVad, chunk, context, state):
    """Single streaming step: one 512-sample window with carried state
    (input = context(64) + chunk(512)). Returns (prob, new_context,
    new_state)."""
    _check_device(vad)
    with torch.no_grad():
        full = torch.cat([context, chunk])[None, :]
        probs, new_state = lstm_scan(vad, window_features(vad, full), state)
    return probs[0], chunk[-vad.cfg.context:], new_state


def silero_vad_probs(vad: SileroVad, audio: torch.Tensor) -> torch.Tensor:
    """Per-window speech probabilities for a whole waveform in one pass.

    audio: [L] float32 on the model's device. Returns [L // 512] float32:
    window i uses the previous window's last 64 samples as context, zeros
    for i = 0.
    """
    cfg = vad.cfg
    _check_device(vad)
    n_windows = audio.shape[0] // cfg.window
    wins = audio[: n_windows * cfg.window].reshape(n_windows, cfg.window)
    ctx = torch.cat([wins.new_zeros(1, cfg.context),
                     wins[:-1, -cfg.context:]], dim=0)
    with torch.no_grad():
        probs, _ = lstm_scan(vad, window_features(
            vad, torch.cat([ctx, wins], dim=1)))
    return probs


def silero_vad_probs_streamed(vad: SileroVad, audio, block_windows: int = 1875,
                              quantize: bool = True) -> torch.Tensor:
    """Whole-file VAD in fixed-size blocks with the LSTM state carried
    across blocks; equals silero_vad_probs on the same (quantised) samples.

    audio: numpy [L] float32. With quantize (what the transcriber runs) the
    audio is rounded to int16 on the host first and divided by 32768 on the
    device, as the reference uploads it. The last block is zero-padded;
    each block takes its first window's context from the previous block's
    last 64 samples (zeros for the first). The whole file is uploaded once;
    at most IN_FLIGHT blocks are enqueued ahead of the host. Returns a
    [L // 512] float32 tensor on the model's device.
    """
    cfg = vad.cfg
    _check_device(vad)
    dev = vad.device
    audio = np.asarray(audio, np.float32)
    n_windows = len(audio) // cfg.window
    if n_windows == 0:
        return torch.empty((0,), dtype=torch.float32, device=dev)
    if quantize:
        host = np.clip(np.rint(audio * 32768.0), -32768, 32767
                       ).astype(np.int16)
    else:
        host = audio
    block_len = block_windows * cfg.window
    n_blocks = -(-n_windows // block_windows)
    padded = np.zeros((n_blocks * block_len,), host.dtype)
    take = min(len(host), len(padded))
    padded[:take] = host[:take]
    samples = torch.from_numpy(padded).to(dev)
    out = torch.empty((n_windows,), dtype=torch.float32, device=dev)
    state = None
    tail = torch.zeros((cfg.context,), dtype=torch.float32, device=dev)
    pending = []
    with torch.no_grad():
        for b in range(n_blocks):
            x = samples[b * block_len: (b + 1) * block_len].to(torch.float32)
            if quantize:
                x = x / 32768.0
            wins = x.reshape(block_windows, cfg.window)
            ctx = torch.cat([tail[None, :], wins[:-1, -cfg.context:]], dim=0)
            feats = window_features(vad, torch.cat([ctx, wins], dim=1))
            probs, state = lstm_scan(vad, feats, state)
            start = b * block_windows
            n = min(block_windows, n_windows - start)
            out[start: start + n] = probs[:n]
            tail = wins[-1, -cfg.context:]
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record()
                pending.append(event)
                if len(pending) > IN_FLIGHT:
                    pending.pop(0).synchronize()
    return out
