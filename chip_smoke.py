#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card's name and power limit; TF32 off for fp32 products
     and cuDNN convolutions;
  2. build: compile the package's CUDA kernels (csrc/*.cu) from source;
  3. kernel parity: each kernel against its plain PyTorch twin on the card,
     at the shapes the transcription paths give it, with both median times
     (the fbank kernel at its three configs on a full and a ragged batch
     with all-zero frames, against the float64 Kaldi oracle too, where four
     planted faults of the twin must fail its gate, and at its other n_fft,
     with the kernel's device time and the whole fbank_batch's framing
     split; the whole-layer kernel at all six Zipformer-30M stack shapes
     with perturbed biases, norm and bypasses, where six planted faults of
     the twin must fail the same gate; the beam kernel with and without a
     hotword table, and at vocab 1999 with ties planted across its vocab
     slices; with --parent DIR, the beam kernel of the checkout in DIR timed
     against this one in turns);
  4. float32 slice: TranscriberPipeline(..., {"bypass_vad": True}).run() on
     three WAV files with a random-weight Zipformer-30M model (vocab 2000,
     beam 8, float32), checking the result contract and that every kernel of
     the path ran;
  5. bfloat16 slice: the same entry point with the bfloat16 Zipformer-30M
     (same weights) carrying a hotword table, on two files; the whole-layer
     kernel and the hotword beam must run, and the bf16 encoder output must
     agree with the float32 encoder's on one batch (cosine >= 0.99).
The line before the last is a JSON summary of the kernels, each with its
bound (the least time the card could take for the same work, from this
run's shapes and the card's published peaks); the last line is
{"ok": true, "device": {...}}.

    python3 chip_smoke.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SR = 16000
CHUNK_SAMPLES = 33 * SR
SLICE_BATCH = 8
ATTN_SHAPES = (  # (stack, T, H) of Zipformer-30M at a 33 s chunk
    (0, 1646, 4),
    (3, 206, 8),
)
BEAM_LENS_64 = [64, 33, 1, 64, 17, 50, 64, 8]
BEAM_LENS_823 = [823, 611, 1, 823, 402, 0, 823, 77]
BEAM_HW_LENS_64 = [64, 0, 33, 64, 1, 50, 64, 8]
LAYER_SHAPES = (  # (stack, t_ds) of Zipformer-30M at a 33 s chunk
    (0, 1646), (1, 823), (2, 412), (3, 206), (4, 412), (5, 823))
# Whole-layer kernel vs its twin, over valid rows (all rows of the lens-0
# chunk): mean and max |kernel - twin| as fractions of mean |twin|.
# Measured at all six shapes with perturbed biases, norm and bypasses
# (NVIDIA H100 80GB HBM3, 700 W): sound, mean 7.5e-4 to 1.0e-3 and max
# 1.50e-2 to 2.08e-2; the twin with a rel-pos term 1% off, mean 1.67e-3 to
# 2.13e-3 and max 2.3e-2 to 3.6e-2 (the other planted faults of
# layer_faults() read 5x higher or more). The mean gate sits between the
# two; the max gate only catches gross faults.
LAYER_GATE_MEAN, LAYER_GATE_MAX = 1.3e-3, 0.03
FBANK_RAGGED_F = 4001  # 500 tiles of 8 frames and one frame over
FBANK_OTHER_N_FFT = (64, 128, 256, 1024)  # the kernel's n_fft besides Kaldi's 512
# Fbank kernel vs twin, mean and max |kernel - twin| of the log-mel over all
# frames. Measured at the three configs, full and ragged batch (NVIDIA H100
# 80GB HBM3, 700 W): sound, mean 7.1e-7 to 7.8e-7 and max 3.6e-4 to 1.2e-3
# (the max sits in the lowest-energy mel bins, where any float32 transform
# loses digits); the twin on frames scaled by 1.001, mean 1.85e-3 to
# 1.96e-3 but max only 2.2e-3 to 2.9e-3, so the mean gate catches that
# fault; the other planted faults of fbank_faults() read max 9.7 or more.
FBANK_GATE_MEAN, FBANK_GATE_MAX = 1e-5, 2e-2
# Kernel vs the float64 Kaldi oracle: its mean |error| at most this multiple
# of the twin's. The max is printed, not gated: it sits in a few of the
# lowest-energy mel bins, and which float32 transform lands closer there
# varies from input to input (kernel/twin 0.43 to 1.47 on the card, up to
# 6.8 for a float32 model of the kernel on short inputs). Measured mean
# ratio 0.93 to 0.94.
FBANK_ORACLE_MARGIN = 1.1
COSINE_GATE = 0.99  # bf16 vs float32 encoder output, per chunk
BEAM_TIE_V = 1999  # vocab slices of 250 columns, the last one 249
# (token, bias) pairs of the boundary-tie joiner: zero weight rows, so each
# pair's logits tie exactly in every summation order; 249 | 250 is the first
# slice boundary, 1749 | 1750 the last. With the random weights about a
# third of the emitted tokens are tied ones, most with margin 0.
BEAM_TIES = ((249, 2.0), (250, 2.0), (1749, 1.5), (1750, 1.5))
# Published peaks of one H100 SXM (dense, at a 700 W limit): the floor of
# each kernel's time is max(bytes / PEAK_BYTES, operations / peak of their type).
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12  # outside the tensor cores
PEAK_BF16 = 989e12  # tensor cores


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps=7, warmup=2):
    """Median milliseconds of fn() on the card, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes, flops, peak):
    """{"bound_ms", "bound_by"}: the larger of the bytes' time at the memory
    rate and the operations' time at `peak`."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def speechlike(rng, n):
    t = np.arange(n) / SR
    x = (0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
         + 0.15 * np.sin(2 * np.pi * 1200 * t) + 0.05 * rng.standard_normal(n))
    return x.astype(np.float32)


# ---------------------------------------------------------------- phase 1-2

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    log(f"nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}")
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import use_full_fp32

    use_full_fp32()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log("tf32: matmul.allow_tf32=%s cudnn.allow_tf32=%s" % (
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
    return torch.device("cuda", 0)


def phase_build():
    from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib

    path, seconds, out = cuda_lib.build(ptxas_info=True)
    for line in out.splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")
    cuda_lib.library()
    log(f"PHASE build ok: {os.path.relpath(path, REPO)} in {seconds:.1f} s")


# ---------------------------------------------------------------- phase 3

def fbank_audio():
    """The fbank check's batch: 8 x 33 s of speech-like audio with 3 s of
    zeros at the end of chunk 1 and 2 s at the start of chunk 5 (all-zero
    frames, where only the log floor decides the output)."""
    rng = np.random.default_rng(0)
    audio = np.stack([speechlike(rng, CHUNK_SAMPLES) for _ in range(SLICE_BATCH)])
    audio[1, -3 * SR:] = 0.0
    audio[5, : 2 * SR] = 0.0
    return audio


def fbank_oracle(audio, cfg):
    """The float64-FFT Kaldi oracle of every chunk, stacked like the flat
    frames, without CMVN (the kernel's output is the log-mel before it)."""
    from sherpa_vietnamese_asr_tpu_torch.utils import fbank_ref

    cfg = dataclasses.replace(cfg, cmvn=False)
    return np.concatenate([fbank_ref.compute_fbank(a, cfg) for a in audio])


def fbank_errors(got, ref):
    """(mean, max) |got - ref| of two log-mel tensors."""
    d = (got - ref).abs()
    return float(d.mean()), float(d.max())


def fbank_gate(mean, mx):
    return mean <= FBANK_GATE_MEAN and mx <= FBANK_GATE_MAX


def fbank_faults(fbank, cfg):
    """Planted faults of the twin: name -> fn(frames) -> log-mel. Each must
    fail fbank_gate against the kernel."""
    import torch

    def parts(frames):
        _, wc, ws, mel = fbank._constants(cfg, frames.device)
        return frames @ wc, frames @ ws, mel

    def log_mel(power, mel):
        return torch.log(torch.clamp_min(power @ mel, cfg.log_floor))

    def mel_shifted(frames):
        c, s, mel = parts(frames)
        return log_mel(c * c + s * s, torch.roll(mel, 1, dims=0))

    def real_only(frames):
        c, _, mel = parts(frames)
        return log_mel(c * c, mel)

    def floor_ignored(frames):
        c, s, mel = parts(frames)
        return torch.log((c * c + s * s) @ mel)

    return {"mel_bank_shifted_one_bin": mel_shifted,
            "power_real_part_only": real_only,
            "log_floor_ignored": floor_ignored,
            "frames_scaled_1.001": lambda frames: fbank._logmel_plain(frames * 1.001, cfg)}


def check_fbank(dev):
    """The fbank kernel against its twin at the three configs, on frames made
    on the card from fbank_audio(), at the full batch and at a ragged frame
    count: inside fbank_gate, every planted fault of fbank_faults() outside
    it, and on average no farther from the float64 oracle than the twin
    (FBANK_ORACLE_MARGIN). Then the ASR config's times: kernel and twin
    (CUDA events around the wrapper, and device time from torch.profiler),
    and the whole fbank_batch with its framing. Last, the kernel's other
    n_fft against the twin, inside the same gate."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import fbank_batch
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import profile_calls

    audio = fbank_audio()
    audio_dev = torch.from_numpy(audio).to(dev)
    failures, summary = [], None
    for label, cfg in (("asr", fbank.ASR_FBANK), ("resnet", fbank.RESNET_EMB_FBANK),
                       ("campp", fbank.CAMPP_FBANK)):
        frames = fbank._frame_signal(audio_dev, cfg).reshape(-1, cfg.n_fft).contiguous()
        oracle = torch.from_numpy(fbank_oracle(audio, cfg))
        assert oracle.shape[0] == frames.shape[0], "oracle frame count"
        # The whole batch, and a ragged count from chunk 1 on (its zeros included).
        chunk = frames.shape[0] // SLICE_BATCH
        for lo, hi in ((0, frames.shape[0]), (chunk, chunk + FBANK_RAGGED_F)):
            fr, n = frames[lo:hi], hi - lo
            got = fbank.logmel(fr, cfg)
            ref = fbank._logmel_plain(fr, cfg)
            mean, mx = fbank_errors(got, ref)
            faults = {name: fbank_errors(got, fault(fr))
                      for name, fault in fbank_faults(fbank, cfg).items()}
            o_mean, o_max = fbank_errors(got.cpu(), oracle[lo:hi])
            t_mean, t_max = fbank_errors(ref.cpu(), oracle[lo:hi])
            finite = bool(torch.isfinite(got).all())
            zero = int((fr.abs().amax(dim=1) == 0).sum())
            log(f"fbank {label}: F {n} ({zero} all-zero frames) vs twin mean "
                f"{mean:.3e} max {mx:.3e}; vs float64 oracle: kernel mean {o_mean:.3e} max "
                f"{o_max:.3e}, twin mean {t_mean:.3e} max {t_max:.3e}")
            log(f"fbank {label}: F {n} planted faults (mean, max): " + ", ".join(
                f"{name} ({f_mean:.3e}, {f_max:.3e})"
                for name, (f_mean, f_max) in faults.items()))
            if not (finite and got.shape == ref.shape and fbank_gate(mean, mx)):
                failures.append(f"{label} F {n}: kernel vs twin outside the gate")
            failures += [f"{label} F {n}: planted fault {name} passes the gate"
                         for name, errs in faults.items() if fbank_gate(*errs)]
            if not o_mean <= FBANK_ORACLE_MARGIN * t_mean:
                failures.append(f"{label} F {n}: kernel farther from the oracle than the twin")
            if summary is None:
                summary = {"max_abs_err": mx}
            del got, ref
        if label != "asr":
            continue
        ms = time_ms(lambda: fbank.logmel(frames, cfg))
        plain_ms = time_ms(lambda: fbank._logmel_plain(frames, cfg))
        _, kernel_dev = profile_calls(lambda: fbank.logmel(frames, cfg))
        plain_busy, _ = profile_calls(lambda: fbank._logmel_plain(frames, cfg))
        kernel_dev_ms = sum(v for k, v in kernel_dev.items() if "logmel_kernel" in k)
        batch_ms = time_ms(lambda: fbank_batch(audio_dev))
        framing_ms = time_ms(
            lambda: fbank._frame_signal(audio_dev, cfg).reshape(-1, cfg.n_fft).contiguous())
        batch_busy, batch_dev = profile_calls(lambda: fbank_batch(audio_dev))
        batch_kernel = sum(v for k, v in batch_dev.items() if "logmel_kernel" in k)
        log(f"fbank asr: F {frames.shape[0]} kernel {ms:.3f} ms (device {kernel_dev_ms:.4f} ms) "
            f"plain {plain_ms:.3f} ms (device {plain_busy:.4f} ms)")
        log(f"fbank_batch [{SLICE_BATCH}, {CHUNK_SAMPLES}]: {batch_ms:.3f} ms, framing alone "
            f"{framing_ms:.3f} ms; device busy {batch_busy:.4f} ms, of it the kernel "
            f"{batch_kernel:.4f} ms and framing {batch_busy - batch_kernel:.4f} ms; "
            f"device kernels " + ", ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(
                batch_dev.items(), key=lambda kv: -kv[1])))
        # Each frame read once, each log-mel written once, the tables once;
        # operations of a radix-2 FFT of the n_fft/2 complex points
        # (5 h log2 h), the real split and power (17 a bin), the compact mel
        # weights (2 each) and a log per output.
        tables = fbank._kernel_constants(cfg, dev)
        h = cfg.n_fft // 2
        flops = frames.shape[0] * (5 * h * np.log2(h) + 17 * h + 2 * tables[3].numel()
                                   + cfg.num_bins)
        summary.update(ms=ms, plain_ms=plain_ms, library_ms=None, **bound(
            nbytes(frames, *tables) + frames.shape[0] * cfg.num_bins * 4, flops, PEAK_FP32))
    for n_fft in FBANK_OTHER_N_FFT:  # the kernel's other instantiations, on two chunks
        cfg = dataclasses.replace(fbank.ASR_FBANK, n_fft=n_fft, frame_length=min(400, n_fft))
        fr = fbank._frame_signal(audio_dev[:2], cfg).reshape(-1, n_fft).contiguous()
        mean, mx = fbank_errors(fbank.logmel(fr, cfg), fbank._logmel_plain(fr, cfg))
        log(f"fbank n_fft {n_fft}: F {fr.shape[0]} vs twin mean {mean:.3e} max {mx:.3e}")
        if not fbank_gate(mean, mx):
            failures.append(f"n_fft {n_fft}: kernel vs twin outside the gate")
    assert not failures, "fbank parity: " + "; ".join(failures)
    return {"name": "fbank_logmel", "source": "sherpa_vietnamese_asr_tpu_torch/csrc/fbank_logmel.cu",
            "replaces": "sherpa_vietnamese_asr_tpu/ops/fbank.py:149", **summary}


def check_attention(dev, model):
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import compact_rel_pos_emb
    from sherpa_vietnamese_asr_tpu_torch.ops import attention

    out = None
    gen = torch.Generator(device="cpu").manual_seed(1)
    for stack, t, h in ATTN_SHAPES:
        layer = model.encoder.stacks[stack].layers[0]
        cfg = model.zip_cfg
        d = cfg.encoder_dim[stack]
        x = torch.randn((SLICE_BATCH, t, d), generator=gen).to(dev)
        lens_list = [t, t // 2, 0, 64, 1, (3 * t) // 4, t, 17]
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        qd, pd = cfg.query_head_dim, cfg.pos_head_dim
        with torch.no_grad():
            proj = layer.attn_in_proj(x)
        q = proj[..., : h * qd].reshape(SLICE_BATCH, t, h, qd)
        k = proj[..., h * qd: 2 * h * qd].reshape(SLICE_BATCH, t, h, qd)
        pq = proj[..., 2 * h * qd:].reshape(SLICE_BATCH, t, h, pd)
        wpos = layer.attn_pos_proj.weight.detach().t()
        pos = torch.from_numpy(compact_rel_pos_emb(t, cfg.pos_dim)).to(dev)
        args = (q, k, pq, wpos, pos, lens)
        got = attention.attention_weights(*args).float()
        ref = attention.attention_weights_plain(*args)
        torch.cuda.synchronize()
        err, sum_err = 0.0, 0.0
        for i, ln in enumerate(lens_list):
            if ln == 0:
                uni = float((got[i] - 1.0 / t).abs().max())
                assert uni < 2e-2 and torch.isfinite(got[i]).all(), "lens=0 row"
                continue
            err = max(err, float((got[i, :, :ln, :ln] - ref[i, :, :ln, :ln]).abs().max()))
            sum_err = max(sum_err, float((got[i, :, :, :ln].sum(-2) - 1.0).abs().max()))
        # Every weight (masked keys and padded queries included) must be the
        # twin's rounded to bf16: unit roundoff 2**-8, plus 2**-12 of float32
        # slack for the recomputed scores. A skew off by one row, or a
        # rel-pos term 1% off (max abs error still under 2e-2), exceeds this
        # bound many times over.
        rel = float(((got - ref).abs() / ((2**-8 + 2**-12) * ref.abs() + 1e-6)).max())
        del got, ref
        ms = time_ms(lambda: attention.attention_weights(*args))
        plain_ms = time_ms(lambda: attention.attention_weights_plain(*args))
        # Inputs read once, the [B, H, T, T] bf16 weights written once; the
        # content and position products (2 (qd + pd) a weight, fp32 inputs),
        # 4 more a weight for the softmax, and the position projection.
        flops = (SLICE_BATCH * h * t * t * (2 * (qd + pd) + 4)
                 + 2 * (2 * t - 1) * wpos.shape[0] * wpos.shape[1])
        bnd = bound(nbytes(*args) + SLICE_BATCH * h * t * t * 2, flops, PEAK_FP32)
        log(f"attention: stack {stack} B {SLICE_BATCH} T {t} H {h} lens {lens_list} "
            f"max_abs {err:.3e} key_sum_err {sum_err:.3e} bf16_bound_ratio {rel:.4f} "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})")
        assert err < 2e-2 and sum_err < 2e-2, "attention parity"
        assert rel <= 1.0, "attention parity: beyond bf16 rounding of the twin"
        if out is None:  # the stack-0 shape is the one the summary reports
            out = {"name": "attention_weights",
                   "source": "sherpa_vietnamese_asr_tpu_torch/csrc/attention_weights.cu",
                   "replaces": "sherpa_vietnamese_asr_tpu/ops/attention.py:35",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, **bnd}
    return out


def _beam_pair(enc, lens, decoder, joiner, cfg):
    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search, beam_search_cuda

    got = beam_search_cuda.beam_search_batch_cuda(enc, lens, decoder, joiner, cfg, 8)
    ref = beam_search.beam_search_batch(enc, lens, decoder, joiner, cfg, 8)
    return got, ref


def _beam_compare(label, got, ref):
    import torch

    torch.cuda.synchronize()
    same_tok = torch.equal(got.tokens, ref.tokens)
    same_frames = torch.equal(got.frames, ref.frames)
    same_n = torch.equal(got.num_tokens, ref.num_tokens)
    lp_err = float((got.tok_logp - ref.tok_logp).abs().max())
    tot_err = float((got.total_logp - ref.total_logp).abs().max())
    ent_err = float((got.entropy - ref.entropy).abs().max())
    diff = int((got.tokens != ref.tokens).sum())
    log(f"beam {label}: tokens_equal {same_tok} ({diff} differ) frames_equal "
        f"{same_frames} n_equal {same_n} n {got.num_tokens.tolist()} "
        f"tok_logp_err {lp_err:.3e} total_err {tot_err:.3e} entropy_err {ent_err:.3e}")
    assert same_tok and same_frames and same_n, f"beam {label}: token parity"
    assert lp_err < 1e-4 and ent_err < 1e-4, f"beam {label}: tok_logp/entropy"
    assert tot_err < 1e-3 * max(1.0, float(ref.total_logp.abs().max())), \
        f"beam {label}: total_logp"
    return lp_err


def beam_bound(enc, lens, decoder, joiner, cfg, beam, tables=None):
    """Bound of one beam-kernel launch: inputs, weights and tables read once,
    records and outputs written once; per valid chunk-frame (sum of min(len,
    T)) the decoder conv, the joiner's products (2 a multiply-add) and 10
    operations a logit for the softmax, metrics and top-k, at the fp32 rate."""
    b, t, e = enc.shape
    v, d, j = cfg.vocab_size, cfg.decoder_dim, cfg.joiner_dim
    conv = decoder.conv_weight
    frames = int(lens.clamp(0, t).sum())
    per_frame = (2 * beam * d * conv.shape[1] * conv.shape[2] + 2 * e * j
                 + 2 * beam * d * j + 2 * beam * j * v + 10 * beam * v)
    read = nbytes(enc, lens, decoder.embedding, conv, *joiner.kernel_layout())
    if tables is not None:
        read += nbytes(tables.next_state, tables.delta, tables.node_score)
    written = b * t * beam * 28 + b * t * 28 + b * 8  # records; tokens .. entropy
    return bound(read + written, frames * per_frame, PEAK_FP32)


def parent_beam_entry(parent):
    """svt_beam_search of the checkout at `parent`, built alone from its
    csrc/beam_search.cu into build/parent_beam/ (the C entry point and its
    arguments are the same)."""
    from pathlib import Path

    from sherpa_vietnamese_asr_tpu_torch.tools.beam_stages import build_entries

    src = Path(parent) / "sherpa_vietnamese_asr_tpu_torch" / "csrc" / "beam_search.cu"
    t0 = time.perf_counter()
    fn = build_entries({"parent": (src, [])}, Path(REPO) / "build" / "parent_beam")["parent"]
    log(f"parent beam kernel: built {src} in {time.perf_counter() - t0:.1f} s")
    return fn


def beam_ab(label, args, tables, parent):
    """The parent checkout's beam kernel against this one on the same inputs,
    timed in turns (parent, this, this, parent); token positions that differ."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search_cuda

    def run(entry):
        return lambda: beam_search_cuda._beam_search_cuda(*args, tables, entry=entry)

    diff = int((run(parent)().tokens != run(None)().tokens).sum())
    torch.cuda.synchronize()
    turns = [time_ms(run(entry), reps=5, warmup=1) for entry in (parent, None, None, parent)]
    log(f"beam A/B {label}: parent {turns[0]:.3f} / {turns[3]:.3f} ms, this "
        f"{turns[1]:.3f} / {turns[2]:.3f} ms (parent, this, this, parent); "
        f"{diff} token positions differ")
    return turns


def tie_rnnt(model, dev):
    """Decoder and joiner at vocab BEAM_TIE_V from the model's weights (the
    first rows of the embedding and output layer), with the BEAM_TIES output
    rows zeroed and biased: exact logit ties across vocab slices."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import Decoder, Joiner

    cfg = dataclasses.replace(model.rnnt_cfg, vocab_size=BEAM_TIE_V)
    dec, joi = Decoder(cfg, device=dev).eval(), Joiner(cfg).to(dev).eval()
    with torch.no_grad():
        dec.embedding.copy_(model.decoder.embedding[:BEAM_TIE_V])
        dec.conv_weight.copy_(model.decoder.conv_weight)
        for name in ("encoder_proj", "decoder_proj"):
            getattr(joi, name).load_state_dict(getattr(model.joiner, name).state_dict())
        joi.output.weight.copy_(model.joiner.output.weight[:BEAM_TIE_V])
        joi.output.bias.copy_(model.joiner.output.bias[:BEAM_TIE_V])
        for tok, bias in BEAM_TIES:
            joi.output.weight[tok] = 0.0
            joi.output.bias[tok] = bias
    return dec, joi, cfg


def check_beam(dev, model, parent=None):
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import Joiner
    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search, beam_search_cuda

    cfg = model.rnnt_cfg
    gen = torch.Generator(device="cpu").manual_seed(2)
    enc = torch.randn((SLICE_BATCH, 64, 256), generator=gen).to(dev)
    lens = torch.tensor(BEAM_LENS_64, dtype=torch.int32, device=dev)
    _beam_compare("T=64 mixed lens", *_beam_pair(enc, lens, model.decoder,
                                                   model.joiner, cfg))

    for label, blank_bias in (("all-blank", 20.0), ("exact-tie", -8.0)):
        joi = Joiner(cfg).to(dev)
        with torch.no_grad():
            for p in joi.parameters():
                p.zero_()
            joi.output.bias[0] = blank_bias
        got, ref = _beam_pair(enc, lens, model.decoder, joi, cfg)
        _beam_compare(label, got, ref)
        if label == "all-blank":
            assert int(got.num_tokens.max()) == 0, "all-blank emitted"
        else:
            n = int(got.num_tokens[0])
            assert n > 0 and float(got.entropy[0, :n, 1].abs().max()) == 0.0, \
                "exact tie: margin must be 0"

    enc = torch.randn((SLICE_BATCH, 823, 256), generator=gen).to(dev)
    lens = torch.tensor(BEAM_LENS_823, dtype=torch.int32, device=dev)
    err = _beam_compare("T=823 mixed lens", *_beam_pair(enc, lens, model.decoder,
                                                         model.joiner, cfg))

    # Vocab 1999: slices of unequal width, exact ties across slice boundaries.
    tdec, tjoi, tcfg = tie_rnnt(model, dev)
    got, ref = _beam_pair(enc, lens, tdec, tjoi, tcfg)
    _beam_compare(f"V={BEAM_TIE_V} boundary ties T=823 mixed lens", got, ref)
    emitted = torch.arange(got.tokens.shape[1], device=dev)[None] < got.num_tokens[:, None]
    toks = set(got.tokens[emitted].tolist())
    zero_margin = int((got.entropy[..., 1][emitted] == 0).sum())
    log(f"beam V={BEAM_TIE_V}: tied tokens emitted "
        f"{sorted(toks & {tok for tok, _ in BEAM_TIES})}, {zero_margin} of "
        f"{int(emitted.sum())} emitted tokens with margin 0")
    assert toks & {tok for tok, _ in BEAM_TIES} and zero_margin > 0, \
        "the planted ties decided nothing"

    args = (enc, lens, model.decoder, model.joiner, cfg, 8)
    ms = time_ms(lambda: beam_search_cuda.beam_search_batch_cuda(*args), reps=5, warmup=1)
    plain_ms = time_ms(lambda: beam_search.beam_search_batch(*args), reps=5, warmup=1)
    bnd = beam_bound(*args)
    longest = int(lens.clamp(0, 823).max())
    log(f"beam: B {SLICE_BATCH} T 823 V {cfg.vocab_size} beam 8, a cluster of "
        f"{beam_search_cuda.CLUSTER} blocks a chunk: kernel {ms:.3f} ms "
        f"({1e3 * ms / longest:.2f} us a frame over the longest row's {longest}), "
        f"plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
        f"{int(lens.clamp(0, 823).sum())} chunk-frames)")
    if parent is not None:
        beam_ab("B 8 T 823 V 2000 without hotwords", args, None, parent)
    return {"name": "beam_search", "source": "sherpa_vietnamese_asr_tpu_torch/csrc/beam_search.cu",
            "replaces": "sherpa_vietnamese_asr_tpu/ops/beam_search_pallas.py:101",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **bnd}


def perturbed_layer(layer, gen):
    """A copy of `layer` with N(0, 0.1) added to every bias, depthwise bias,
    the BiasNorm bias and log-scale and both bypass scales. Random init
    leaves the biases zero and both bypasses at 0.5, which would hide a
    kernel that drops a bias, ignores the log-scale or swaps the bypasses."""
    import copy

    import torch

    layer = copy.deepcopy(layer)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if name.rsplit(".", 1)[-1] in ("bias", "dw_bias", "log_scale", "bypass_scale",
                                           "bypass_mid_scale"):
                p.add_(0.1 * torch.randn(p.shape, generator=gen).to(p.device))
    return layer


def layer_faults(el, flat):
    """Planted faults of the twin: name -> (operands, rel_pos_scores). Each
    must fail the gate against the kernel at every stack shape."""
    import torch

    rel = el.rel_pos_scores

    def without(i):
        return flat[:i] + (torch.zeros_like(flat[i]),) + flat[i + 1:]

    return {"rel_pos_1pct_off": (flat, lambda pq, pl: rel(pq, pl) * 1.01),
            "skew_off_by_one": (flat, lambda pq, pl: rel(pq, pl[:, 1:])),
            "bypasses_swapped": (flat[:40] + (flat[41], flat[40]), rel),
            "attn_in_bias_dropped": (without(1), rel),
            "conv2_dw_bias_dropped": (without(35), rel),
            "norm_log_scale_dropped": (without(39), rel)}


def layer_errors(got, ref, lens_list):
    """(mean, max) |got - ref| over valid rows (all rows of a lens-0 chunk)
    as fractions of mean |ref| there, and the max itself."""
    import torch

    tp = ref.shape[1]
    diff = torch.cat([(got[i, : (ln or tp)] - ref[i, : (ln or tp)]).abs().flatten()
                      for i, ln in enumerate(lens_list)])
    scale = float(torch.cat([ref[i, : (ln or tp)].abs().flatten()
                             for i, ln in enumerate(lens_list)]).mean())
    return float(diff.mean()) / scale, float(diff.max()) / scale, float(diff.max())


def layer_gate(mean, mx):
    return mean <= LAYER_GATE_MEAN and mx <= LAYER_GATE_MAX


def layer_bound(flat, x, poslin, lens, heads, cfg):
    """Bound of one whole-layer launch: x read and the output written once
    (float32), every operand and the position rows read once; the linears
    (2 B T_pad d_in d_out), the two depthwise convs, the scores and position
    band (2 (qd + pd) a weight, 4 more for the softmax) and the three
    attends over the padded rows, at the bf16 tensor-core rate (bf16
    operands)."""
    b, tp, d = x.shape
    qd, pd, vd = cfg.query_head_dim, cfg.pos_head_dim, cfg.value_head_dim
    depthwise = (28, 34)  # [K, D] kernels among the operands
    flops = sum(2 * b * tp * w.shape[0] * w.shape[1] for i, w in enumerate(flat)
                if w.dim() == 2 and i not in depthwise)
    flops += sum(2 * b * tp * flat[i].numel() for i in depthwise)
    hna = flat[2].shape[1] // 3  # nonlin attention: one head of width hna
    flops += b * heads * tp * tp * (2 * (qd + pd) + 4) + 2 * b * tp * tp * hna
    flops += 2 * (2 * b * heads * tp * tp * vd)  # self_attn1 and self_attn2
    return bound(2 * nbytes(x) + nbytes(*flat, poslin, lens), flops, PEAK_BF16)


def check_encoder_layer(dev, model):
    """The whole-layer kernel against its twin at every stack shape: batch 8,
    mixed lens (0, 1 and full among them), layer 0 of each stack of the bf16
    random Zipformer-30M with perturbed biases, norm and bypasses, x ~ N(0, 1)
    on valid frames and zero padding. The twin with each planted fault of
    layer_faults() must fail the same gate."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import _padded_rev_pos_emb
    from sherpa_vietnamese_asr_tpu_torch.ops import encoder_layer as el

    cfg = model.zip_cfg
    gen = torch.Generator(device="cpu").manual_seed(3)
    out, failures = None, []
    for stack, t in LAYER_SHAPES:
        layer = perturbed_layer(model.encoder.stacks[stack].layers[0], gen)
        d, h = cfg.encoder_dim[stack], cfg.num_heads[stack]
        tp = -(-t // el.R) * el.R
        lens_list = [t, t // 2, 0, 1, (3 * t) // 4, t, 17, 64]
        x = torch.zeros((SLICE_BATCH, tp, d))
        x[:, :t] = torch.randn((SLICE_BATCH, t, d), generator=gen)
        x = x.to(dev)
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        rev = torch.from_numpy(_padded_rev_pos_emb(t, tp, cfg.pos_dim)).to(dev)
        flat, w_pos = layer.kernel_layout()
        poslin = el.poslin_bf16(rev, w_pos, h)

        def twin(operands=flat):
            return el.encoder_layer_plain(operands, x, poslin, lens, h, cfg.query_head_dim,
                                          cfg.pos_head_dim, cfg.value_head_dim)

        got = el.encoder_layer(layer, x, rev, lens)
        mean, mx, max_abs = layer_errors(got, twin(), lens_list)
        finite = bool(torch.isfinite(got).all())
        fault_errs, rel_pos_scores = {}, el.rel_pos_scores
        for name, (operands, rel) in layer_faults(el, flat).items():
            el.rel_pos_scores = rel
            try:
                fault_errs[name] = layer_errors(got, twin(operands), lens_list)[:2]
            finally:
                el.rel_pos_scores = rel_pos_scores
        ms = time_ms(lambda: el.encoder_layer(layer, x, rev, lens), reps=5, warmup=1)
        plain_ms = time_ms(twin, reps=3, warmup=1)
        bnd = layer_bound(flat, x, poslin, lens, h, cfg)
        log(f"encoder_layer: stack {stack} B {SLICE_BATCH} T {t} T_pad {tp} D {d} H {h} "
            f"K {cfg.cnn_module_kernel[stack]} lens {lens_list} "
            f"max/scale {mx:.3e} mean/scale {mean:.3e} "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})")
        log(f"encoder_layer: stack {stack} planted faults (mean/scale, max/scale): " + ", ".join(
            f"{name} ({m:.3e}, {hi:.3e})" for name, (m, hi) in fault_errs.items()))
        if not (finite and layer_gate(mean, mx)):
            failures.append(f"stack {stack}: kernel vs twin outside the gate")
        failures += [f"stack {stack}: planted fault {name} passes the gate"
                     for name, errs in fault_errs.items() if layer_gate(*errs)]
        if out is None:  # the stack-0 shape is the one the summary reports
            out = {"name": "encoder_layer_bf16",
                   "source": "sherpa_vietnamese_asr_tpu_torch/csrc/encoder_layer.cu",
                   "replaces": "sherpa_vietnamese_asr_tpu/ops/encoder_layer.py:109",
                   "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, **bnd}
        del got
    assert not failures, "encoder layer parity: " + "; ".join(failures)
    return out


def check_beam_hotwords(dev, model, tables, parent=None):
    """The beam kernel's hotword branch against the twin at T = 64 and 823
    (mixed lens, one 0): identical tokens, and tokens that differ from the
    same batch decoded without hotwords."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search, beam_search_cuda

    cfg = model.rnnt_cfg
    gen = torch.Generator(device="cpu").manual_seed(4)
    args = {}
    for t, lens_list in ((64, BEAM_HW_LENS_64), (823, BEAM_LENS_823)):
        enc = torch.randn((SLICE_BATCH, t, 256), generator=gen).to(dev)
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        args[t] = (enc, lens, model.decoder, model.joiner, cfg, 8)
        got = beam_search_cuda.beam_search_batch_cuda(*args[t], hw_tables=tables)
        ref = beam_search.beam_search_batch(*args[t], hw_tables=tables)
        err = _beam_compare(f"hotwords S={tables.next_state.shape[0]} T={t} mixed lens",
                            got, ref)
        plain = beam_search_cuda.beam_search_batch_cuda(*args[t])
        torch.cuda.synchronize()
        n_diff = int((plain.tokens != got.tokens).sum())
        log(f"beam hotwords T={t}: {n_diff} token positions differ from the decode "
            f"without hotwords; total_logp {got.total_logp.tolist()}")
        assert n_diff > 0, f"T={t}: the hotword table changed no token"
    ms = time_ms(lambda: beam_search_cuda.beam_search_batch_cuda(*args[823], hw_tables=tables),
                 reps=5, warmup=1)
    ms_plain_kernel = time_ms(lambda: beam_search_cuda.beam_search_batch_cuda(*args[823]),
                              reps=5, warmup=1)
    plain_ms = time_ms(lambda: beam_search.beam_search_batch(*args[823], hw_tables=tables),
                       reps=3, warmup=1)
    bnd = beam_bound(*args[823], tables=tables)
    log(f"beam hotwords: B {SLICE_BATCH} T 823 V {cfg.vocab_size} beam 8 "
        f"S {tables.next_state.shape[0]} kernel {ms:.3f} ms, kernel without hotwords "
        f"{ms_plain_kernel:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    if parent is not None:
        beam_ab(f"B 8 T 823 V 2000 hotwords S {tables.next_state.shape[0]}", args[823],
                tables, parent)
    return {"name": "beam_search_hotwords",
            "source": "sherpa_vietnamese_asr_tpu_torch/csrc/beam_search.cu",
            "replaces": "sherpa_vietnamese_asr_tpu/ops/beam_search_pallas.py:219",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **bnd}


# ---------------------------------------------------------------- phase 4-5

def write_inputs(tmp):
    from sherpa_vietnamese_asr_tpu_torch.models.golden import golden_audio
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import am_tone
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    files = {"golden_6s": golden_audio(), "am_tone_95s": am_tone(95.0, 3),
             "short_0.3s": golden_audio()[int(0.5 * SR): int(0.8 * SR)]}
    paths = {}
    for name, x in files.items():
        paths[name] = os.path.join(tmp, f"{name}.wav")
        write_wav(paths[name], x, SR)
    return files, paths


def run_requests(model, files, paths, names):
    """One TranscriberPipeline request per file, checking the result contract."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline

    for name in names:
        t0 = time.perf_counter()
        res = TranscriberPipeline(paths[name], model, config={"bypass_vad": True}).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_words = sum(len(s["raw_words"]) for s in res["segments"])
        log(f"slice {model.zip_cfg.compute_dtype}: {name} wall {wall:.3f} s duration "
            f"{res['duration_sec']:.2f} s segments {len(res['segments'])} words {n_words} "
            f"provider {res['asr_provider_info']}")
        assert abs(res["duration_sec"] - len(files[name]) / SR) < 1e-6, "duration"
        assert res["asr_provider_info"]["backend"] == "torch"
        assert res["asr_provider_info"]["device"].startswith("cuda")
        assert not os.path.exists(paths[name] + ".asr_phase")
        if name != "short_0.3s":
            assert res["segments"] and n_words > 0, f"{name}: no words"
            assert all(np.isfinite(w["prob"]) for s in res["segments"]
                       for w in s["raw_words"])


def warm_request(model, paths):
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline

    t0 = time.perf_counter()  # the 95 s request again, warm
    TranscriberPipeline(paths["am_tone_95s"], model, config={"bypass_vad": True}).run()
    torch.cuda.synchronize()
    log(f"slice {model.zip_cfg.compute_dtype}: am_tone_95s warm wall "
        f"{time.perf_counter() - t0:.3f} s")


def phase_slice(dev, model, tmp):
    """The float32 path: fbank, attention and beam kernels."""
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank

    files, paths = write_inputs(tmp)
    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0
    run_requests(model, files, paths, ("golden_6s", "am_tone_95s", "short_0.3s"))
    launches = {"fbank_logmel": fbank.launches,
                "attention_weights": attention.launches,
                "beam_search": beam_search_cuda.launches}
    log(f"slice float32 launches: {launches}")
    assert all(n > 0 for n in launches.values()), "a kernel never ran in the slice"
    warm_request(model, paths)
    return launches


def encoder_cosine(model32, model16, files):
    """Per-chunk cosine of the bf16 and float32 encoder outputs on one
    decoder batch of the 95 s file (valid frames only): the bf16 encoder of
    the slice (the whole-layer kernel on every stack), and the same weights
    with layer_kernel="never" (the plain bf16 layer with the attention
    kernel)."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import ZipformerEncoder
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import (
        BatchedChunkDecoder,
        fbank_batch,
    )

    x = files["am_tone_95s"]
    spans = [(s, min(s + 30 * SR, len(x))) for s in range(0, len(x) - 3 * SR, 27 * SR)]
    audio, lens = BatchedChunkDecoder(model16)._build_batch(
        x, spans + [(0, 1)] * (SLICE_BATCH - len(spans)))
    dev = model16.device
    never = ZipformerEncoder(dataclasses.replace(model16.zip_cfg, layer_kernel="never"),
                             device=dev).eval()
    never.load_state_dict(model16.encoder.state_dict())
    with torch.no_grad():
        feats = fbank_batch(torch.from_numpy(audio).to(dev))
        n = torch.from_numpy((lens + 80) // 160).to(dev)
        e32, l32 = model32.encoder(feats, n)
        for label, encoder in (("layer kernel", model16.encoder),
                               ('layer_kernel="never"', never)):
            e16, l16 = encoder(feats, n)
            assert torch.equal(l32, l16)
            cos = [float(torch.nn.functional.cosine_similarity(
                e16[i, :ln].flatten(), e32[i, :ln].flatten(), dim=0))
                for i, ln in enumerate(l32.tolist()[: len(spans)])]
            log(f"slice bfloat16 ({label}): encoder output vs float32, chunks "
                f"{len(spans)} frames {l32.tolist()[: len(spans)]} cosine "
                f"{[round(c, 6) for c in cos]}")
            assert min(cos) >= COSINE_GATE, f"bf16 encoder ({label}) far from float32"


def phase_slice_bf16(dev, model16, model32, tmp):
    """The bfloat16 path with a hotword table: fbank, the whole-layer kernel
    on every stack and the beam kernel's hotword branch."""
    from sherpa_vietnamese_asr_tpu_torch.ops import (
        attention,
        beam_search_cuda,
        encoder_layer,
        fbank,
    )

    files, paths = write_inputs(tmp)
    for mod in (fbank, attention, encoder_layer, beam_search_cuda):
        mod.launches = 0
    beam_search_cuda.hotword_launches = 0
    run_requests(model16, files, paths, ("golden_6s", "am_tone_95s"))
    launches = {"fbank_logmel": fbank.launches,
                "encoder_layer_bf16": encoder_layer.launches,
                "beam_search_hotwords": beam_search_cuda.hotword_launches}
    log(f"slice bfloat16 launches: {launches} (attention kernel "
        f"{attention.launches}, beam without hotwords {beam_search_cuda.launches})")
    assert all(n > 0 for n in launches.values()), "a kernel never ran in the slice"
    warm_request(model16, paths)
    encoder_cosine(model32, model16, files)
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout whose beam kernel is timed against this one")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "sherpa_vietnamese_asr_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    dev = phase_device()
    log("PHASE device ok")
    phase_build()
    parent = parent_beam_entry(os.path.abspath(args.parent)) if args.parent else None

    from sherpa_vietnamese_asr_tpu_torch.models.registry import random_asr_model
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import synthetic_hotword_tables

    t0 = time.perf_counter()
    model = random_asr_model(vocab_size=2000, beam_size=8, compute_dtype="float32",
                             device=dev)
    model16 = random_asr_model(vocab_size=2000, beam_size=8, compute_dtype="bfloat16",
                               device=dev)
    tables = synthetic_hotword_tables(model16.rnnt_cfg.vocab_size, dev)
    model16.hotword_tables = tables
    log(f"models: Zipformer-30M random (seed 0), float32 and bfloat16 (hotword table "
        f"S {tables.next_state.shape[0]}) on {dev} in {time.perf_counter() - t0:.1f} s")
    kernels = [check_fbank(dev), check_attention(dev, model), check_beam(dev, model, parent),
               check_encoder_layer(dev, model16),
               check_beam_hotwords(dev, model16, tables, parent)]
    log("PHASE kernel parity ok")
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(dev, model, tmp)
        log("PHASE slice ok")
        launches_bf16 = phase_slice_bf16(dev, model16, model, tmp)
    log("PHASE slice bf16 ok")
    for k in kernels:
        k["route"] = "cuda"
        k["launches"] = launches.get(k["name"]) or launches_bf16[k["name"]]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
