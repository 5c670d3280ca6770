#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card's name and power limit; TF32 off for fp32 products
     and cuDNN convolutions;
  2. build: compile the package's CUDA kernels (csrc/*.cu) from source;
  3. kernel parity: each kernel against its plain PyTorch twin on the card,
     at the shapes the transcription paths give it, with both median times
     (the attention kernel at the four distinct stack shapes, with its
     device time, where the twin fed TF32-rounded q and k must fail its gate
     at stack 0; the fbank kernel at its three configs on a full and a ragged batch
     with all-zero frames, against the float64 Kaldi oracle too, where four
     planted faults of the twin must fail its gate, and at its other n_fft,
     with the kernel's device time and the whole fbank_batch's framing
     split; the whole-layer kernel at all six Zipformer-30M stack shapes
     with perturbed biases, norm and bypasses, where six planted faults of
     the twin must fail the same gate, with the device time of its parts
     (products, score pass, depthwise conv, elementwise), the products'
     TFLOP/s and cuBLAS's time for the same 20 products; the beam kernel
     with and without a hotword table, and at vocab 1999 with ties planted
     across its vocab slices; the bf16-band attention kernel at the
     attention shapes, where kernel 2's twin (the band unrounded) must fail
     its gate; the beam kernel again at Zipformer-68M's joiner input (E 512);
     the whole-layer kernel at Zipformer-68M's stacks 2-4 (nonlin attends
     of 288 and 384 columns, two column tiles) with the same faults and
     gate, beside the plain bf16 layer with kernel 2 at those shapes;
     with --parent DIR, the attention, beam and layer kernels of
     the checkout in DIR timed against these in turns, both attention
     kernels within the gate, the layer kernel's output and the beam
     kernel's (beam 8 here, 16, 17, 24 and 32 in phase 16) bit-identical);
  4. float32 slice: TranscriberPipeline(..., {"bypass_vad": True}).run() on
     three WAV files with a random-weight Zipformer-30M model (vocab 2000,
     beam 8, float32), checking the result contract and that every kernel of
     the path ran; then one request with {"max_batch": 0}: the size resolved
     from the card's free memory (64 on an idle 80 GB card), every kernel
     launched at it, the words equal to max_batch 8's (the joiner sharpened
     x 8 against near-ties; a difference counted and held to the host CPU's
     spread);
  5. bfloat16 slice: the same entry point with the bfloat16 Zipformer-30M
     (same weights) carrying a hotword table, on two files; the whole-layer
     kernel and the hotword beam must run, and the bf16 encoder output must
     agree with the float32 encoder's on one batch (cosine >= 0.99);
  6. bf16-band probe: tools/skew_bf16 at the probe's three stack shapes
     (kernel 2 against the bf16-band kernel: times, drift, each against its
     twin); the bf16-band kernel must run;
  7. default path: the float32 Zipformer-30M written as a sherpa-onnx
     directory (models/onnx_export_rnnt) and loaded back on the card
     (load_asr_model, every tensor equal); the CLI
     `transcribe <wav> --model <dir>` in-process with its defaults (Silero
     VAD on the card, random weights, loudly flagged) on 100 s of
     speech-like audio with silences: its words equal an in-memory
     TranscriberPipeline run's, the VAD's probabilities came from the card
     and agree with the same weights on the CPU, no "VAD failed" phase, the
     .asr.json is written and the fbank, attention and beam kernels ran;
     ROVER over the float32 30M and 68M pair (each model's words equal its
     own single-model decode); one bfloat16 Zipformer-68M request, timed in
     turns against layer_kernel="never" (kernel 4 on all 16 layers of a
     forward and kernel 2 never, under "auto" and "always"; encoder cosine
     against float32); the CLI `transcribe --beam N` at 16, 32, 33, 64 and
     128, each giving an in-memory run's words; enable_resume stopped after the
     decode and run again on the golden file. Every wall time beside the
     card's name and power limit;
  8. diarization: a full-width PureDiarizer (PyanNet + ResNet34, random
     weights from a torch.Generator seeded 0) on the card against its CPU
     twin on 20 s of two alternating tones (powerset argmax agreeing on
     >= 99.9% of frames, every valid slot's embedding at cosine >= 0.9999,
     identical segments where the argmax agrees everywhere, and the card
     with its per-chunk CMVN dropped failing the embedding gate); the CLI
     `transcribe <100 s wav> --model <dir> --diarize` on a directory written
     by the port's exporters (speakers in the .asr.json, the models read
     from the directory), and the facade's background pass giving the
     synchronous path's speakers; a warm 600 s PureDiarizer.process (wall,
     device busy, one superblock's device time by part) with kernel 1
     launched once a superblock;
  9. punctuation and quality: a full-width ViBERT (12 x 768, vocab 62,000,
     random from a torch.Generator seeded 0) on the card against its CPU
     twin on one 32 x T 128 minibatch (logits within 1e-4 of the twin's
     max, label argmax agreeing on >= 99.9% of word positions), TF32
     products failing that gate, the int8 tier's agreement; GecBert on
     2,000 words with pause hints, card against CPU (equal text where the
     argmax agrees), its warm wall, device time, minibatches, iterations
     and host time; DNSMOS on three 9.01 s windows within 1e-4, a periodic
     Hann window failing it; the CLI `transcribe <100 s wav> --model <dir>
     --punctuate --quality --diarize` on a directory written by the port's
     exporters, the same request through TranscriberPipeline with DNSMOS
     overlapped and synchronous (equal raw scores); a warm 600 s request
     with both stages;
 10. streaming: kernel 1 against its twin at the fused streaming step's
     shape (8 windows, [8 x 68, 512]); MultiStreamRecognizer(n_streams=8)
     on the card with the joiner sharpened x 8, 8 streams of 20 s in 0.1 s
     pieces, three joining late: every step's encoder output within 1e-4
     of the same class on the CPU, token ids equal to the CPU's and to
     single-stream recognizers on the card, kernel 1 launched once a step;
     the background pump equal to the pipelined recognizer; a bfloat16 pass
     (encoder cosine >= 0.99 against float32); kernels 2, 3 and 4 against
     their twins at the sessions' batch-1 shapes (14 s and 24 s pads); the
     fused step's wall, device time, operations, idle share and real-time
     streams at N 1 and 8; StreamingSession (Silero VAD on the card) and
     OnlineStreamingSession on 60 s of speech-like audio with silences:
     finals emitted, at the CPU run's times, each final text equal to the
     beam twin over the card's encoder output, the CPU run's word
     differences counted; kernels 1-3 launched by their decodes at batch 1.
 11. Senko diarization and overlap separation: a full-width PyanNet, CAM++
     and Conv-TasNet (random, one torch.Generator seeded 0; the CAM++
     embedding BatchNorm centred on two-tone windows) on the card; CAM++ on
     a block of 128 windows against its CPU twin (cosine >= 0.99999) and
     Conv-TasNet on 10 s (within 1e-4 of max |source|), each refusing to run
     with TF32 on; SenkoCamppDiarizer on 100 s with the CPU twin's segments;
     kernel 1 at CAMPP_FBANK on a 600 s request's speech regions against its
     twin; a 600 s TranscriberPipeline request with the Senko facade and a
     warm 600 s process (wall, device busy, idle share, kernel 1 once a
     region); the UMAP + HDBSCAN route on 1,260 s with the native
     clusterkit; one _run_overlap_separation on planted 2-speaker segments
     and regions, each stream re-decoded through kernels 1-3; a 100 s
     request with Senko diarization and overlap_separation.
 12. serving: a Llama at TinyLlama-1.1B's widths (random, torch.Generator
     seeded 0) on the card against its CPU twin (logits of a 64-token
     prompt within 1e-4 of the max, greedy tokens equal up to the first
     near-tie, TF32 refused; prefill, step and tokens/s against the step's
     bound); a 2-layer Q8_0 GGUF at those widths loaded onto the card
     (every tensor the dequantised file's) and the local summarizer
     generating there as on the CPU; the web service (make_server) on the
     card with the float32 Zipformer-30M (joiner x 8): a 100 s upload
     through the queue to "completed" with an in-memory run's words and
     kernels 1-3 launched by the queued job, a summary generated on the
     card, two /ws/stream clients with single-stream finals and kernel 1
     once a fused step, /api/calibration/run with cpu and cuda within
     tolerance, and warmup_programs cold and warm with every stage timed
     (then its bfloat16 decode stage: kernel 4 and the hotword beam).
 13. verify assets: full-width stand-ins of every asset written under their
     MANIFEST names (tools/rehearsal_assets: the float32 Zipformer-30M and
     68M, joiners x 8, as executable exports at 96 frames; the streaming
     30M; PyanNet, ResNet34 with its split files, a seeded PLDA, CAM++,
     Silero, Conv-TasNet, ViBERT and DNSMOS from one torch.Generator seeded
     0), the MANIFEST re-pinned to their SHA-256, and `cli verify-assets
     --json --device cuda` in process: ok, every asset verified or partial,
     no skip but the JAX package's own, kernels 2 and 3 launched; each exec
     row's max_abs / rel_l2; models/golden.run_torch_stack on the card
     against run_exec_stack on the same export (tokens that differ, held to
     the host CPU's count); the native audiokit built, and 0.5 s of a
     44.1 kHz stereo WAV through load_audio against the pure-numpy path.
 14. bench: the package's bench (`cli bench`'s main) with two timed batches
     a tier and a 2-minute full pipeline, its JSON line printed; any
     `skipped` but time_budget (a failed check_contract among them) or a
     value that is not positive fails, and kernels 1-4 must launch.
 15. multi-device: BatchedChunkDecoder on 16 spans of 30 s with mesh
     [cuda:0], and with a CPU copy of the model replicated to the card by
     the mesh, bit-identical to mesh=None; two replicas on the card
     ([cuda:0, cuda:0] at max_batch 16, the same launch shapes as mesh=None
     at max_batch 8) bit-identical too; QualityAnalyzer on six windows over
     the two replicas equal to the unsplit analyzer on each half; a
     full-width PureDiarizer's two superblocks on 100 s and GecBert (full
     ViBERT, mini_batch 32 in pieces of 16 against 16) on the phase-9 text,
     each bit-identical over two replicas.
 16. beam past 8 (last, since its plain-twin runs leave torch.profiler
     losing events): the beam kernel at beam 16 (its cap past 8) and the
     row-tiled beam kernel at beams 32, 33, 64 and 128 at E 256 and 512,
     with and without hotwords, held to the host twin's spread on
     near-ties (the beams past 32 at E 256 token-identical with the joiner
     sharpened, beam 33 also on the random joiner under the near-tie rule),
     at B 1 too, the tiled kernel at vocab 48 (a beam of 64 past the first
     frames' live candidates) and bit-identical to the caps at beams 8 and
     16, with each beam's time around the wrapper and of the launch alone;
     with --parent, cap 16 and the tiled kernel at beams 17, 24 (hotwords)
     and 32 bit-identical to DIR's kernel (cap 32 at 17-32) in turns.
Each phase prints its seconds. The line before the last is a JSON summary
of the kernels, each with its bound (the least time the card could take
for the same work, from this run's shapes and the card's published peaks),
kernel 1 also at the Senko (CAMPP_FBANK on the speech regions) and overlap
paths' shapes with their own launches, and each kernel's launches on the
serving path ("serving_launches"), the verify-assets path
("verify_launches") and the bench ("bench_launches"); the last line is
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
ATTN_SHAPES = (  # (stack, T, H) of Zipformer-30M at a 33 s chunk, each distinct one
    (0, 1646, 4),
    (1, 823, 4),  # and stack 5
    (2, 412, 4),  # and stack 4
    (3, 206, 8),
)
BEAM_LENS_64 = [64, 33, 1, 64, 17, 50, 64, 8]
BEAM_LENS_823 = [823, 611, 1, 823, 402, 0, 823, 77]
BEAM_HW_LENS_64 = [64, 0, 33, 64, 1, 50, 64, 8]
LAYER_SHAPES = (  # (stack, t_ds) of Zipformer-30M at a 33 s chunk
    (0, 1646), (1, 823), (2, 412), (3, 206), (4, 412), (5, 823))
# Zipformer-68M's stacks whose nonlin attends (288 / 384 / 288 columns) the
# layer kernel runs in two column tiles; its stacks 0, 1 and 5 have 30M's
# attend widths.
LAYER_SHAPES_68M = ((2, 412), (3, 206), (4, 412))
BEAM_CAPS_LENS = [823, 402, 1, 0]  # B 4 of BEAM_LENS_823's mix: the twins' slow runs
CAP_BEAMS = (8, 16)  # the beam kernel's caps
BEAM_WIDE = (33, 64, 128)  # beams past 32, the TPU kernel's range: the row-tiled kernel
BEAM_V48 = 48  # a vocab whose first frames hold fewer live candidates than a beam of 64
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
AUTO_SHARPEN = 8.0  # joiner output weights of the max_batch 0 request (tests/test_torch_slice.py)
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
PEAK_TF32 = 495e12  # tensor cores
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


def bound(nbytes, *work):
    """{"bound_ms", "bound_by"}: the larger of the bytes' time at the memory
    rate and the operations' time, `work` being pairs (operations, peak of
    their type), flattened: bound(nbytes, flops, peak[, flops2, peak2])."""
    by_bytes = nbytes / PEAK_BYTES * 1e3
    by_ops = sum(f / p for f, p in zip(work[::2], work[1::2])) * 1e3
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


def fbank_bound(n_frames, cfg, dev):
    """The fbank kernel's bound on n_frames frames: each frame read once,
    each log-mel written once, the tables once; operations of a radix-2 FFT
    of the n_fft/2 complex points (5 h log2 h), the real split and power (17
    a bin), the compact mel weights (2 each) and a log per output."""
    from sherpa_vietnamese_asr_tpu_torch.ops import fbank

    tables = fbank._kernel_constants(cfg, dev)
    h = cfg.n_fft // 2
    flops = n_frames * (5 * h * np.log2(h) + 17 * h + 2 * tables[3].numel() + cfg.num_bins)
    return bound(n_frames * 4 * (cfg.n_fft + cfg.num_bins) + nbytes(*tables), flops, PEAK_FP32)


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
        _, kernel_dev, _ = profile_calls(lambda: fbank.logmel(frames, cfg),
                                        expect="logmel_kernel")
        plain_busy, _, _ = profile_calls(lambda: fbank._logmel_plain(frames, cfg))
        kernel_dev_ms = sum(v for k, v in kernel_dev.items() if "logmel_kernel" in k)
        batch_ms = time_ms(lambda: fbank_batch(audio_dev))
        framing_ms = time_ms(
            lambda: fbank._frame_signal(audio_dev, cfg).reshape(-1, cfg.n_fft).contiguous())
        batch_busy, batch_dev, _ = profile_calls(lambda: fbank_batch(audio_dev),
                                                 expect="logmel_kernel")
        batch_kernel = sum(v for k, v in batch_dev.items() if "logmel_kernel" in k)
        log(f"fbank asr: F {frames.shape[0]} kernel {ms:.3f} ms (device {kernel_dev_ms:.4f} ms) "
            f"plain {plain_ms:.3f} ms (device {plain_busy:.4f} ms)")
        log(f"fbank_batch [{SLICE_BATCH}, {CHUNK_SAMPLES}]: {batch_ms:.3f} ms, framing alone "
            f"{framing_ms:.3f} ms; device busy {batch_busy:.4f} ms, of it the kernel "
            f"{batch_kernel:.4f} ms and framing {batch_busy - batch_kernel:.4f} ms; "
            f"device kernels " + ", ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(
                batch_dev.items(), key=lambda kv: -kv[1])))
        summary.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                       **fbank_bound(frames.shape[0], cfg, dev))
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


def attention_inputs(dev, model, shapes=ATTN_SHAPES, lens_of=None):
    """(stack, t, h, lens_list, args) at each (stack, t, h) shape: layer 0's
    own projections of x ~ N(0, 1); lens_of(t) gives the batch's lens,
    by default batch 8 with mixed lens (0 among them)."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import compact_rel_pos_emb

    gen = torch.Generator(device="cpu").manual_seed(1)
    cfg = model.zip_cfg
    qd, pd = cfg.query_head_dim, cfg.pos_head_dim
    for stack, t, h in shapes:
        layer = model.encoder.stacks[stack].layers[0]
        lens_list = (lens_of(t) if lens_of is not None
                     else [t, t // 2, 0, 64, 1, (3 * t) // 4, t, 17])
        b = len(lens_list)
        x = torch.randn((b, t, cfg.encoder_dim[stack]), generator=gen).to(dev)
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        with torch.no_grad():
            proj = layer.attn_in_proj(x)
        q = proj[..., : h * qd].reshape(b, t, h, qd)
        k = proj[..., h * qd: 2 * h * qd].reshape(b, t, h, qd)
        pq = proj[..., 2 * h * qd:].reshape(b, t, h, pd)
        wpos = layer.attn_pos_proj.weight.detach().t()
        pos = torch.from_numpy(compact_rel_pos_emb(t, cfg.pos_dim)).to(dev)
        yield stack, t, h, lens_list, (q, k, pq, wpos, pos, lens)


def attention_gate(got, ref, lens_list):
    """(max abs error over valid keys and queries, largest |key sum - 1|,
    largest ratio to the bf16 bound) of kernel weights `got` against a twin;
    asserts the uniform rows of lens-0 chunks.

    Every weight (masked keys and padded queries included) must be the
    twin's rounded to bf16: unit roundoff 2**-8, plus 2**-12 of float32
    slack for the recomputed scores. A skew off by one row, or a rel-pos
    term 1% off (max abs error still under 2e-2), exceeds this bound many
    times over."""
    t = got.shape[-1]
    err, sum_err = 0.0, 0.0
    for i, ln in enumerate(lens_list):
        if ln == 0:
            uni = float((got[i] - 1.0 / t).abs().max())
            assert uni < 2e-2 and got[i].isfinite().all(), "lens=0 row"
            continue
        err = max(err, float((got[i, :, :ln, :ln] - ref[i, :, :ln, :ln]).abs().max()))
        sum_err = max(sum_err, float((got[i, :, :, :ln].sum(-2) - 1.0).abs().max()))
    rel = float(((got - ref).abs() / ((2**-8 + 2**-12) * ref.abs() + 1e-6)).max())
    return err, sum_err, rel


def attention_bound(args):
    """Inputs read once, the [B, H, T, T] bf16 weights written once; the
    content product (2 qd a weight) at the TF32 tensor-core rate, three
    times over for the 3xTF32 split that float32 accuracy needs; the band
    (2 pd a weight), 4 more a weight for the softmax and the position
    projection at the fp32 rate."""
    q, _, pq, wpos = args[:4]
    b, t, h, qd = q.shape
    weights = b * h * t * t
    rest = weights * (2 * pq.shape[-1] + 4) + 2 * (2 * t - 1) * wpos.numel()
    return bound(nbytes(*args) + weights * 2, 3 * 2 * qd * weights, PEAK_TF32,
                 rest, PEAK_FP32)


def tf32_round(x):
    """x rounded to TF32 as cvt.rna does (10 mantissa bits, nearest, ties
    away from zero), on float32 bit patterns."""
    import torch

    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_twin(args):
    """Planted fault: the twin fed TF32-rounded q and k, which is what one
    TF32 pass of the content product computes."""
    from sherpa_vietnamese_asr_tpu_torch.ops import attention

    q, k, *rest = args
    return attention.attention_weights_plain(tf32_round(q), tf32_round(k), *rest)


def check_attention(dev, model, parent=None):
    """Kernel 2 against its twin at every ATTN_SHAPES shape, with its event
    and device times; at stack 0 the twin fed TF32-rounded q and k must fail
    the gate. With a parent checkout, the parent's kernel 2 on the same
    inputs, both within the gate, timed in turns."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import attention
    from sherpa_vietnamese_asr_tpu_torch.tools.skew_bf16 import device_ms

    out = None
    for stack, t, h, lens_list, args in attention_inputs(dev, model):
        got = attention.attention_weights(*args).float()
        ref = attention.attention_weights_plain(*args)
        torch.cuda.synchronize()
        err, sum_err, rel = attention_gate(got, ref, lens_list)
        del got
        fault_rel = None
        if stack == 0:
            _, _, fault_rel = attention_gate(tf32_twin(args), ref, lens_list)
        ms = time_ms(lambda: attention.attention_weights(*args))
        dev_ms, seen = device_ms(lambda: attention.attention_weights(*args), 10)
        plain_ms = time_ms(lambda: attention.attention_weights_plain(*args))
        bnd = attention_bound(args)
        log(f"attention: stack {stack} B {SLICE_BATCH} T {t} H {h} lens {lens_list} "
            f"max_abs {err:.3e} key_sum_err {sum_err:.3e} bf16_bound_ratio {rel:.4f} "
            + (f"planted fault tf32_inputs ratio {fault_rel:.4f} " if fault_rel else "")
            + f"kernel {ms:.3f} ms (device {dev_ms:.4f} ms, {seen} launches seen) "
            f"plain {plain_ms:.3f} ms bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        assert err < 2e-2 and sum_err < 2e-2, "attention parity"
        assert rel <= 1.0, "attention parity: beyond bf16 rounding of the twin"
        assert fault_rel is None or fault_rel > 1.0, "planted fault tf32_inputs passes the gate"
        if parent is not None:
            attention_ab(stack, args, lens_list, ref, parent["attention"])
        del ref
        if out is None:  # the stack-0 shape is the one the summary reports
            out = {"name": "attention_weights",
                   "source": "sherpa_vietnamese_asr_tpu_torch/csrc/attention_weights.cu",
                   "replaces": "sherpa_vietnamese_asr_tpu/ops/attention.py:35",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, **bnd}
    return out


def parent_attention(entry, args):
    """A call of the parent checkout's kernel 2 on args. A parent with this
    C interface reads q, k and pq in place, as this wrapper does; an earlier
    one (12 arguments) takes contiguous [B*H, T, d] copies of them and the
    [H, 2T-1, pd] position table, made here as its wrapper made them."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import attention, cuda_lib

    if len(entry.argtypes) == len(cuda_lib.SIGNATURES["svt_attention_weights"]):
        return lambda: attention._attention_weights_cuda(*args, entry=entry)
    q, k, pq, wpos, pos_emb, lens = args
    b, t, h, qd = q.shape
    pd = pq.shape[-1]

    def run():
        qh, kh, ph = (x.permute(0, 2, 1, 3).contiguous() for x in (q, k, pq))
        table = attention.kernel_pos_table(wpos, pos_emb, h)
        lens32 = lens.to(torch.int32)
        out = torch.empty((b, h, t, t), dtype=torch.bfloat16, device=q.device)
        cuda_lib.check(entry(qh.data_ptr(), kh.data_ptr(), ph.data_ptr(), table.data_ptr(),
                             lens32.data_ptr(), out.data_ptr(), b, h, t, qd, pd,
                             cuda_lib.stream(q.device)), "parent svt_attention_weights")
        return out

    return run


def attention_ab(stack, args, lens_list, ref, entry):
    """The parent checkout's kernel 2 against this one on the same inputs:
    both within the gate against the twin `ref`, the largest |this -
    parent| logged; timed in turns (parent, this, this, parent), event and
    device time. The summation order differs, so the outputs need not be
    bit-identical."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import attention
    from sherpa_vietnamese_asr_tpu_torch.tools.skew_bf16 import device_ms

    fns = {"parent": parent_attention(entry, args),
           "this": lambda: attention._attention_weights_cuda(*args, entry=None)}
    got = {name: fn().float() for name, fn in fns.items()}
    torch.cuda.synchronize()
    rel = {name: attention_gate(w, ref, lens_list)[2] for name, w in got.items()}
    diff = float((got["this"] - got["parent"]).abs().max())
    del got
    turns = [time_ms(fns[name]) for name in ("parent", "this", "this", "parent")]
    device = {name: device_ms(fn, 10)[0] for name, fn in fns.items()}
    log(f"attention A/B stack {stack}: parent {turns[0]:.3f} / {turns[3]:.3f} ms, this "
        f"{turns[1]:.3f} / {turns[2]:.3f} ms (parent, this, this, parent); device parent "
        f"{device['parent']:.4f} ms, this {device['this']:.4f} ms; bf16_bound_ratio parent "
        f"{rel['parent']:.4f}, this {rel['this']:.4f}; max |this - parent| {diff:.3e}")
    assert max(rel.values()) <= 1.0, f"attention A/B stack {stack}: beyond the gate"


def check_attention_bf16band(dev, model):
    """The bf16-band kernel against its twin at ATTN_SHAPES, inside kernel 2's
    gate; kernel 2's twin (the band left in float32) must fail that gate.
    Then kernel 5 and kernel 2 timed in turns, with their device times."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import attention
    from sherpa_vietnamese_asr_tpu_torch.tools import skew_bf16

    out = None
    for stack, t, h, lens_list, args in attention_inputs(dev, model):
        got = attention.attention_weights_bf16band(*args).float()
        ref = attention.attention_weights_bf16band_plain(*args)
        torch.cuda.synchronize()
        err, sum_err, rel = attention_gate(got, ref, lens_list)
        del ref
        _, _, fault_rel = attention_gate(got, attention.attention_weights_plain(*args),
                                         lens_list)
        del got
        turns, device, seen = skew_bf16.kernel_times(args, rounds=7)
        ms = turns["attention_weights_bf16band"]
        plain_ms = time_ms(lambda: attention.attention_weights_bf16band_plain(*args))
        bnd = attention_bound(args)
        log(f"attention bf16band: stack {stack} B {SLICE_BATCH} T {t} H {h} lens {lens_list} "
            f"max_abs {err:.3e} key_sum_err {sum_err:.3e} bf16_bound_ratio {rel:.4f}; "
            f"planted fault band_unrounded (kernel 2's twin) ratio {fault_rel:.4f}; "
            f"kernel {ms:.3f} ms (device {device['attention_weights_bf16band']:.4f} ms), "
            f"kernel 2 in turns {turns['attention_weights']:.3f} ms (device "
            f"{device['attention_weights']:.4f} ms), launches seen {seen}, plain "
            f"{plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        assert err < 2e-2 and sum_err < 2e-2, "attention bf16band parity"
        assert rel <= 1.0, "attention bf16band parity: beyond bf16 rounding of the twin"
        assert fault_rel > 1.0, "planted fault band_unrounded passes the gate"
        if out is None:
            out = {"name": "attention_weights_bf16band",
                   "source": "sherpa_vietnamese_asr_tpu_torch/csrc/attention_weights.cu",
                   "replaces": "benchmarks/_skewbf16.py:33",
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


def parent_entries(parent):
    """{"attention": svt_attention_weights, "beam": svt_beam_search, "layer":
    svt_encoder_layer_bf16} of the checkout at `parent`, each built alone
    from its csrc/ source into build/parent_kernels/ with the parent's nvcc
    flags, the three nvcc started together. Each entry point carries the
    parent's own argtypes (its cuda_lib.SIGNATURES): the beam kernel's
    arguments are this one's, or those of the caps 8, 16 and 32 with their
    history workspace (parent_caps), the attention and layer kernels' may
    not be (parent_attention, parent_layer)."""
    import ctypes
    from pathlib import Path

    from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib

    pkg = Path(parent) / "sherpa_vietnamese_asr_tpu_torch"
    lib_py = pkg / "ops" / "cuda_lib.py"
    theirs = {"__file__": str(lib_py), "__name__": "parent_cuda_lib"}
    exec(compile(lib_py.read_text(), str(lib_py), "exec"), theirs)
    out_dir = Path(REPO) / "build" / "parent_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name, src, symbol in (("attention", "attention_weights.cu", "svt_attention_weights"),
                              ("beam", "beam_search.cu", "svt_beam_search"),
                              ("layer", "encoder_layer.cu", "svt_encoder_layer_bf16")):
        lib = out_dir / f"lib{name}.so"
        cmd = [cuda_lib.find_nvcc(), *theirs["NVCC_FLAGS"], "-o", str(lib),
               str(pkg / "csrc" / src)]
        jobs[name] = (lib, symbol, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, symbol, proc) in jobs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name} kernel:\n{out}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = theirs["SIGNATURES"][symbol]
        fn.restype = ctypes.c_int
        fns[name] = fn
    log(f"parent kernels: built {pkg / 'csrc'} attention_weights.cu, beam_search.cu and "
        f"encoder_layer.cu in {time.perf_counter() - t0:.1f} s")
    if len(fns["beam"].argtypes) == len(cuda_lib.SIGNATURES["svt_beam_search"]) + 1:
        fns["beam"] = parent_caps(fns["beam"])
    return fns


def parent_caps(entry):
    """A stand-in for this wrapper's C entries (_beam_search_cuda's `entry`)
    that calls `entry`, the beam caps 8, 16 and 32 of a parent whose 18th
    argument is their token-history workspace `hist` ([B, 2, 32, T rounded
    up to 8] int16 past beam 16, else null). The wrapper passes the caps'
    arguments up to beam 16 and the tiled kernel's (its workspace and size
    in the place of `hist`) past it, so beams 1-32 run the parent's caps."""
    import torch

    def call(*a):
        rest = a[19:] if len(a) == len(entry.argtypes) + 1 else a[17:]
        b, t, beam = rest[6], rest[7], rest[14]  # after the six outputs
        hist = (torch.empty((b, 2, 32, -(-t // 8) * 8), dtype=torch.int16, device="cuda")
                if beam > 16 else None)
        # Freed on return, reused only by later work on the same stream.
        return entry(*a[:17], None if hist is None else hist.data_ptr(), *rest)

    return call


def launch_ms(args, reps=3, tiled=False):
    """Median ms of the beam kernel's launch alone (args: _beam_search_cuda's
    first seven): CUDA events recorded just before and after the C entry's
    call inside the wrapper, so the span holds the kernel and a launch's
    microseconds but not the wrapper's checks and allocations: event time,
    not a trace's device time. torch.profiler is not used here: in two
    full runs of this script its windows over the beam kernel lost every
    event, and later windows of the process went on losing events."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search_cuda, cuda_lib

    lib = cuda_lib.library()
    tiled = tiled or beam_search_cuda.beam_cap(args[5]) == beam_search_cuda.TILED
    c_entry = lib.svt_beam_search_tiled if tiled else lib.svt_beam_search
    times = []

    def timed(*a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        status = c_entry(*a)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        return status

    for _ in range(reps + 1):  # the first is a warm-up
        beam_search_cuda._beam_search_cuda(*args, entry=timed, tiled=tiled)
    return float(np.median(times[1:]))


def beam_identical(a, b):
    """Whether two BeamResults agree bit for bit in every field."""
    import torch

    return all(torch.equal(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a))


def beam_ab(label, args, tables, parent):
    """The parent checkout's beam kernel against this one on the same inputs,
    timed in turns (parent, this, this, parent); every field of the result
    must be bit-identical."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search_cuda

    def run(entry):
        return lambda: beam_search_cuda._beam_search_cuda(*args, tables, entry=entry)

    theirs, ours = run(parent)(), run(None)()
    torch.cuda.synchronize()
    diff = int((theirs.tokens != ours.tokens).sum())
    same = beam_identical(theirs, ours)
    turns = [time_ms(run(entry), reps=5, warmup=1) for entry in (parent, None, None, parent)]
    log(f"beam A/B {label}: parent {turns[0]:.3f} / {turns[3]:.3f} ms, this "
        f"{turns[1]:.3f} / {turns[2]:.3f} ms (parent, this, this, parent); "
        f"{diff} token positions differ, bit-identical {same}")
    assert same, f"beam A/B {label}: not bit-identical to the parent's kernel"
    return turns


def vocab_rnnt(model, dev, v):
    """Decoder and joiner at vocab v from the model's weights (the first
    rows of the embedding and output layer)."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.rnnt import Decoder, Joiner

    cfg = dataclasses.replace(model.rnnt_cfg, vocab_size=v)
    dec, joi = Decoder(cfg, device=dev).eval(), Joiner(cfg).to(dev).eval()
    with torch.no_grad():
        dec.embedding.copy_(model.decoder.embedding[:v])
        dec.conv_weight.copy_(model.decoder.conv_weight)
        for name in ("encoder_proj", "decoder_proj"):
            getattr(joi, name).load_state_dict(getattr(model.joiner, name).state_dict())
        joi.output.weight.copy_(model.joiner.output.weight[:v])
        joi.output.bias.copy_(model.joiner.output.bias[:v])
    return dec, joi, cfg


def tie_rnnt(model, dev):
    """vocab_rnnt at BEAM_TIE_V with the BEAM_TIES output rows zeroed and
    biased: exact logit ties across vocab slices."""
    import torch

    dec, joi, cfg = vocab_rnnt(model, dev, BEAM_TIE_V)
    with torch.no_grad():
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
        beam_ab("B 8 T 823 V 2000 without hotwords", args, None, parent["beam"])
    return {"name": "beam_search", "source": "sherpa_vietnamese_asr_tpu_torch/csrc/beam_search.cu",
            "replaces": "sherpa_vietnamese_asr_tpu/ops/beam_search_pallas.py:101",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, **bnd}


def check_beam_e512(dev, model68):
    """The beam kernel at Zipformer-68M's joiner input (E 512, the 68M
    model's random decoder and joiner) against its twin at T 64 and 823,
    under beam_near_ties' rule.

    Random weights leave the logits nearly uniform (top-2 probability
    margins of about 3e-5 at V 2000), where the order of a float32 sum
    decides some beam steps: the same twin on the host CPU differs from the
    twin on the card in a few tokens (8 in 3 rows at T 823 on an H100)."""
    import copy

    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search, beam_search_cuda

    cfg = model68.rnnt_cfg
    e = cfg.encoder_out_dim
    smem = beam_search_cuda._kernel_smem_bytes(823, e, cfg.decoder_dim, cfg.joiner_dim,
                                               cfg.vocab_size)
    log(f"beam E {e}: shared memory a block at T 823 {smem} B "
        f"(limit {beam_search_cuda._smem_limit(8)} B)")
    dec_cpu, joi_cpu = copy.deepcopy(model68.decoder).cpu(), copy.deepcopy(model68.joiner).cpu()
    gen = torch.Generator(device="cpu").manual_seed(5)
    for t, lens in ((64, BEAM_LENS_64), (823, BEAM_LENS_823)):
        enc = torch.randn((SLICE_BATCH, t, e), generator=gen).to(dev)
        lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        got, ref = _beam_pair(enc, lens, model68.decoder, model68.joiner, cfg)
        beam_near_ties(f"E={e} T={t} mixed lens", got, ref, lambda: beam_search.beam_search_batch(
            enc.cpu(), lens.cpu(), dec_cpu, joi_cpu, cfg, 8))
    args = (enc, lens, model68.decoder, model68.joiner, cfg, 8)
    ms = time_ms(lambda: beam_search_cuda.beam_search_batch_cuda(*args), reps=5, warmup=1)
    bnd = beam_bound(*args)
    log(f"beam E {e}: B {SLICE_BATCH} T 823 V {cfg.vocab_size} beam 8: kernel {ms:.3f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")


def beam_near_ties(label, got, ref, host):
    """The beam kernel against its twin on random weights, whose near-ties
    the order of a float32 sum decides: the kernel may differ from the twin
    on the card in no more tokens than the twin on the host CPU (host(), run
    only when the kernel differs) differs from it, and on every row whose
    tokens equal the twin's it must match frames, per-token log-probs and
    metrics as _beam_compare does. Returns the log-prob error of those
    rows."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search

    torch.cuda.synchronize()
    kernel_diff = got.tokens != ref.tokens
    n_diff = int(kernel_diff.sum())
    t0 = time.perf_counter()
    order_diff = int((ref.tokens.cpu() != host().tokens).sum()) if n_diff else None
    host_s = f" ({time.perf_counter() - t0:.1f} s on the host)" if n_diff else ""
    same = ~kernel_diff.any(dim=1)
    log(f"beam {label}: kernel vs twin {n_diff} tokens differ (rows "
        f"{kernel_diff.any(dim=1).nonzero().flatten().tolist()}), twin on the host vs on the "
        f"card {'not run' if order_diff is None else order_diff}{host_s}; n "
        f"{got.num_tokens.tolist()}")
    assert n_diff <= (order_diff or 0), f"beam {label}: token parity"
    assert bool(same.any()), f"beam {label}: no row equal to the twin's"
    rows = [beam_search.BeamResult(*(getattr(r, f.name)[same] for f in dataclasses.fields(r)))
            for r in (got, ref)]
    return _beam_compare(f"{label} rows {same.nonzero().flatten().tolist()}", *rows)


def check_beam_caps(dev, model, model68, tables, parent=None):
    """The beam kernel past beam 8: its cap 16 and the row-tiled kernel at
    32 and BEAM_WIDE, against the twin on the card at Zipformer-30M's
    joiner input (E 256) and 68M's (E 512), with and without the hotword
    table, B 4 T 823 lens BEAM_CAPS_LENS (823, 402, 1 and 0 frames) under
    beam_near_ties' rule, and at B 1 (a streaming session's batch) equal to
    row 0 of the B 4 decode. At E 256 the BEAM_WIDE beams run with the
    joiner's output x AUTO_SHARPEN (fewer near-ties), token-identical, and
    beam 33 without hotwords also on the random joiner under the near-tie
    rule (random weights flip 1-2 tokens there, within the host twin's
    spread; the host twin's runs at beam 128 took over a minute each).
    The tiled kernel at vocab BEAM_V48, where a beam of 64 outnumbers the
    first frames' live candidates, token-identical to the twin; the tiled
    kernel at beams 8 and 16 bit-identical to the caps; then each beam's
    time at B 8 T 823 (E 256, BEAM_LENS_823), around the wrapper and of the
    launch alone (launch_ms), against the twin's and its bound. With a
    parent checkout, cap 16 and the tiled kernel at beams 17, 24 (with
    hotwords) and 32 bit-identical to its kernel in turns (a parent's cap
    32 at beams 17-32). Returns the kernels line's entries, one a beam."""
    import copy

    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search, beam_search_cuda
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import synthetic_hotword_tables

    gen = torch.Generator(device="cpu").manual_seed(6)
    lens = torch.tensor(BEAM_CAPS_LENS, dtype=torch.int32, device=dev)
    host_tables = tables.to("cpu")
    errs = {}
    for m in (model, model68):
        cfg = m.rnnt_cfg
        e = cfg.encoder_out_dim
        host_rnnt = (copy.deepcopy(m.decoder).cpu(), copy.deepcopy(m.joiner).cpu())
        sharp_joiner = copy.deepcopy(m.joiner)
        with torch.no_grad():
            sharp_joiner.output.weight.mul_(AUTO_SHARPEN)
        enc = torch.randn((len(BEAM_CAPS_LENS), 823, e), generator=gen).to(dev)
        for beam in (16, 32, *BEAM_WIDE):
            cap = beam_search_cuda.beam_cap(beam)
            smem = beam_search_cuda._kernel_smem_bytes(823, e, cfg.decoder_dim,
                                                       cfg.joiner_dim, cfg.vocab_size, cap)
            log(f"beam {beam} E {e}: cap {cap}, shared memory a block at T 823 {smem} B "
                f"(limit {beam_search_cuda._smem_limit(cap)} B)")
            # At E 256 the beams past 32 on the sharpened joiner: token-identical;
            # the first also on the random joiner under the near-tie rule.
            cases = [(hw, e == 256 and beam in BEAM_WIDE) for hw in (None, tables)]
            if e == 256 and beam == BEAM_WIDE[0]:
                cases.append((None, False))
            for hw, sharp in cases:
                joiner = sharp_joiner if sharp else m.joiner
                label = (f"beam {beam} E={e}{' hotwords' if hw is not None else ''} T=823"
                         f"{f' joiner x {AUTO_SHARPEN:g}' if sharp else ''}")
                args = (enc, lens, m.decoder, joiner, cfg, beam)
                got = beam_search_cuda.beam_search_batch_cuda(*args, hw_tables=hw)
                ref = beam_search.beam_search_batch(*args, hw_tables=hw)
                if sharp:
                    err = _beam_compare(label, got, ref)
                else:
                    host_hw = None if hw is None else host_tables
                    err = beam_near_ties(label, got, ref, lambda: beam_search.beam_search_batch(
                        enc.cpu(), lens.cpu(), *host_rnnt, cfg, beam, hw_tables=host_hw))
                if e == 256 and hw is None and beam not in errs:
                    errs[beam] = err
                    one = beam_search_cuda.beam_search_batch_cuda(enc[:1], lens[:1], m.decoder,
                                                                  joiner, cfg, beam)
                    torch.cuda.synchronize()
                    assert torch.equal(one.tokens[0], got.tokens[0]) and \
                        torch.equal(one.tok_logp[0], got.tok_logp[0]), f"{label}: B 1 moved"
                    log(f"beam {label}: B 1 equal to row 0 of B {len(BEAM_CAPS_LENS)} "
                        f"({int(one.num_tokens[0])} tokens)")
                del got, ref
        if e != 256:
            continue
        for beam in CAP_BEAMS:  # the tiled kernel at the caps' beams
            args = (enc, lens, m.decoder, m.joiner, cfg, beam, None)
            same = beam_identical(beam_search_cuda._beam_search_cuda(*args),
                                  beam_search_cuda._beam_search_cuda(*args, tiled=True))
            log(f"beam {beam} E={e} T=823: the tiled kernel bit-identical to cap "
                f"{beam_search_cuda.beam_cap(beam)}: {same}")
            assert same, f"beam {beam}: the tiled kernel differs from the cap"
        dec, joi, vcfg = vocab_rnnt(m, dev, BEAM_V48)
        lens64 = torch.tensor(BEAM_LENS_64[:4], dtype=torch.int32, device=dev)
        for beam in BEAM_WIDE:
            for vhw in (None, synthetic_hotword_tables(BEAM_V48, dev)):
                args = (enc[:, :64].contiguous(), lens64, dec, joi, vcfg, beam)
                _beam_compare(f"V={BEAM_V48} beam {beam}{' hotwords' if vhw is not None else ''} "
                              f"T=64", beam_search_cuda.beam_search_batch_cuda(*args, hw_tables=vhw),
                              beam_search.beam_search_batch(*args, hw_tables=vhw))
    cfg = model.rnnt_cfg
    enc = torch.randn((SLICE_BATCH, 823, cfg.encoder_out_dim), generator=gen).to(dev)
    lens = torch.tensor(BEAM_LENS_823, dtype=torch.int32, device=dev)
    longest = int(lens.clamp(0, 823).max())
    out = []
    for beam in (16, 32, *BEAM_WIDE):
        args = (enc, lens, model.decoder, model.joiner, cfg, beam)
        ms = time_ms(lambda: beam_search_cuda.beam_search_batch_cuda(*args), reps=3, warmup=1)
        dev_ms = launch_ms((*args, None))
        plain_ms = time_ms(lambda: beam_search.beam_search_batch(*args), reps=1, warmup=0)
        bnd = beam_bound(*args)
        log(f"beam {beam}: B {SLICE_BATCH} T 823 V {cfg.vocab_size} cap "
            f"{beam_search_cuda.beam_cap(beam)}: kernel {ms:.3f} ms, launch alone (events) "
            f"{dev_ms:.3f} ms ({1e3 * ms / longest:.2f} us a frame over the longest row's "
            f"{longest}), plain {plain_ms:.3f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}) ({card()})")
        if parent is not None and beam in (16, 32):
            beam_ab(f"B 8 T 823 V 2000 beam {beam}", args, None, parent["beam"])
        out.append({"name": f"beam_search_beam{beam}",
                    "source": "sherpa_vietnamese_asr_tpu_torch/csrc/beam_search.cu",
                    "replaces": "sherpa_vietnamese_asr_tpu/ops/beam_search_pallas.py:101",
                    "max_abs_err": errs[beam], "ms": ms, "plain_ms": plain_ms,
                    "library_ms": None, **bnd})
    if parent is not None:  # partial tiles: the parent's cap 32 at 17 and 24 rows
        for beam, hw in ((17, None), (24, tables)):
            beam_ab(f"B 8 T 823 V 2000 beam {beam}{' hotwords' if hw is not None else ''}",
                    (enc, lens, model.decoder, model.joiner, cfg, beam), hw, parent["beam"])
    return out


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


def parent_layer(fn, layer, x, rev, lens):
    """The parent checkout's whole-layer kernel on these inputs, called with
    its own C arguments: this kernel's (through the wrapper), or those of the
    WMMA kernel before the wgmma products (11 pointers, 13 ints and the
    stream: no K-major weights, plan, shadow or SM count)."""
    import ctypes

    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib
    from sherpa_vietnamese_asr_tpu_torch.ops import encoder_layer as el

    cfg = layer.cfg
    flat, w_pos = layer.kernel_layout()
    qd, pd, vd, h = cfg.query_head_dim, cfg.pos_head_dim, cfg.value_head_dim, layer.heads
    poslin = el.poslin_bf16(rev, w_pos, h)
    if len(fn.argtypes) == len(cuda_lib.SIGNATURES["svt_encoder_layer_bf16"]):
        return el._encoder_layer_cuda(el.kernel_operands(layer, flat), x, poslin, lens, h, qd,
                                      pd, vd, entry=fn)
    assert len(fn.argtypes) == 25, "parent layer kernel: unknown C arguments"
    b, tp, d, _, _, _, _, hna, ff1, ff2, ff3 = el.layer_shape(flat, x.shape, h, qd, pd, vd)
    m, bf16 = b * tp, torch.bfloat16

    def ws(cols, dtype=bf16):
        return torch.empty((m, cols), dtype=dtype, device=x.device)

    out = torch.empty_like(x)
    bufs = (ws(h * (2 * qd + pd)), torch.empty((b, h, tp, tp), dtype=bf16, device=x.device),
            ws(max(ff1, ff2, ff3, 3 * hna, 2 * d, h * vd)), ws(max(hna, h * vd, d)),
            ws(max(hna, h * vd)), ws(d, torch.float32))
    lens32 = lens.to(torch.int32).contiguous()
    ptrs = (ctypes.c_void_p * el.N_FLAT)(*[w.data_ptr() for w in flat])
    status = fn(x.data_ptr(), lens32.data_ptr(), poslin.data_ptr(),
                ctypes.cast(ptrs, ctypes.c_void_p), out.data_ptr(),
                *[t.data_ptr() for t in bufs], b, tp, d, h, qd, pd, vd, hna, ff1, ff2, ff3,
                flat[28].shape[0], poslin.shape[1], cuda_lib.stream(x.device))
    cuda_lib.check(status, "parent svt_encoder_layer_bf16")
    return out


def products_library_ms(products, dev):
    """cuBLAS's time for the layer's 20 products, (event ms, device ms from
    torch.profiler): one bf16 torch.matmul each at the product's shape (an
    attend as a batched product of the transposed keys-major weights), on
    uniform random operands. A yardstick only: the port never calls it."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import profile_calls

    pairs = []
    for p in products:
        def operand(*shape):
            return torch.empty(shape, dtype=torch.bfloat16, device=dev).uniform_(-1, 1)

        if p.attend:
            pairs.append((operand(p.batches, p.k, p.m).transpose(1, 2),
                          operand(p.batches, p.k, p.n)))
        else:
            pairs.append((operand(p.m, p.k), operand(p.k, p.n)))
    def run():
        return [torch.matmul(a, b) for a, b in pairs]

    ms = time_ms(run, reps=5, warmup=1)
    busy, _, _ = profile_calls(run, reps=5)
    return ms, busy


def plain_layer_times(layer, x, lens, t):
    """The plain bf16 layer (the "never" route: kernel 2 for its attention
    weights) on the valid t rows of the same inputs: (event ms, device ms,
    kernel 2 launches a call)."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import _pos_emb_on
    from sherpa_vietnamese_asr_tpu_torch.ops import attention
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import profile_calls

    xs = x[:, :t].contiguous()
    pos_emb = _pos_emb_on(t, layer.cfg.pos_dim, x.device)
    pad_mask = torch.arange(t, device=x.device)[None, :] >= lens[:, None]

    def run():
        with torch.no_grad():
            return layer(xs, pos_emb, lens, pad_mask)

    run()
    torch.cuda.synchronize()
    attention.launches = 0
    run()
    per_call = attention.launches
    ms = time_ms(run, reps=5, warmup=1)
    busy, _, _ = profile_calls(run, reps=10)
    return ms, busy, per_call


def check_encoder_layer(dev, model, parent=None, shapes=LAYER_SHAPES,
                        name="encoder_layer_bf16", plain_layer=False):
    """The whole-layer kernel against its twin at every stack shape: batch 8,
    mixed lens (0, 1 and full among them), layer 0 of each stack of the bf16
    random model (Zipformer-30M at LAYER_SHAPES, 68M at LAYER_SHAPES_68M)
    with perturbed biases, norm and bypasses, x ~ N(0, 1) on valid frames
    and zero padding. The twin with each planted fault of layer_faults() must
    fail the same gate. Then, at each shape: the device time of the kernel's
    parts from torch.profiler, the products' TFLOP/s, cuBLAS over the same
    20 products, with plain_layer the plain bf16 layer with kernel 2 at the
    same shape, and with a parent checkout its layer kernel against this one
    in turns (parent, this, this, parent). Returns the kernels line's entry
    for the first shape."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import _padded_rev_pos_emb
    from sherpa_vietnamese_asr_tpu_torch.ops import encoder_layer as el
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import layer_split, profile_calls

    cfg = model.zip_cfg
    gen = torch.Generator(device="cpu").manual_seed(3)
    out, failures = None, []
    for stack, t in shapes:
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
        for fault, (operands, rel) in layer_faults(el, flat).items():
            el.rel_pos_scores = rel
            try:
                fault_errs[fault] = layer_errors(got, twin(operands), lens_list)[:2]
            finally:
                el.rel_pos_scores = rel_pos_scores
        ms = time_ms(lambda: el.encoder_layer(layer, x, rev, lens), reps=5, warmup=1)
        plain_ms = time_ms(twin, reps=3, warmup=1)
        bnd = layer_bound(flat, x, poslin, lens, h, cfg)
        products = el.layer_products(*el.layer_shape(flat, x.shape, h, cfg.query_head_dim,
                                                     cfg.pos_head_dim, cfg.value_head_dim))
        nonlin = el.tile_plan(products[4])
        log(f"{name}: stack {stack} B {SLICE_BATCH} T {t} T_pad {tp} D {d} H {h} "
            f"K {cfg.cnn_module_kernel[stack]} nonlin attend {products[4].n} columns in "
            f"{-(-products[4].n // nonlin.bn)} tile(s) of {nonlin.bn} lens {lens_list} "
            f"max/scale {mx:.3e} mean/scale {mean:.3e} "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})")
        log(f"{name}: stack {stack} planted faults (mean/scale, max/scale): " + ", ".join(
            f"{fault} ({m:.3e}, {hi:.3e})" for fault, (m, hi) in fault_errs.items()))
        busy, per_name, _ = profile_calls(lambda: el.encoder_layer(layer, x, rev, lens), reps=10)
        parts = layer_split(per_name)
        flops = sum(p.flops for p in products)
        lib_ms, lib_device = products_library_ms(products, dev)
        log(f"{name}: stack {stack} device {busy:.4f} ms: " + ", ".join(
            f"{part} {v:.4f} ms" for part, v in parts.items())
            + f"; products {flops / 1e9:.2f} GFLOP at "
            f"{flops / parts['products'] / 1e9:.1f} TFLOP/s; cuBLAS bf16 over the same 20 "
            f"products {lib_ms:.4f} ms ({lib_device:.4f} ms device)")
        if plain_layer:
            p_ms, p_busy, p_k2 = plain_layer_times(layer, x, lens, t)
            log(f"{name}: stack {stack} plain bf16 layer with kernel 2 ({p_k2} launch a "
                f"call) {p_ms:.3f} ms, device {p_busy:.4f} ms; kernel 4 {ms:.3f} ms, device "
                f"{busy:.4f} ms ({card()})")
        if parent is not None:
            ref = parent_layer(parent["layer"], layer, x, rev, lens)
            p_mean, p_max, p_abs = layer_errors(got, ref, lens_list)
            turns = [time_ms(lambda: parent_layer(parent["layer"], layer, x, rev, lens)
                             if who == "parent" else el.encoder_layer(layer, x, rev, lens),
                             reps=5, warmup=1)
                     for who in ("parent", "this", "this", "parent")]
            log(f"encoder_layer A/B stack {stack}: parent {turns[0]:.3f} / {turns[3]:.3f} ms, "
                f"this {turns[1]:.3f} / {turns[2]:.3f} ms (parent, this, this, parent); "
                f"this vs parent max |diff| {p_abs:.3e} (mean/scale {p_mean:.3e}, max/scale "
                f"{p_max:.3e})")
            del ref
        if not (finite and layer_gate(mean, mx)):
            failures.append(f"stack {stack}: kernel vs twin outside the gate")
        failures += [f"stack {stack}: planted fault {fault} passes the gate"
                     for fault, errs in fault_errs.items() if layer_gate(*errs)]
        if out is None:  # the first shape is the one the summary reports
            out = {"name": name,
                   "source": "sherpa_vietnamese_asr_tpu_torch/csrc/encoder_layer.cu",
                   "replaces": "sherpa_vietnamese_asr_tpu/ops/encoder_layer.py:109",
                   "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": None, **bnd}
        del got
    assert not failures, f"{name} parity: " + "; ".join(failures)
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
                tables, parent["beam"])
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
    auto_batch_request(model, paths)
    return launches


def host_words(model, path):
    """The word texts of the same request decoded by a copy of `model` on
    the host CPU (every kernel's twin), at max_batch 8."""
    import copy

    from sherpa_vietnamese_asr_tpu_torch.tools.batch_drift import request_words

    return request_words(copy.deepcopy(model).to("cpu"), path, SLICE_BATCH)


def sharp_copy(model):
    """`model` with its joiner's output weights x AUTO_SHARPEN: the same
    architecture and kernels with fewer near-tied beam steps."""
    import copy

    import torch

    sharp = copy.deepcopy(model)
    with torch.no_grad():
        sharp.joiner.output.weight.mul_(AUTO_SHARPEN)
    return sharp


def auto_batch_request(model, paths):
    """max_batch 0 ("auto") on the card: the size resolved from the free
    memory, every kernel of the path launched at that batch, and the real
    rows' words equal to the max_batch 8 request's. At B 64 the encoder's
    float32 output differs from B 8's in its last bits, with kernel 2 or
    its twin (tools/batch_drift.py), which flips near-tied beam steps of
    random weights, so the request runs `model` with a sharper joiner
    (sharp_copy), and a word may still differ only where the near-tie
    policy of phase 3 (check_beam_e512) lets it: in no more words than the
    same request decoded on the host CPU differs from the card's at
    max_batch 8 (tools/batch_drift.py measures both with the plain random
    joiner)."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline.calibration import hbm_budget_mb
    from sherpa_vietnamese_asr_tpu_torch.tools.batch_drift import encoder_rows_err, word_differ
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import load_audio

    model = sharp_copy(model)
    path = paths["am_tone_95s"]
    ref = TranscriberPipeline(path, model, config={"bypass_vad": True, "max_batch": 8}).run()
    free_mb = hbm_budget_mb(model.device)
    pipe = TranscriberPipeline(path, model, config={"bypass_vad": True, "max_batch": 0})
    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = pipe.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
                "beam_search": beam_search_cuda.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    got, want = ([w[0] for w in _words(r["segments"])] for r in (res, ref))
    differ = word_differ(got, want)
    n, f_err, e_err = encoder_rows_err(model, load_audio(path, SR), pipe.max_batch)
    log(f"slice float32 max_batch 0 (joiner x {AUTO_SHARPEN}): resolved to {pipe.max_batch} "
        f"with {free_mb} MB free on the card; am_tone_95s wall {wall:.3f} s (first run at this batch), launches "
        f"{launches}, words {len(got)}, {differ} differ from max_batch 8's {len(want)}; "
        f"the {n} real rows at B {pipe.max_batch} vs B {SLICE_BATCH}: fbank max |d| "
        f"{f_err:.3e}, encoder output max |d| {e_err:.3e} of the max; peak memory "
        f"{peak:.2f} GiB ({card()})")
    assert all(n > 0 for n in launches.values()), "a kernel never ran at the auto batch"
    if differ:
        spread = word_differ(host_words(model, path), want)
        log(f"slice float32 max_batch 0: the host CPU's words differ from max_batch 8's "
            f"in {spread}")
        assert differ <= spread, "max_batch 0: words beyond the near-tie spread"
    t0 = time.perf_counter()
    pipe.run()
    torch.cuda.synchronize()
    log(f"slice float32 max_batch {pipe.max_batch}: am_tone_95s warm wall "
        f"{time.perf_counter() - t0:.3f} s")


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


def phase_probe():
    """The bf16-band probe path: tools/skew_bf16 at the probe's three stack
    shapes; every kernel within its twin's gate, kernel 5 launched."""
    from sherpa_vietnamese_asr_tpu_torch.ops import attention
    from sherpa_vietnamese_asr_tpu_torch.tools import skew_bf16

    attention.launches = attention.bf16band_launches = 0
    rows = skew_bf16.run(skew_bf16.STACKS)
    launches = {"attention_weights_bf16band": attention.bf16band_launches}
    log(f"probe launches: {launches} (attention kernel {attention.launches})")
    assert all(row["ok"] for row in rows), "probe: a kernel beyond its twin's gate"
    assert all(n > 0 for n in launches.values()), "a kernel never ran in the probe"
    return launches


# ---------------------------------------------------------------- phase 7

VAD_CPU_TOL = 1e-4  # max |card - CPU| of the VAD's probabilities, full float32
DEFAULT_PATH_SECONDS = 100.0


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def default_path_audio():
    """100 s of speech-like audio with silences of 0.5 to 3 s."""
    rng = np.random.default_rng(11)
    x = speechlike(rng, int(DEFAULT_PATH_SECONDS * SR))
    for start, length in ((7.0, 2.0), (23.5, 0.5), (41.0, 3.0), (58.0, 1.0),
                          (77.0, 2.5), (93.0, 1.5)):
        x[int(start * SR): int((start + length) * SR)] = 0.0
    return x


def _words(segments):
    return [(w["text"], round(w["start"], 3), round(w["end"], 3))
            for seg in segments for w in seg.get("raw_words", [])]


def load_checkpoint_dir(model, tmp):
    """Write `model` as a sherpa-onnx directory and load it on the card:
    every tensor must equal the source's, none may stay on the CPU."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import export_asr_dir
    from sherpa_vietnamese_asr_tpu_torch.models.registry import load_asr_model

    model_dir = os.path.join(tmp, "zipformer-30m-rnnt-6000h")
    t0 = time.perf_counter()
    export_asr_dir(model, model_dir)
    t1 = time.perf_counter()
    loaded = load_asr_model(model_dir, beam_size=model.beam_size, device=model.device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n = 0
    for a, b in ((loaded.encoder, model.encoder), (loaded.decoder, model.decoder),
                 (loaded.joiner, model.joiner)):
        sa, sb = a.state_dict(), b.state_dict()
        assert set(sa) == set(sb), "loaded model: keys differ"
        for k in sb:
            assert sa[k].device.type == "cuda", f"{k} left on {sa[k].device}"
            assert torch.equal(sa[k], sb[k]), f"loaded model: {k} differs"
            n += 1
    assert loaded.id2token == model.id2token and loaded.zip_cfg == model.zip_cfg
    log(f"default path: export {t1 - t0:.2f} s, load_asr_model {t2 - t1:.2f} s, "
        f"{n} tensors equal to the source's on {loaded.device}")
    return model_dir


def run_cli(argv):
    """The port's CLI in-process: (exit code, stdout, stderr)."""
    import contextlib
    import io

    from sherpa_vietnamese_asr_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def check_vad(calls):
    """The VAD's probabilities of the CLI run: on the card, L // 512 of
    them, finite, and within VAD_CPU_TOL of the same weights on the CPU."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models import silero_vad

    assert len(calls) == 1, f"the VAD ran {len(calls)} times"
    vad, audio, probs = calls[0]
    assert probs.device.type == "cuda", f"VAD probabilities on {probs.device}"
    assert probs.shape == (len(audio) // 512,), probs.shape
    assert bool(torch.isfinite(probs).all()), "VAD: non-finite probabilities"
    cpu = silero_vad.SileroVad(vad.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in vad.state_dict().items()})
    want = silero_vad.silero_vad_probs_streamed(cpu.to("cpu"), audio)
    err = float((probs.cpu() - want).abs().max())
    above = float((probs > 0.2).float().mean())
    log(f"default path: VAD {probs.shape[0]} windows on {probs.device}, max |card - CPU| "
        f"{err:.3e} (gate {VAD_CPU_TOL}), share above the 0.2 threshold {above:.3f}")
    assert err <= VAD_CPU_TOL, "VAD: card and CPU disagree"


def rover_pair(model, model68, audio):
    """ROVER's decoder on one shared fbank: each model's words equal its
    own single-model decode of the same spans."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline import chunking
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder

    plan = chunking.plan_chunks(len(audio), chunking.find_silent_regions(audio))
    spans = [(s, e) for s, e, _ in plan]
    words_a, words_b = BatchedChunkDecoder(model, model_b=model68).decode_spans(audio, spans)
    for label, m, got in (("30M", model, words_a), ("68M", model68, words_b)):
        want = BatchedChunkDecoder(m).decode_spans(audio, spans)
        same = [[(w["text"], w["start"], w["end"], w["prob"]) for w in a]
                == [(w["text"], w["start"], w["end"], w["prob"]) for w in b]
                for a, b in zip(got, want)]
        log(f"default path: ROVER decoder, {label} words of {len(spans)} chunks equal its "
            f"own decode: {sum(same)} of {len(same)} ({sum(map(len, got))} words)")
        assert all(same) and len(got) == len(want), f"ROVER: the {label} words moved"


def bf16_68m(model68, model68_16, audio, path):
    """One bfloat16 Zipformer-68M request, timed in turns against the same
    request with layer_kernel="never" (every layer the plain bf16 layer with
    kernel 2); then one encoder forward with the counts at 0, under "auto"
    and under "always": kernel 4 on all six stacks (16 layers; stacks 2-4 in
    two column tiles of their nonlin attends), kernel 2 never; cosine
    against the float32 68M encoder. Returns kernel 4's launches in the
    "auto" forward."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import use_layer_kernel
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, encoder_layer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import (
        BatchedChunkDecoder,
        fbank_batch,
    )

    enc16 = model68_16.encoder
    cfg = enc16.cfg
    t_ds = [-(-1646 // ds) for ds in cfg.downsampling_factor]
    kernel_stacks = [i for i in range(6) if use_layer_kernel(cfg, i, t_ds[i], "cuda")]
    assert kernel_stacks == list(range(6)), kernel_stacks

    def request(layer_kernel):
        enc16.cfg = dataclasses.replace(cfg, layer_kernel=layer_kernel)
        try:
            attention.launches = encoder_layer.launches = 0
            t0 = time.perf_counter()
            res = TranscriberPipeline(path, model68_16, config={}).run()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0, res, encoder_layer.launches,
                    attention.launches)
        finally:
            enc16.cfg = cfg

    wall, res, k4, k2 = request("auto")
    log(f"default path: bf16 68M request wall {wall:.3f} s (first), vad "
        f"{res['timing']['vad']:.3f} s, segments {len(res['segments'])}, launches kernel 4 "
        f"{k4} kernel 2 {k2} ({card()})")
    assert res["segments"], "bf16 68M: no words"
    assert k2 == 0 and k4 > 0, "bf16 68M: the request left kernel 4"
    turns = {"auto": [], "never": []}
    for who in ("auto", "never", "never", "auto"):
        wall, res_t, k4, k2 = request(who)
        turns[who].append(wall)
        assert (k4 > 0 and k2 == 0) if who == "auto" else (k4 == 0 and k2 > 0), (who, k4, k2)
        assert res_t["segments"], f"bf16 68M {who}: no words"
    log(f"default path: bf16 68M request wall, in turns (auto, never, never, auto): kernel 4 "
        f"on every layer {turns['auto'][0]:.3f} / {turns['auto'][1]:.3f} s, "
        f'layer_kernel="never" (plain bf16 layers, kernel 2) {turns["never"][0]:.3f} / '
        f"{turns['never'][1]:.3f} s ({card()})")

    spans = [(s, min(s + 30 * SR, len(audio)))
             for s in range(0, len(audio) - 3 * SR, 27 * SR)]
    batch, lens = BatchedChunkDecoder(model68_16)._build_batch(
        audio, spans + [(0, 1)] * (SLICE_BATCH - len(spans)))
    dev = model68_16.device
    layers = cfg.num_encoder_layers
    want = {"kernel 4": sum(layers), "kernel 2": 0}
    with torch.no_grad():
        feats = fbank_batch(torch.from_numpy(batch).to(dev))
        n = torch.from_numpy((lens + 80) // 160).to(dev)
        e32, l32 = model68.encoder(feats, n)
        for layer_kernel in ("auto", "always"):
            enc16.cfg = dataclasses.replace(cfg, layer_kernel=layer_kernel)
            try:
                attention.launches = encoder_layer.launches = 0
                e16, l16 = enc16(feats, n)
                torch.cuda.synchronize()
                per_forward = {"kernel 4": encoder_layer.launches,
                               "kernel 2": attention.launches}
            finally:
                enc16.cfg = cfg
            if layer_kernel == "auto":
                auto_launches = encoder_layer.launches
            cos = [float(torch.nn.functional.cosine_similarity(
                e16[i, :ln].flatten(), e32[i, :ln].flatten(), dim=0))
                for i, ln in enumerate(l32.tolist()[: len(spans)])]
            log(f'default path: bf16 68M forward, layer_kernel="{layer_kernel}": launches '
                f"{per_forward} (kernel 4 on stacks {kernel_stacks}; expected {want}); "
                f"encoder cosine vs float32 {[round(c, 6) for c in cos]}")
            assert per_forward == want, f"bf16 68M {layer_kernel}: a layer left kernel 4"
            assert torch.equal(l16, l32) and min(cos) >= COSINE_GATE, \
                "bf16 68M far from float32"
    return auto_launches


def cli_beams(model, model_dir, path):
    """`cli transcribe --beam N` in-process on the card at 16 (the beam
    kernel's cap past 8) and at 32 and BEAM_WIDE (the row-tiled kernel), from
    the user's entry point. Each writes words, its words equal an in-memory
    pipeline run at that beam, and its launches of the beam kernel (of the
    tiled kernel past the caps) are counted."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search_cuda

    counts = {}
    for beam in (16, 32, *BEAM_WIDE):
        beam_search_cuda.launches = beam_search_cuda.tiled_launches = 0
        t0 = time.perf_counter()
        rc, out, err = run_cli(["transcribe", path, "--model", model_dir, "--beam", str(beam)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[f"beam_search_beam{beam}"] = (
            beam_search_cuda.tiled_launches
            if beam_search_cuda.beam_cap(beam) == beam_search_cuda.TILED
            else beam_search_cuda.launches)
        assert rc == 0, f"cli --beam {beam} exit {rc}: {err[-2000:]}"
        with open(path + ".asr.json", encoding="utf-8") as f:
            data = json.load(f)
        got = [(w["text"], w.get("start"), w.get("end"))
               for seg in data["segments"] for w in seg.get("raw_words", [])]
        saved = model.beam_size
        model.beam_size = beam
        try:
            want = _words(TranscriberPipeline(path, model, config={}).run()["segments"])
        finally:
            model.beam_size = saved
        log(f"default path: cli --beam {beam} wall {wall:.3f} s, {len(got)} words, beam "
            f"launches {counts[f'beam_search_beam{beam}']}, words equal to an in-memory run "
            f"at beam {beam}: {got == want} ({card()})")
        assert data["text"] and got, f"cli --beam {beam}: no words"
        assert got == want, f"cli --beam {beam}: words differ from the in-memory run"
        assert counts[f"beam_search_beam{beam}"] > 0, f"cli --beam {beam}: no beam launch"
    return counts


def resume_twice(model, path):
    """enable_resume: a run stopped after the decode leaves its checkpoint;
    the next run resumes from it, gives the uninterrupted run's text and
    clears it."""
    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline

    ckpt = path + ".asr_ckpt.json"
    config = {"enable_resume": True}
    want = TranscriberPipeline(path, model, config={}).run()["text"]
    first = TranscriberPipeline(path, model, config,
                                cancel_check=lambda: os.path.exists(ckpt)).run()
    assert first is None and os.path.exists(ckpt), "resume: no checkpoint left"
    phases = []
    second = TranscriberPipeline(path, model, config, progress_callback=phases.append).run()
    assert "PHASE:Transcription|Resuming from checkpoint|100" in phases
    assert second["text"] == want and want, "resume: the text moved"
    assert not os.path.exists(ckpt), "resume: checkpoint left after the run"
    log(f"default path: enable_resume stopped after the decode, resumed: text equal "
        f"({len(want.split())} words)")


def phase_default_path(dev, model, model68, model68_16, tmp):
    """The user's default path: checkpoint directory -> CLI transcribe with
    Silero VAD on the card -> .asr.json; ROVER; bf16 68M; resume."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.models import silero_vad
    from sherpa_vietnamese_asr_tpu_torch.models.golden import golden_audio
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    # No Silero checkpoint: the default VAD runs random weights (loud warning).
    os.environ["SVT_MODELS_DIR"] = os.path.join(tmp, "no_models")
    model_dir = load_checkpoint_dir(model, tmp)
    audio = default_path_audio()
    path = os.path.join(tmp, "speech_100s.wav")
    write_wav(path, audio, SR)

    calls = []
    streamed = silero_vad.silero_vad_probs_streamed

    def recording(vad, a, *args, **kw):
        probs = streamed(vad, a, *args, **kw)
        calls.append((vad, np.array(a), probs))
        return probs

    silero_vad.silero_vad_probs_streamed = recording
    try:
        for mod in (fbank, attention, beam_search_cuda):
            mod.launches = 0
        t0 = time.perf_counter()
        rc, out, err = run_cli(["transcribe", path, "--model", model_dir, "-v"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
                    "beam_search": beam_search_cuda.launches}
    finally:
        silero_vad.silero_vad_probs_streamed = streamed
    for line in err.splitlines():
        if not line.startswith("PHASE:"):
            log(f"cli: {line}")
    assert rc == 0, f"cli exit {rc}"
    assert "Silero VAD is running with RANDOM weights" in err, "no random-weight warning"
    phases = [line for line in err.splitlines() if line.startswith("PHASE:")]
    assert "PHASE:VAD|Detecting speech|0" in phases, "the VAD did not run"
    assert not any("VAD failed" in p for p in phases), \
        [p for p in phases if "VAD failed" in p]
    with open(path + ".asr.json", encoding="utf-8") as f:
        data = json.load(f)
    log(f"default path: cli wall {wall:.3f} s (the model loaded from its directory), vad "
        f"{data['timing']['vad']:.3f} s, {[p for p in phases if 'Found' in p]}, "
        f"segments {len(data['segments'])}, launches {launches} ({card()})")
    assert data["text"] == out.strip().splitlines()[0] and data["text"]
    assert all(n > 0 for n in launches.values()), "a kernel never ran on the default path"
    check_vad(calls)

    res = TranscriberPipeline(path, model, config={}).run()
    assert data["text"] == res["text"], "cli and in-memory pipeline: text differs"
    got = [(w["text"], w.get("start"), w.get("end"))
           for seg in data["segments"] for w in seg.get("raw_words", [])]
    assert got == _words(res["segments"]), "cli and in-memory pipeline: words differ"
    t0 = time.perf_counter()  # warm
    res = TranscriberPipeline(path, model, config={}).run()
    torch.cuda.synchronize()
    log(f"default path: float32 30M request, warm, wall {time.perf_counter() - t0:.3f} s, "
        f"vad {res['timing']['vad']:.3f} s, words {len(_words(res['segments']))} ({card()})")

    rover_pair(model, model68, audio)
    t0 = time.perf_counter()
    res = TranscriberPipeline(path, (model, model68), config={}).run()
    torch.cuda.synchronize()
    log(f"default path: ROVER 30M + 68M request wall {time.perf_counter() - t0:.3f} s, "
        f"vad {res['timing']['vad']:.3f} s, words {len(_words(res['segments']))} ({card()})")
    assert res["segments"], "ROVER: no words"

    launches["encoder_layer_bf16_68m"] = bf16_68m(model68, model68_16, audio, path)
    launches.update(cli_beams(model, model_dir, path))
    golden = os.path.join(tmp, "golden_6s.wav")
    write_wav(golden, golden_audio(), SR)
    resume_twice(model, golden)
    return launches


# ---------------------------------------------------------------- phase 8

DIAR_TWIN_SECONDS = 20  # 12 windows: one 16-window superblock
DIAR_CLI_SECONDS = 100
DIAR_LONG_SECONDS = 600  # 592 windows: 10 superblocks of 64
DIAR_ARGMAX_AGREE = 0.999  # share of frames whose powerset argmax agrees, card vs CPU
DIAR_COSINE = 0.9999  # every valid slot's embedding, card vs CPU
# Random PyanNet weights pick one powerset class almost everywhere: the
# twin check adds this to the classifier's bias (silence, the three single
# speakers, the pairs) so that chunks have the clean single-speaker frames
# clustering trains on. Random ResNet34 embeddings lie close together, so
# it clusters with an AHC threshold of half their median distance and
# VBx's fa at DIAR_FA: at the default fa of 0.07 VBx merges them back into
# one speaker, at 1.0 they stay two.
DIAR_SPEAKER_BIAS = (0.0, 2.0, 2.0, -2.0, -2.0, -2.0, -2.0)
DIAR_FA = 1.0


def diarization_audio(seconds, seed=0):
    """Two alternating 'speakers': 3 s tones at 200 Hz and 340 Hz with AM
    at 2 and 3.1 Hz, 1 s gaps, noise at 0.01 (tests/test_golden_aux.py)."""
    t = np.arange(SR * seconds) / SR
    x = np.zeros(SR * seconds, np.float32)
    for k in range(seconds // 4):
        f0, am = (200.0, 2.0) if k % 2 == 0 else (340.0, 3.1)
        s, e = k * 4 * SR, (k * 4 + 3) * SR
        tt = t[s:e]
        x[s:e] = 0.3 * np.sin(2 * np.pi * f0 * tt) * (0.5 + 0.5 * np.sin(2 * np.pi * am * tt))
    x += 0.01 * np.random.default_rng(seed).standard_normal(len(x)).astype(np.float32)
    return x


def diarizer_pair(dev):
    """A full-width PureDiarizer on the card, its weights drawn from a
    torch.Generator seeded 0 (the classifier's bias shifted by
    DIAR_SPEAKER_BIAS), and its twin on the CPU with the same weights."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import PyanNet, random_pyannet
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import (
        ResNetSpeaker,
        random_resnet_speaker,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer

    gen = torch.Generator().manual_seed(0)
    seg = random_pyannet(device=dev, generator=gen)
    emb = random_resnet_speaker(device=dev, generator=gen)
    with torch.no_grad():
        seg.classifier.bias.add_(torch.tensor(DIAR_SPEAKER_BIAS, device=dev))
    twins = []
    for module, cls in ((seg, PyanNet), (emb, ResNetSpeaker)):
        twin = cls(module.cfg)
        twin.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
        twins.append(twin.to("cpu"))
    return (PureDiarizer(seg_model=seg, emb_model=emb, device=dev),
            PureDiarizer(seg_model=twins[0], emb_model=twins[1], device="cpu"))


def recorded_process(diar, audio):
    """(segments, (binarized, embeddings)) of diar.process(audio), keeping
    the fused stage's outputs."""
    kept = []
    fused = diar._segment_and_embed_fused

    def keep(a, cb=None):
        out = fused(a, cb)
        kept.append(out)
        return out

    diar._segment_and_embed_fused = keep
    try:
        segments = diar.process(audio)
    finally:
        del diar._segment_and_embed_fused
    return segments, (kept[0][0], kept[0][2])


def embedding_cosines(emb, ref):
    """Cosine of each slot valid in both, and whether the valid masks agree."""
    valid, valid_ref = ~np.isnan(emb[..., 0]), ~np.isnan(ref[..., 0])
    both = valid & valid_ref
    a, b = emb[both].astype(np.float64), ref[both].astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    return cos, bool((valid == valid_ref).all())


def argmax_margins(diar_cpu, audio, flipped_windows):
    """The CPU twin's margin between its two best powerset classes at the
    frames of the flipped windows where the card chose another class."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_pure as dp

    with torch.no_grad():
        wins = []
        for w in flipped_windows:
            chunk = np.zeros(dp.CHUNK_SAMPLES, np.float32)
            piece = audio[w * dp.STEP_SAMPLES: w * dp.STEP_SAMPLES + dp.CHUNK_SAMPLES]
            chunk[: len(piece)] = np.rint(piece * 32768.0) / 32768.0
            wins.append(chunk)
        logits = diar_cpu.seg_model(torch.from_numpy(np.stack(wins))).numpy()
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def diarization_twin(card_diar, cpu_diar):
    """(a) 20 s on the card against the CPU twin: the powerset argmax, every
    valid slot's embedding, and the final segments where the argmax agrees
    everywhere; then the card with its per-chunk CMVN dropped must fail the
    embedding gate."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_pure as dp

    from scipy.spatial.distance import pdist

    audio = diarization_audio(DIAR_TWIN_SECONDS)
    _, _, emb0 = card_diar._segment_and_embed_fused(audio)
    threshold = float(np.median(pdist(dp.l2_norm(emb0[~np.isnan(emb0[..., 0])])))) / 2
    defaults = card_diar.threshold, card_diar.fa
    for diar in (card_diar, cpu_diar):
        diar.threshold, diar.fa = threshold, DIAR_FA
    try:
        segs_c, (bin_c, emb_c) = recorded_process(card_diar, audio)
        segs_h, (bin_h, emb_h) = recorded_process(cpu_diar, audio)
    finally:
        card_diar.threshold, card_diar.fa = defaults
    frame_agree = (bin_c == bin_h).all(axis=-1)
    agree = float(frame_agree.mean())
    cos, same_valid = embedding_cosines(emb_c, emb_h)
    msg = (f"diarization twin: {bin_c.shape[0]} windows, powerset argmax agrees on "
           f"{agree:.6f} of {frame_agree.size} frames (gate {DIAR_ARGMAX_AGREE}), "
           f"embeddings of {cos.size} valid slots cosine min {cos.min():.8f} "
           f"(gate {DIAR_COSINE}), valid masks equal {same_valid}")
    if agree < 1.0:
        windows = sorted(set(np.argwhere(~frame_agree)[:, 0].tolist()))
        margins = argmax_margins(cpu_diar, audio, windows)
        flipped = margins[~frame_agree[windows]]
        msg += f"; flipped frames' CPU margins {np.round(flipped, 6).tolist()[:12]}"
    log(msg)
    assert agree >= DIAR_ARGMAX_AGREE, "diarization: card and CPU argmax disagree"
    assert same_valid and cos.size and cos.min() >= DIAR_COSINE, \
        "diarization: card and CPU embeddings disagree"
    if agree == 1.0:
        same = len(segs_c) == len(segs_h) and all(
            a["speaker"] == b["speaker"] and abs(a["start"] - b["start"]) <= 1e-6
            and abs(a["end"] - b["end"]) <= 1e-6 for a, b in zip(segs_c, segs_h))
        log(f"diarization twin: AHC threshold {threshold:.6f}, fa {DIAR_FA}, segments card "
            f"{len(segs_c)} "
            f"CPU {len(segs_h)}, speakers {sorted({s['speaker'] for s in segs_c})}, "
            f"identical {same}")
        assert same and segs_c, "diarization: card and CPU segments differ"
        assert len({s["speaker"] for s in segs_c}) >= 2, "diarization twin: one speaker"

    chunk_fbank = dp._chunk_fbank

    def no_cmvn(x, n_windows):
        fb = dp.fbank_ops.compute_fbank(x, dp._SB_FBANK)
        return fb.unfold(0, dp.FRAMES_PER_CHUNK, dp._FB_FRAMES_PER_STEP)[:n_windows] \
            .transpose(1, 2)

    dp._chunk_fbank = no_cmvn
    try:
        _, _, emb_f = card_diar._segment_and_embed_fused(audio)
    finally:
        dp._chunk_fbank = chunk_fbank
    cos_f, _ = embedding_cosines(emb_f, emb_h)
    log(f"diarization twin: planted fault, per-chunk CMVN dropped on the card: cosine "
        f"min {cos_f.min():.6f} median {float(np.median(cos_f)):.6f}")
    assert cos_f.min() < DIAR_COSINE, "diarization: the CMVN fault passes the embedding gate"


def diarization_cli(dev, model, card_diar, tmp):
    """(b) `transcribe <100 s wav> --model <dir> --diarize` in-process, the
    directory written by the port's exporters from `model` and the card
    diarizer's weights; then the facade's background pass on the same file
    must give the synchronous path's speakers."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_diar import (
        export_diarization_files,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import export_asr_dir
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization import SpeakerDiarizer
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    model_dir = os.path.join(tmp, "zipformer-30m-rnnt-6000h")
    export_asr_dir(model, model_dir)
    export_diarization_files(card_diar.seg_model, card_diar.emb_model, model_dir)
    path = os.path.join(tmp, "two_speakers_100s.wav")
    write_wav(path, diarization_audio(DIAR_CLI_SECONDS), SR)
    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0
    t0 = time.perf_counter()
    rc, out, err = run_cli(["transcribe", path, "--model", model_dir, "--diarize", "-v"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
                "beam_search": beam_search_cuda.launches}
    assert rc == 0, f"cli --diarize exit {rc}: {err[-2000:]}"
    assert "RANDOM weights" not in "".join(line for line in err.splitlines()
                                           if "diariz" in line or "embedding" in line), \
        "the diarization models did not load from the directory"
    phases = [line for line in err.splitlines() if line.startswith("PHASE:")]
    assert "PHASE:Diarization|Done|100" in phases, "diarization did not run"
    with open(path + ".asr.json", encoding="utf-8") as f:
        data = json.load(f)
    entries = data["segments"]
    speakers = sorted({e["speaker_id"] for e in entries if e["type"] == "speaker"})
    log(f"diarization cli: wall {wall:.3f} s, diarization {data['timing']['diarization']:.3f} s, "
        f"{len(entries)} entries, speakers {speakers}, launches {launches} ({card()})")
    assert entries and entries[0]["type"] == "speaker", "cli: text before any speaker"
    assert any(e["type"] == "text" and e["text"] for e in entries), "cli: no text"

    config = {"speaker_diarization": True}
    sync = TranscriberPipeline(path, model, config, diarizer=card_diar).run()
    facade = SpeakerDiarizer()
    facade._backend = card_diar
    phases = []
    t0 = time.perf_counter()
    background = TranscriberPipeline(path, model, config, diarizer=facade,
                                     progress_callback=phases.append).run()
    torch.cuda.synchronize()
    assert "PHASE:Transcription|Transcribing (diarization in background)|0" in phases
    assert sync["has_speaker_diarization"] and background["has_speaker_diarization"]
    key = [(s["speaker_id"], round(s["start"], 6), round(s["end"], 6))
           for s in sync["speaker_segments_raw"]]
    got = [(s["speaker_id"], round(s["start"], 6), round(s["end"], 6))
           for s in background["speaker_segments_raw"]]
    log(f"diarization facade: background pass wall {time.perf_counter() - t0:.3f} s, "
        f"{len(got)} speaker segments, equal to the synchronous path's {got == key}")
    assert got == key, "diarization: the background pass gave other speakers"
    assert all(s.get("speaker") for s in background["segments"])
    return launches


def diarization_timing(card_diar):
    """(c) A warm 600 s PureDiarizer.process on the card: wall, device busy,
    and one full superblock's device time by part; (d) kernel 1's launches
    in that process() (one a superblock)."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_pure as dp
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import (
        _profiled_busy,
        diarization_parts,
    )

    audio = diarization_audio(DIAR_LONG_SECONDS)
    card_diar.process(audio)  # warm
    torch.cuda.synchronize()
    fbank.launches = 0
    t0 = time.perf_counter()
    segments = card_diar.process(audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_kernel1 = fbank.launches
    n_windows = len(card_diar._window_starts(len(audio)))
    blocks = -(-n_windows // card_diar.superblock_windows)
    busy, profiled = _profiled_busy(lambda: card_diar.process(audio))
    torch.cuda.reset_peak_memory_stats()
    card_diar.process(audio)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"diarization {DIAR_LONG_SECONDS} s: warm process wall {wall:.3f} s, {n_windows} "
        f"windows in {blocks} "
        f"superblocks, {len(segments)} segments, kernel 1 launches {n_kernel1}; under the "
        f"profiler wall {profiled:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / profiled:.3f}; peak memory {peak:.2f} GiB ({card()})")
    parts = diarization_parts(card_diar, audio)
    k1 = fbank_bound(parts["frames"], dp._SB_FBANK, card_diar.device)
    log(f"diarization superblock ({card_diar.superblock_windows} windows) device ms by part "
        "(CUDA events around back-to-back calls): "
        + ", ".join(f"{name} {ms:.3f}" for name, ms in parts.items() if name != "frames")
        + f"; kernel 1 at F {parts['frames']}: bound {k1['bound_ms']:.4f} ms by {k1['bound_by']}")
    cfg = card_diar.emb_cfg
    flops = resnet_flops(cfg, dp.FRAMES_PER_CHUNK) * card_diar.superblock_windows
    log(f"diarization ResNet34: {flops / 1e12:.3f} TFLOP a superblock, "
        f"{flops / (parts['resnet'] * 1e-3) / 1e12:.1f} TFLOP/s (float32 peak "
        f"{PEAK_FP32 / 1e12:.0f}, bound {flops / PEAK_FP32 * 1e3:.3f} ms)")
    assert segments, "diarization 600 s: no segments"
    assert n_kernel1 == blocks, f"kernel 1 ran {n_kernel1} times for {blocks} superblocks"
    return {"fbank_logmel": n_kernel1}


def resnet_flops(cfg, frames):
    """Operations (2 per multiply-add) of the ResNet34 frame encoder on one
    [frames, num_mels] window."""
    f, t = cfg.num_mels, frames
    total = 2 * 9 * cfg.base_channels * f * t  # conv1, one input channel
    c_in = cfg.base_channels
    for stage, n_blocks in enumerate(cfg.blocks):
        c_out = cfg.base_channels * 2 ** stage
        for b in range(n_blocks):
            if stage > 0 and b == 0:
                f, t = (f - 1) // 2 + 1, (t - 1) // 2 + 1
                total += 2 * c_in * c_out * f * t  # the 1x1 shortcut
            total += 2 * 9 * c_in * c_out * f * t + 2 * 9 * c_out * c_out * f * t
            c_in = c_out
    return total


def phase_diarization(dev, model, tmp):
    """Diarization on the card: (a) against its CPU twin, (b) the CLI with
    --diarize and the facade's background pass, (c) a warm 600 s
    PureDiarizer.process, (d) kernel 1's launches on the diarization path."""
    t0 = time.perf_counter()
    card_diar, cpu_diar = diarizer_pair(dev)
    log(f"diarization: PyanNet + ResNet34 random (torch.Generator seed 0) on {dev} and the "
        f"CPU in {time.perf_counter() - t0:.1f} s")
    diarization_twin(card_diar, cpu_diar)
    cli_launches = diarization_cli(dev, model, card_diar, tmp)
    assert all(n > 0 for n in cli_launches.values()), "a kernel never ran on the CLI path"
    return diarization_timing(card_diar)


# ---------------------------------------------------------------- phase 9

VIBERT_MB, VIBERT_T, VIBERT_W = 32, 128, 64  # one GEC minibatch at the T 128 bucket
VIBERT_LOGIT_GATE = 1e-4  # max |card - CPU| of the logits over the CPU's max |logit|
VIBERT_ARGMAX_AGREE = 0.999  # share of word positions whose label argmax agrees
DNSMOS_GATE = 1e-4  # max |card - CPU| of the raw scores
# Added to the random DNSMOS head's biases: raw scores near 3, where the
# polynomial maps them inside (1, 5) instead of clipping them all to 1.
DNSMOS_HEAD_BIAS = 3.0
GEC_WORDS = 2000
PUNCT_LONG_SECONDS = 600


def syllables(n=400, seed=0):
    """n distinct lower-case syllables: the GEC text's words, each one piece
    of the WordPiece vocab (so the CPU twin runs the T 64 bucket)."""
    rng = np.random.default_rng(seed)
    onsets = ["b", "c", "ch", "d", "g", "h", "k", "kh", "l", "m", "n", "ng", "nh", "ph",
              "qu", "r", "s", "t", "th", "tr", "v", "x"]
    rhymes = ["a", "ai", "an", "ang", "anh", "ao", "e", "em", "en", "i", "inh", "o", "oi",
              "ong", "u", "ua", "uoc", "ung", "uong", "y"]
    out = sorted({o + r for o in onsets for r in rhymes})
    return sorted(rng.choice(out, size=n, replace=False).tolist())


def gec_vocab():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.punctuation import SYNTHETIC_VOCAB

    return list(SYNTHETIC_VOCAB) + syllables()


def vibert_pair(dev):
    """A full-width ViBERT (12 layers, 768 wide, vocab 62,000) on the card,
    its weights drawn from a torch.Generator seeded 0, and its CPU twin."""
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import ViBert, ViBertConfig, random_vibert

    card_model = random_vibert(ViBertConfig(), seed=0, device=dev)
    twin = ViBert(card_model.cfg)
    twin.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    return card_model, twin.to("cpu")


def vibert_inputs():
    """One minibatch: 32 rows of T 128 (rows 1 and 3 ragged, the last a
    padding row), W 64 offsets of 57 words ($START and 56) a row."""
    rng = np.random.default_rng(9)
    ids = rng.integers(5, 62000, (VIBERT_MB, VIBERT_T)).astype(np.int32)
    att = np.ones_like(ids)
    att[1, 90:] = 0
    att[3, 70:] = 0
    att[-1] = 0
    ids[att == 0] = 0
    offs = np.zeros((VIBERT_MB, VIBERT_W), np.int32)
    n_words = np.zeros(VIBERT_MB, np.int64)
    for i in range(VIBERT_MB - 1):
        n = int(att[i].sum())
        pos = np.sort(rng.choice(np.arange(1, n), size=56, replace=False))
        offs[i, 1:57] = pos
        n_words[i] = 57
    return [ids, att, np.zeros_like(ids), offs], n_words


def vibert_forward(model, inputs):
    import torch

    with torch.no_grad():
        out = model(*(torch.from_numpy(a).to(model.device) for a in inputs))
    return [o.float().cpu().numpy() for o in out]


def vibert_gate(got, ref, n_words):
    """(max |d logits| / max |CPU logit|, argmax agreement over word positions)."""
    valid = np.arange(VIBERT_W)[None, :] < n_words[:, None]
    err = max(float(np.abs(g - r).max() / np.abs(r).max()) for g, r in zip(got, ref))
    agree = float((got[0].argmax(-1) == ref[0].argmax(-1))[valid].mean())
    return err, agree


def check_vibert(card_model, twin):
    """(1) The full-width ViBERT on the card against its CPU twin on one
    minibatch; TF32 on, a planted fault, must fail the logits gate; the int8
    tier's argmax against float32's. Returns the minibatch's device ms."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models import vibert as vb
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import event_ms

    inputs, n_words = vibert_inputs()
    t0 = time.perf_counter()
    ref = vibert_forward(twin, inputs)
    cpu_s = time.perf_counter() - t0
    got = vibert_forward(card_model, inputs)
    err, agree = vibert_gate(got, ref, n_words)
    log(f"vibert: 12 x 768, vocab 62000, minibatch {VIBERT_MB} x T {VIBERT_T} W {VIBERT_W}: "
        f"card vs CPU max |d logits| {err:.3e} of the CPU's max (gate {VIBERT_LOGIT_GATE}), "
        f"label argmax agreement {agree:.6f} over {int(n_words.sum())} word positions "
        f"(gate {VIBERT_ARGMAX_AGREE}); CPU twin {cpu_s:.2f} s")
    assert err <= VIBERT_LOGIT_GATE and agree >= VIBERT_ARGMAX_AGREE, \
        "vibert: card and CPU disagree"

    check = vb._check_full_fp32
    vb._check_full_fp32 = lambda: None  # the planted fault: TF32 products
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fault = vibert_forward(card_model, inputs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        vb._check_full_fp32 = check
    f_err, f_agree = vibert_gate(fault, ref, n_words)
    log(f"vibert: planted fault, TF32 products on the card: max |d logits| {f_err:.3e}, "
        f"argmax agreement {f_agree:.6f}")
    assert f_err > VIBERT_LOGIT_GATE, "vibert: the TF32 fault passes the logits gate"

    qmodel = vb.quantize_vibert_int8(card_model)
    q = vibert_forward(qmodel, inputs)
    q_err, q_agree = vibert_gate(q, got, n_words)
    log(f"vibert int8 tier vs float32 on the card: max |d logits| {q_err:.3e} of float32's "
        f"max, label argmax agreement {q_agree:.6f}")
    dev_inputs = [torch.from_numpy(a).to(card_model.device) for a in inputs]
    times = {}
    for name, model in (("float32", card_model), ("int8", qmodel)):
        with torch.no_grad():
            times[name] = event_ms(lambda m=model: m(*dev_inputs))
    del qmodel
    log(f"vibert minibatch {VIBERT_MB} x T {VIBERT_T} device time (CUDA events): float32 "
        f"{times['float32']:.3f} ms, int8 tier {times['int8']:.3f} ms ({card()})")
    return times


def gec_text():
    """~2,000 words from the syllables, with pause hints: mostly 0.05-0.3 s,
    every 9th to 17th word a pause of 1-2 s."""
    rng = np.random.default_rng(4)
    words = rng.choice(syllables(), size=GEC_WORDS).tolist()
    hints = rng.uniform(0.05, 0.3, size=GEC_WORDS)
    hints[np.cumsum(rng.integers(9, 18, size=GEC_WORDS // 9)) % GEC_WORDS] = 1.5
    return " ".join(words), hints.tolist()


def recorded_gec(gec):
    """Wrap gec._run_decode: each call's (label index rows, seconds) kept."""
    calls = []
    run = gec._run_decode

    def recording(inputs, hints_rows=None):
        t0 = time.perf_counter()
        out = run(inputs, hints_rows=hints_rows)
        calls.append((out[1], time.perf_counter() - t0, len(inputs["input_ids"]),
                      inputs["input_ids"].shape[1]))
        return out

    gec._run_decode = recording
    return calls


def check_gec(card_model, twin):
    """(2) GecBert at full width on ~2,000 words with pause hints, card
    against CPU: the restored text equal wherever the label argmax agrees
    everywhere; the warm wall, device time, minibatches, iterations and host
    time."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import GecBert
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import _profiled_busy
    from sherpa_vietnamese_asr_tpu_torch.utils.wordpiece import WordPieceTokenizer

    text, hints = gec_text()
    gecs = [GecBert(m, WordPieceTokenizer(gec_vocab()), confidence=0.3)
            for m in (card_model, twin)]
    records = [recorded_gec(g) for g in gecs]
    t0 = time.perf_counter()
    outs = [g(text, pause_hints=hints)[0] for g in gecs]
    cold = time.perf_counter() - t0
    idx_card, idx_cpu = ([r[0] for r in rec] for rec in records)
    flips = sum(int((np.asarray(a) != np.asarray(b)).sum())
                for a, b in zip(idx_card, idx_cpu) if np.shape(a) == np.shape(b))
    same_calls = len(idx_card) == len(idx_cpu) and all(
        np.shape(a) == np.shape(b) for a, b in zip(idx_card, idx_cpu))
    log(f"gec {GEC_WORDS} words: card and CPU twin in {cold:.2f} s; iterations card "
        f"{len(idx_card)} CPU {len(idx_cpu)}, rows a call {[r[2] for r in records[0]]} at "
        f"T {[r[3] for r in records[0]]}; label argmax flips {flips}; restored texts equal "
        f"{outs[0] == outs[1]}; {outs[0].count('.')} periods, {outs[0].count(',')} commas")
    if same_calls and flips == 0:
        assert outs[0] == outs[1], "gec: the argmax agrees but the texts differ"
    assert outs[0] and outs[0] != text, "gec: nothing restored"

    gec = gecs[0]
    records[0].clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gec(text, pause_hints=hints)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    warm = list(records[0])
    decode_s = sum(r[1] for r in warm)
    minibatches = sum(-(-r[2] // gec.mini_batch_size) for r in warm)
    busy, profiled = _profiled_busy(lambda: gec(text, pause_hints=hints))
    log(f"gec {GEC_WORDS} words warm: wall {wall * 1e3:.1f} ms, {len(warm)} iterations "
        f"({', '.join(f'{r[1] * 1e3:.1f}' for r in warm)} ms each, "
        f"{minibatches} minibatches of {gec.mini_batch_size}), host outside the decode "
        f"{(wall - decode_s) * 1e3:.1f} ms; under the profiler wall {profiled:.1f} ms, "
        f"device busy {busy:.1f} ms ({card()})")


def check_dnsmos(dev):
    """(3) DNSMOS at full width on three 9.01 s windows, card against CPU
    (raw scores within DNSMOS_GATE); a periodic Hann window, a planted
    fault, must fail the gate. Returns the analyzer on the card."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import Dnsmos, random_dnsmos
    from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import DNSMOS_LEN, QualityAnalyzer
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import event_ms

    card_model = random_dnsmos(seed=0, device=dev)
    with torch.no_grad():
        card_model.head.bias.add_(DNSMOS_HEAD_BIAS)
    twin = Dnsmos(card_model.cfg)
    twin.load_state_dict({k: v.cpu() for k, v in card_model.state_dict().items()})
    analyzers = [QualityAnalyzer(model=m) for m in (card_model, twin.to("cpu"))]
    rng = np.random.default_rng(12)
    windows = [speechlike(rng, DNSMOS_LEN) * g for g in (1.0, 0.3, 0.05)]
    got, ref = (a.raw_scores(windows) for a in analyzers)
    err = float(np.abs(got - ref).max())
    window = card_model.window
    card_model.window = torch.hann_window(card_model.cfg.n_fft, periodic=True, device=dev)
    try:
        fault = float(np.abs(analyzers[0].raw_scores(windows) - ref).max())
    finally:
        card_model.window = window
    batch = torch.from_numpy(np.stack(windows)).to(dev)
    with torch.no_grad():
        ms = event_ms(lambda: card_model(batch))
    log(f"dnsmos: 3 x 9.01 s windows, raw scores card vs CPU max |d| {err:.3e} "
        f"(gate {DNSMOS_GATE}); planted fault, periodic Hann: {fault:.3e}; forward "
        f"{ms:.3f} ms of device time (CUDA events) ({card()})")
    assert err <= DNSMOS_GATE, "dnsmos: card and CPU disagree"
    assert fault > DNSMOS_GATE, "dnsmos: the periodic-window fault passes the gate"
    return analyzers[0]


def punct_cli(dev, model, card_vibert, analyzer, tmp):
    """(4) `transcribe <100 s wav> --model <dir> --punctuate --quality
    --diarize` in-process on a directory written by the port's exporters
    (ASR, diarization, vibert-capu.onnx + vocab.txt, sig_bak_ovr.onnx);
    then the same request through TranscriberPipeline, with DNSMOS
    overlapped and synchronous."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_aux import (
        export_dnsmos_file,
        export_vibert_files,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_diar import (
        export_diarization_files,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import export_asr_dir
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import load_dnsmos
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import GecBert
    from sherpa_vietnamese_asr_tpu_torch.pipeline.punctuation import PunctuationRestorer
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav
    from sherpa_vietnamese_asr_tpu_torch.utils.wordpiece import WordPieceTokenizer

    card_diar, _ = diarizer_pair(dev)
    model_dir = os.path.join(tmp, "zipformer-30m-rnnt-6000h")
    t0 = time.perf_counter()
    export_asr_dir(model, model_dir)
    export_diarization_files(card_diar.seg_model, card_diar.emb_model, model_dir)
    export_vibert_files(card_vibert, gec_vocab(), model_dir)
    state, _ = load_dnsmos(export_dnsmos_file(analyzer.model, model_dir))
    assert all(np.array_equal(v, analyzer.model.state_dict()[k].cpu().numpy())
               for k, v in state.items()), "sig_bak_ovr.onnx: tensors differ"
    log(f"punctuation cli: model directory written in {time.perf_counter() - t0:.2f} s")
    path = os.path.join(tmp, "two_speakers_100s.wav")
    write_wav(path, diarization_audio(DIAR_CLI_SECONDS), SR)
    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0
    t0 = time.perf_counter()
    rc, _, err = run_cli(["transcribe", path, "--model", model_dir, "--punctuate", "--quality",
                          "--diarize", "-v"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
                "beam_search": beam_search_cuda.launches}
    assert rc == 0, f"cli --punctuate --quality --diarize exit {rc}: {err[-2000:]}"
    random_lines = [line for line in err.splitlines() if "RANDOM weights" in line]
    assert not any("ViBERT" in line for line in random_lines), \
        "the ViBERT did not load from the directory"
    phases = [line for line in err.splitlines() if line.startswith("PHASE:")]
    for want in ("PHASE:Punctuation|Restoring punctuation|0", "PHASE:Align|Done|100",
                 "PHASE:QualityAnalysis|Done|100", "PHASE:Diarization|Done|100"):
        assert want in phases, f"cli: no {want}"
    with open(path + ".asr.json", encoding="utf-8") as f:
        data = json.load(f)
    entries = data["segments"]
    texts = [e for e in entries if e["type"] == "text"]
    speakers = sorted({e["speaker_id"] for e in entries if e["type"] == "speaker"})
    log(f"punctuation cli: wall {wall:.3f} s (models loaded from the directory), timing "
        f"punctuation {data['timing']['punctuation']:.3f} s alignment "
        f"{data['timing']['alignment']:.3f} s quality {data['timing']['quality']:.3f} s "
        f"diarization {data['timing']['diarization']:.3f} s; {len(texts)} sentences, speakers "
        f"{speakers}, launches {launches} ({card()})")
    assert "quality_info" not in data, "the .asr.json writer wrote quality_info"
    assert entries and entries[0]["type"] == "speaker", "cli: text before any speaker"
    assert texts and any(t["text"].rstrip().endswith((".", "?")) for t in texts), \
        "cli: no punctuated sentence"
    assert all(n > 0 for n in launches.values()), "a kernel never ran on the cli path"

    restorer = PunctuationRestorer(GecBert(card_vibert, WordPieceTokenizer(gec_vocab()),
                                           confidence=0.3), confidence=0.3)
    diar = PureDiarizer(seg_model=card_diar.seg_model, emb_model=card_diar.emb_model,
                        device=dev)
    config = {"speaker_diarization": True, "restore_punctuation": True,
              "quality_analysis": True}
    results, raw = {}, {}
    raw_scores = analyzer.raw_scores
    for overlap in (True, False):
        analyzer.raw_scores = lambda w, o=overlap: raw.setdefault(o, raw_scores(w))
        try:
            results[overlap] = TranscriberPipeline(
                path, model, dict(config, quality_overlap_decode=overlap), diarizer=diar,
                punct_restorer=restorer, quality_analyzer=analyzer).run()
        finally:
            del analyzer.raw_scores
    q = {o: r["quality_info"] for o, r in results.items()}
    log(f"punctuation pipeline: quality_info overlapped {q[True]} "
        f"(background {results[True]['timing']['quality_overlapped']:.3f} s, waited "
        f"{results[True]['timing']['quality']:.3f} s), synchronous {q[False]} "
        f"({results[False]['timing']['quality']:.3f} s); raw scores equal "
        f"{np.array_equal(raw[True], raw[False])}: {raw[True].round(6).tolist()}")
    assert q[True] and q[True] == q[False], "dnsmos: overlapped and synchronous differ"
    assert np.array_equal(raw[True], raw[False]), "dnsmos: overlapped raw scores differ"
    assert results[True]["text"] == results[False]["text"] == data["text"]
    assert all(s.get("speaker") for s in results[True]["segments"])
    return launches, restorer


def punct_long(model, restorer, analyzer, tmp):
    """(5) A warm 600 s request with punctuation and quality: wall time and
    the timing keys."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import am_tone
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    path = os.path.join(tmp, "long_600s.wav")
    write_wav(path, am_tone(PUNCT_LONG_SECONDS, 4), SR)
    config = {"bypass_vad": True, "restore_punctuation": True, "quality_analysis": True}

    def run():
        return TranscriberPipeline(path, model, config, punct_restorer=restorer,
                                   quality_analyzer=analyzer).run()

    run()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timing = {k: round(v, 4) for k, v in res["timing"].items()}
    log(f"punctuation {PUNCT_LONG_SECONDS} s warm: wall {wall:.3f} s, "
        f"{len(res['text'].split())} words in {len(res['segments'])} segments, quality "
        f"{res['quality_info']}, timing {json.dumps(timing)} ({card()})")
    assert res["quality_info"] and res["segments"]


def phase_punctuation(dev, model, tmp):
    """Punctuation and quality on the card: (1) ViBERT, (2) GecBert, (3)
    DNSMOS, each against its CPU twin, (4) the CLI with --punctuate --quality
    --diarize and the pipeline's overlapped DNSMOS, (5) a warm 600 s
    request."""
    t0 = time.perf_counter()
    card_vibert, twin = vibert_pair(dev)
    log(f"punctuation: ViBERT random (torch.Generator seed 0) on {dev} and the CPU in "
        f"{time.perf_counter() - t0:.1f} s")
    check_vibert(card_vibert, twin)
    check_gec(card_vibert, twin)
    del twin
    analyzer = check_dnsmos(dev)
    launches, restorer = punct_cli(dev, model, card_vibert, analyzer, tmp)
    punct_long(model, restorer, analyzer, tmp)
    return launches


# ---------------------------------------------------------------- phase 10

STREAM_SLOTS = 8  # the web service's MultiStreamRecognizer(model, n_streams=8)
STREAM_SECONDS = 20.0
STREAM_PIECE = SR // 10  # 0.1 s pieces, as a websocket client sends them
STREAM_LATE = {5: 20, 6: 40, 7: 60}  # stream -> the tick (0.1 s) it joins at
# max |card - CPU| of a step's encoder output over the CPU's max |.|: both
# full float32, the same gate as the port against JAX on the CPU
# (tests/test_torch_zipformer_streaming.py, where summation order gives ~1e-6).
STREAM_ENC_GATE = 1e-4
SESSION_SECONDS = 60.0
SESSION_PADS = (14.0, 24.0)  # the VAD session's and the online session's decode pads
# The random Silero head sharpened (weight x 100, bias -2): random weights
# give 0.5 on every window, these about 0.12 on silence and 0.8-0.9 on
# speech, so the VAD session starts and ends utterances on the silences.
VAD_HEAD_SCALE, VAD_HEAD_SHIFT = 100.0, -2.0
STEP_REPS = 20


def stream_audio():
    """STREAM_SLOTS streams of STREAM_SECONDS of speech-like audio, each
    with a 1 s silence at its own offset."""
    rng = np.random.default_rng(21)
    out = []
    for i in range(STREAM_SLOTS):
        x = speechlike(rng, int(STREAM_SECONDS * SR))
        x[int((3 + 2 * i) * SR): int((4 + 2 * i) * SR)] = 0.0
        out.append(x)
    return out


def drive_multistream(model, audios):
    """The websocket endpoint's loop on one MultiStreamRecognizer: streams
    0-4 open at once, 5-7 join at STREAM_LATE's ticks; each tick every open
    stream gets its next 0.1 s and every ready slot is stepped. Returns
    (each stream's token ids, each step's (mask, encoder output) on the host,
    the steps' host walls in s)."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import MultiStreamRecognizer

    ms = MultiStreamRecognizer(model, n_streams=STREAM_SLOTS)
    steps, walls, inner = [], [], ms._step

    def recorded(*args):
        out = inner(*args)
        steps.append((args[-1].cpu(), out[4].float().cpu()))
        return out

    ms._step = recorded
    slots, offsets, tick = {}, {}, 0
    while True:
        for i in range(STREAM_SLOTS):
            if i not in slots and STREAM_LATE.get(i, 0) == tick:
                slots[i], offsets[i] = ms.open_stream(), 0
        moved = False
        for i, s in slots.items():
            if offsets[i] < len(audios[i]):
                ms.accept_waveform(s, audios[i][offsets[i]: offsets[i] + STREAM_PIECE])
                offsets[i] += STREAM_PIECE
                moved = True
        while ms.ready_slots():
            t0 = time.perf_counter()
            ms.step()  # ends in the tokens' download
            walls.append(time.perf_counter() - t0)
        tick += 1
        if not moved and len(slots) == STREAM_SLOTS and not ms.ready_slots():
            break
    tokens = [list(ms.tokens[slots[i]]) for i in range(STREAM_SLOTS)]
    for i in range(STREAM_SLOTS):
        assert isinstance(ms.close_stream(slots[i]), str)
    return tokens, steps, walls


def single_stream(model, audio, background=False):
    """One CachedStreamingRecognizer fed 0.1 s pieces: its token ids."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import (
        CachedStreamingRecognizer,
    )

    rec = CachedStreamingRecognizer(model, background=background)
    try:
        for i in range(0, len(audio), STREAM_PIECE):
            rec.accept_waveform(audio[i: i + STREAM_PIECE])
            while rec.is_ready():
                rec.decode()
        return list(rec.tokens)
    finally:
        rec.close()


def token_differ(a, b):
    """Token ids of one list unmatched in the other (difflib)."""
    from sherpa_vietnamese_asr_tpu_torch.tools.batch_drift import word_differ

    return word_differ(list(a), list(b))


def check_stream_fbank(dev, audios):
    """Kernel 1 against its twin at the fused step's shape: 8 windows of
    10,840 samples (frames 0-67 of a slot, snip_edges=False), one launch of
    [8 x 68, 512], under phase 3's fbank gate."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import window_samples

    n = window_samples(32, 3)
    wav = torch.from_numpy(np.stack([a[SR: SR + n] for a in audios])).to(dev)
    frames = fbank._frame_signal(wav, fbank.ASR_FBANK).reshape(-1, 512).contiguous()
    got = fbank.logmel(frames, fbank.ASR_FBANK)
    ref = fbank._logmel_plain(frames, fbank.ASR_FBANK)
    mean, mx = fbank_errors(got, ref)
    ms = time_ms(lambda: fbank.logmel(frames, fbank.ASR_FBANK))
    plain_ms = time_ms(lambda: fbank._logmel_plain(frames, fbank.ASR_FBANK))
    bnd = fbank_bound(frames.shape[0], fbank.ASR_FBANK, dev)
    log(f"stream fbank: F {frames.shape[0]} ([{STREAM_SLOTS}, {n}] windows) kernel vs twin "
        f"mean {mean:.3e} max {mx:.3e}; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}) ({card()})")
    assert frames.shape[0] == STREAM_SLOTS * 68, "the step's frame count"
    assert bool(torch.isfinite(got).all()) and fbank_gate(mean, mx), \
        "stream fbank: kernel vs twin outside the gate"


def session_shapes(cfg, pad_sec):
    """(stack, T, H) of each distinct attention shape of a batch-1 decode
    padded to pad_sec seconds (the sessions' BatchedChunkDecoder)."""
    from sherpa_vietnamese_asr_tpu_torch.utils.fbank_ref import ASR_FBANK, num_frames

    t0 = (num_frames(int(pad_sec * SR), ASR_FBANK) - 7) // 2
    shapes = {}
    for stack, ds in enumerate(cfg.downsampling_factor):
        shapes.setdefault((-(-t0 // ds), cfg.num_heads[stack]), stack)
    return [(stack, t, h) for (t, h), stack in shapes.items()]


def fresh_layer(model, stack):
    """A new ZipformerLayer holding layer 0 of `stack`'s weights: a layer that
    has run kernel 4 keeps its checked kernel operands, which deepcopy
    (perturbed_layer) cannot copy."""
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import ZipformerLayer

    cfg = model.zip_cfg
    layer = ZipformerLayer(cfg.encoder_dim[stack], cfg.ffn_dim[stack], cfg.num_heads[stack],
                           cfg.cnn_module_kernel[stack], cfg, device=model.device)
    layer.load_state_dict(model.encoder.stacks[stack].layers[0].state_dict())
    return layer.eval()


def check_session_shapes(dev, model, model16):
    """Kernels 2, 3 and 4 against their twins under phase 3's gates at the
    shapes the sessions give them at batch 1: every distinct stack shape of
    a 14 s (StreamingSession) and a 24 s (OnlineStreamingSession) decode,
    5/8 of the frames valid; kernel 3 over the encoder's final frames,
    beam 8, the session model's joiner; kernel 4 with layer 0 of each
    stack perturbed (the bf16 tier's sessions)."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import _padded_rev_pos_emb
    from sherpa_vietnamese_asr_tpu_torch.ops import attention
    from sherpa_vietnamese_asr_tpu_torch.ops import encoder_layer as el

    cfg = model.zip_cfg
    gen = torch.Generator(device="cpu").manual_seed(7)
    failures = []
    for pad in SESSION_PADS:
        shapes = session_shapes(cfg, pad)
        for stack, t, h, lens_list, args in attention_inputs(
                dev, model, shapes, lambda t: [(5 * t) // 8]):
            got = attention.attention_weights(*args).float()
            err, sum_err, rel = attention_gate(got, attention.attention_weights_plain(*args),
                                               lens_list)
            log(f"stream attention: {pad:.0f} s pad, stack {stack} B 1 T {t} H {h} lens "
                f"{lens_list} max_abs {err:.3e} key_sum_err {sum_err:.3e} bf16_bound_ratio "
                f"{rel:.4f}")
            if not (err < 2e-2 and sum_err < 2e-2 and rel <= 1.0):
                failures.append(f"kernel 2 at {pad} s stack {stack} T {t}")
        for stack, t, h in shapes:
            layer = perturbed_layer(fresh_layer(model16, stack), gen)
            tp = -(-t // el.R) * el.R
            lens_list = [(5 * t) // 8]
            x = torch.zeros((1, tp, cfg.encoder_dim[stack]))
            x[:, :t] = torch.randn((1, t, cfg.encoder_dim[stack]), generator=gen)
            x = x.to(dev)
            lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
            rev = torch.from_numpy(_padded_rev_pos_emb(t, tp, cfg.pos_dim)).to(dev)
            flat, w_pos = layer.kernel_layout()
            twin = el.encoder_layer_plain(flat, x, el.poslin_bf16(rev, w_pos, h), lens, h,
                                          cfg.query_head_dim, cfg.pos_head_dim,
                                          cfg.value_head_dim)
            mean, mx, _ = layer_errors(el.encoder_layer(layer, x, rev, lens), twin, lens_list)
            log(f"stream encoder_layer: {pad:.0f} s pad, stack {stack} B 1 T {t} T_pad {tp} "
                f"lens {lens_list} max/scale {mx:.3e} mean/scale {mean:.3e}")
            if not layer_gate(mean, mx):
                failures.append(f"kernel 4 at {pad} s stack {stack} T {t}")
        t_out = (shapes[0][1] + 1) // 2
        enc = torch.randn((1, t_out, cfg.output_dim), generator=gen).to(dev)
        lens = torch.tensor([(5 * t_out) // 8], dtype=torch.int32, device=dev)
        _beam_compare(f"{pad:.0f} s pad B 1 T {t_out} lens {lens.tolist()}",
                      *_beam_pair(enc, lens, model.decoder, model.joiner, model.rnnt_cfg))
    assert not failures, "session shapes: " + "; ".join(failures)


def check_multistream(dev, model, cpu_model, audios):
    """MultiStreamRecognizer(n_streams=8) on the card against the same class
    on the CPU (every step's encoder output within STREAM_ENC_GATE, token
    ids equal), and against single-stream recognizers on the card; the
    pipelined and the background recognizer equal. Returns (the kernel
    launches of the card run, its steps)."""
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank

    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0
    t0 = time.perf_counter()
    tokens, steps, walls = drive_multistream(model, audios)
    wall = time.perf_counter() - t0
    launches = {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
                "beam_search": beam_search_cuda.launches}
    log(f"stream multi card: {len(steps)} steps in {wall:.3f} s, step wall median "
        f"{np.median(walls) * 1e3:.3f} ms max {max(walls) * 1e3:.3f} ms, launches {launches}, "
        f"tokens a stream {[len(t) for t in tokens]} ({card()})")
    assert launches["fbank_logmel"] == len(steps), "kernel 1 not launched once a step"
    assert all(tokens), "a stream emitted nothing"
    t0 = time.perf_counter()
    cpu_tokens, cpu_steps, _ = drive_multistream(cpu_model, audios)
    errs = []
    for (mask, enc), (cmask, cenc) in zip(steps, cpu_steps, strict=True):
        assert bool((mask == cmask).all()), "card and CPU stepped other slots"
        errs.append(float((enc - cenc).abs().max() / cenc.abs().max()))
    differ = [token_differ(a, b) for a, b in zip(tokens, cpu_tokens)]
    log(f"stream multi card vs CPU ({time.perf_counter() - t0:.1f} s on the CPU): encoder "
        f"output max |d| over max, per step: max {max(errs):.3e} median "
        f"{np.median(errs):.3e} (gate {STREAM_ENC_GATE}); token ids differing a stream "
        f"{differ} of {[len(t) for t in cpu_tokens]}")
    assert max(errs) <= STREAM_ENC_GATE, "stream: card encoder output vs CPU outside the gate"
    assert not any(differ), "stream: card and CPU token ids differ"
    singles = [single_stream(model, a) for a in audios]
    differ = [token_differ(a, b) for a, b in zip(tokens, singles)]
    background = single_stream(model, audios[0], background=True)
    log(f"stream single vs multi on the card: token ids differing a stream {differ}; "
        f"background vs pipelined {token_differ(background, singles[0])} of {len(singles[0])}")
    assert not any(differ), "stream: multi-stream differs from single-stream"
    assert background == singles[0], "stream: background pump differs from pipelined"
    return launches, steps


def check_multistream_bf16(model16, audios, steps32):
    """The bf16 encoder in the same schedule: each advanced slot's encoder
    output at cosine >= COSINE_GATE against the float32 one."""
    _, steps16, _ = drive_multistream(model16, audios)
    cos = []
    for (mask, enc16), (_, enc32) in zip(steps16, steps32, strict=True):
        for s in np.flatnonzero(mask.numpy()):
            a, b = enc16[s].flatten().double(), enc32[s].flatten().double()
            cos.append(float(a @ b / (a.norm() * b.norm())))
    log(f"stream bf16 vs float32 encoder output: cosine min {min(cos):.5f} median "
        f"{np.median(cos):.5f} over {len(cos)} slot-steps (gate {COSINE_GATE})")
    assert min(cos) >= COSINE_GATE, "stream bf16: encoder cosine under the gate"


def step_numbers(dev, model, n):
    """The fused step at N slots, all ready: warm wall (host clock ending in
    a synchronise), device busy time and operations a step from
    torch.profiler, idle share and the streams it sustains in real time."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.zipformer_streaming import (
        StreamingConfig, init_streaming_state,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import (
        fused_stream_step, window_samples,
    )
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import profile_calls

    scfg = StreamingConfig()
    rng = np.random.default_rng(5)
    state = init_streaming_state(model.zip_cfg, scfg, n, dev)
    ctx = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    wav = torch.from_numpy(np.stack([speechlike(rng, window_samples(32, 3))
                                     for _ in range(n)])).to(dev)
    f0s = torch.full((n,), 3, dtype=torch.int64, device=dev)
    mask = torch.ones((n,), dtype=torch.bool, device=dev)

    def fn():
        return fused_stream_step(model, scfg, state, ctx, wav, f0s, mask)

    for _ in range(3):
        fn()
    walls = []
    for _ in range(STEP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls))
    busy, per_name, counts = profile_calls(fn, reps=10)
    ops = sum(counts.values()) / 10
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"stream step N {n} ({model.zip_cfg.compute_dtype}): wall median {wall:.3f} ms "
        f"(min {min(walls):.3f}), device busy {busy:.4f} ms, {ops:.0f} device operations a "
        f"step, idle share {1 - busy / wall:.3f}, real-time streams {n * 0.64e3 / wall:.1f}; "
        f"top: " + ", ".join(f"{k[:48]} {v:.4f}" for k, v in top) + f" ({card()})")
    return {"n": n, "wall_ms": wall, "busy_ms": busy, "ops": ops}


def session_audio():
    """SESSION_SECONDS of speech-like audio with silences of 0.8 to 3.5 s;
    14 s of speech between 16 s and 30 s (longer than the VAD session's
    12 s maximum)."""
    rng = np.random.default_rng(31)
    x = speechlike(rng, int(SESSION_SECONDS * SR))
    for start, length in ((6.0, 1.5), (14.5, 1.5), (30.0, 2.0), (40.0, 3.5), (52.0, 0.8)):
        x[int(start * SR): int((start + length) * SR)] = 0.0
    return x


def vad_pair(dev):
    """The session's Silero VAD on the card (random_silero_vad seed 0, head
    sharpened) and its CPU copy."""
    import copy

    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.silero_vad import random_silero_vad

    vad = random_silero_vad(seed=0, device=dev)
    with torch.no_grad():
        vad.head.weight.mul_(VAD_HEAD_SCALE)
        vad.head.bias.add_(VAD_HEAD_SHIFT)
    return vad, copy.deepcopy(vad).to("cpu")


def vad_session(model, vad, audio, queue_depth):
    """StreamingSession over 50 ms chunks with a clock of 50 ms a chunk.
    Returns (callbacks, each decode's host wall in s (a decode ends in the
    words' download), the audio decoded for each final)."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming import StreamingSession

    clock = [0.0]
    events, walls, windows = [], [], []
    sess = StreamingSession(model, lambda t, f, ts: events.append((t, f, ts)), vad=vad,
                            clock=lambda: clock[0])
    decode, final_text = sess._decode_utterance, sess._final_text

    def timed(audio_):
        t0 = time.perf_counter()
        text = decode(audio_)
        walls.append(time.perf_counter() - t0)
        return text

    def recorded():
        windows.append(np.concatenate(
            [sess.utterance, np.zeros(int(sess.TAIL_PAD_SEC * SR), np.float32)]))
        return final_text()

    sess._decode_utterance, sess._final_text = timed, recorded
    for i in range(0, len(audio), 800):
        clock[0] += 0.05
        sess.push_chunk(audio[i: i + 800], queue_depth=queue_depth)
    sess.finalize()
    return events, walls, windows


def online_session(model, audio):
    """OnlineStreamingSession over 0.1 s pieces. Returns (callbacks, each
    decode's host wall in s, (window, text) at each utterance end)."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import OnlineStreamingSession

    events, walls, ends = [], [], []
    sess = OnlineStreamingSession(model, lambda t, f, ts: events.append((t, f, ts)))
    rec_decode, finalize = sess.rec.decode, sess._finalize

    def timed():
        t0 = time.perf_counter()
        rec_decode()
        walls.append(time.perf_counter() - t0)

    def recorded():
        ends.append((sess.rec.buffer.copy(), sess.rec.get_result()))
        finalize()

    sess.rec.decode, sess._finalize = timed, recorded
    for i in range(0, len(audio), STREAM_PIECE):
        sess.push_chunk(audio[i: i + STREAM_PIECE])
    sess.finalize()
    return events, walls, ends


def text_of(words):
    return " ".join(w["text"] for w in words).strip().lower()


def twin_text(model, cpu_model, window, pad_sec):
    """The window's text from the card's fbank and encoder (kernels 1 and 2)
    with the beam search's plain twin on the host CPU over their output."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops.beam_search_cuda import beam_search_batch_cuda
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder, fbank_batch

    dec = BatchedChunkDecoder(model, max_batch=1, chunk_pad_sec=pad_sec)
    span = [(0, len(window))]
    audio, lens = dec._build_batch(window, span)
    n_frames = torch.from_numpy((lens + 80) // 160).to(model.device)
    with torch.no_grad():
        enc, enc_lens = model.encoder(fbank_batch(torch.from_numpy(audio).to(model.device)),
                                      n_frames)
        enc, enc_lens = enc.cpu(), enc_lens.cpu()
        res = beam_search_batch_cuda(enc, enc_lens, cpu_model.decoder, cpu_model.joiner,
                                     cpu_model.rnnt_cfg, beam_size=model.beam_size)
    return text_of(dec._words_from_result([(res, enc_lens)], span, cpu_model)[0])


def final_differ(texts, ref_texts):
    """Words of each final text unmatched in the reference's (difflib)."""
    return [token_differ(a.split(), b.split()) for a, b in zip(texts, ref_texts, strict=True)]


def check_sessions(dev, model, cpu_model):
    """StreamingSession (VAD on the card) and OnlineStreamingSession on
    SESSION_SECONDS, each held to the CPU in two ways:
      - the VAD session again wholly on the CPU, with more than 10 chunks
        queued (which skips only its partial decodes): the same finals at
        the same times; the online session's windows at each utterance end
        decoded again on the CPU;
      - each final text equal to the beam search's plain twin on the host
        over the card's encoder output of the same window.
    The full CPU decodes' word differences are counted, not gated: the fp32
    encoder's output on the card (kernel 2's bf16 weights, float32
    position scores) is 2e-4 to 7e-4 of its max from the CPU's, with the
    CPU's kernel 2 numerics too, and that flips near-tied beam steps of
    random weights (kernel 3 and its twin agree on either encoder output,
    PERF.md). Returns the card's launches."""
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder

    audio = session_audio()
    vad, cpu_vad = vad_pair(dev)
    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0
    t0 = time.perf_counter()
    events, walls, windows = vad_session(model, vad, audio, 0)
    wall = time.perf_counter() - t0
    launches = {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
                "beam_search": beam_search_cuda.launches}
    finals = [e for e in events if e[1]]
    texts = [e[0] for e in finals]
    partials = len(events) - len(finals)
    t0 = time.perf_counter()
    cpu_events, _, _ = vad_session(cpu_model, cpu_vad, audio, 11)
    cpu_wall = time.perf_counter() - t0
    twin = final_differ(texts, [twin_text(model, cpu_model, w, 14.0) for w in windows])
    host = final_differ(texts, [e[0] for e in cpu_events])
    log(f"stream VAD session: {SESSION_SECONDS:.0f} s in {wall:.3f} s wall, {partials} "
        f"partials, {len(finals)} finals at {[round(e[2], 2) for e in finals]} s, decode "
        f"wall median {np.median(walls) * 1e3:.3f} ms max {max(walls) * 1e3:.3f} ms over "
        f"{len(walls)} (14 s padded, B 1); words differing a final: {twin} from the beam "
        f"twin over the card's encoder output, {host} from the CPU run ({cpu_wall:.1f} s, "
        f"finals at {[round(e[2], 2) for e in cpu_events]} s) of "
        f"{[len(t.split()) for t in texts]} ({card()})")
    assert finals and partials, "VAD session: no finals or no partials"
    assert [e[1:] for e in finals] == [e[1:] for e in cpu_events], \
        "VAD session: the card's finals come at other times than the CPU's"
    assert not any(twin), "VAD session: a final differs from the twin over the card's encoder"
    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0
    t0 = time.perf_counter()
    events, walls, ends = online_session(model, audio)
    wall = time.perf_counter() - t0
    for key, mod in (("fbank_logmel", fbank), ("attention_weights", attention),
                     ("beam_search", beam_search_cuda)):
        launches[key] += mod.launches
    finals = [e for e in events if e[1]]
    texts = [text for _, text in ends]
    twin = final_differ(texts, [twin_text(model, cpu_model, w, 24.0) for w, _ in ends])
    cpu_dec = BatchedChunkDecoder(cpu_model, max_batch=1, chunk_pad_sec=24.0)
    host = final_differ(texts, [text_of(cpu_dec.decode_spans(w, [(0, len(w))])[0])
                                for w, _ in ends])
    log(f"stream online session: {SESSION_SECONDS:.0f} s in {wall:.3f} s wall, "
        f"{len(events) - len(finals)} partials, {len(finals)} finals at "
        f"{[round(e[2], 2) for e in finals]} s, decode wall median "
        f"{np.median(walls) * 1e3:.3f} ms max {max(walls) * 1e3:.3f} ms over {len(walls)} "
        f"(24 s padded, B 1); words differing at each utterance end: {twin} from the beam "
        f"twin over the card's encoder output, {host} from the CPU's decode of the same "
        f"window, of {[len(t.split()) for t in texts]} ({card()})")
    assert finals, "online session: no finals"
    assert not any(twin), "online session: a final differs from the twin over the card's encoder"
    log(f"stream sessions launches: {launches}")
    assert all(n > 0 for n in launches.values()), "a kernel never ran in the sessions"
    return launches


def phase_streaming(dev, model, model16):
    """Live streaming on the card: kernel 1 at the fused step's shape,
    MultiStreamRecognizer(n_streams=8) against the CPU and against single
    streams, the background pump, a bf16 pass, the step's numbers at N 1
    and 8, and the two live sessions against the CPU."""
    import copy

    t0 = time.perf_counter()
    sharp = sharp_copy(model)
    cpu_model = copy.deepcopy(sharp).to("cpu")
    audios = stream_audio()
    check_stream_fbank(dev, audios)
    launches, steps = check_multistream(dev, sharp, cpu_model, audios)
    check_multistream_bf16(model16, audios, steps)
    check_session_shapes(dev, sharp, model16)
    for n in (1, STREAM_SLOTS):
        step_numbers(dev, sharp, n)
    session_launches = check_sessions(dev, sharp, cpu_model)
    log(f"stream phase {time.perf_counter() - t0:.1f} s")
    return {k: launches[k] + session_launches[k] for k in launches}


# ---------------------------------------------------------------- phase 11

SENKO_SECONDS = 100
SENKO_LONG_SECONDS = 600
SENKO_UMAP_SECONDS = 1260  # over 20 min: the UMAP + HDBSCAN route
CAMPP_BLOCK_WINDOWS = 128
CAMPP_COSINE = 0.99999  # each window's embedding, card vs CPU
SEP_SECONDS = 10
SEP_GATE = 1e-4  # max |card - CPU| of the separated sources over the CPU's max |source|


def senko_models(dev):
    """A full-width PyanNet (classifier bias shifted by DIAR_SPEAKER_BIAS),
    CAM++ and Conv-TasNet, random from one torch.Generator seeded 0, on the
    card, and CPU twins with the same weights. The CAM++ embedding BatchNorm
    is centred on the raw embeddings of diarization_audio(40)'s windows
    (tests/test_torch_senko.py), so that the random model tells the two
    tones apart."""
    import copy

    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.campplus import random_campp
    from sherpa_vietnamese_asr_tpu_torch.models.convtasnet import random_convtasnet
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import random_pyannet
    from sherpa_vietnamese_asr_tpu_torch.ops import fbank

    gen = torch.Generator().manual_seed(0)
    seg = random_pyannet(device=dev, generator=gen)
    campp = random_campp(device=dev, generator=gen)
    ct = random_convtasnet(device=dev, generator=gen)
    with torch.no_grad():
        seg.classifier.bias.add_(torch.tensor(DIAR_SPEAKER_BIAS, device=dev))
        bn = campp.xvector.dense.nonlinear.batchnorm
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
        fb = fbank.compute_fbank(torch.from_numpy(diarization_audio(40)).to(dev),
                                 fbank.CAMPP_FBANK)
        raw = campp(torch.stack([fb[s: s + 150] for s in range(0, fb.shape[0] - 150, 60)]))
        bn.running_mean.copy_(raw.mean(0))
        bn.running_var.copy_(raw.var(0, unbiased=False) + 1e-3)
    return (seg, campp, ct), tuple(copy.deepcopy(m).to("cpu") for m in (seg, campp, ct))


def refuses_tf32(fn):
    """fn() raises while cuDNN's TF32 is on; the flag is put back off."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import use_full_fp32

    torch.backends.cudnn.allow_tf32 = True
    try:
        fn()
    except RuntimeError as e:
        return "TF32" in str(e)
    finally:
        use_full_fp32()
    return False


def campp_flops(cfg, frames):
    """Operations (2 per multiply-add) of CAM++ on one [frames, num_mels]
    window: the FCM convolutions, the TDNN, the dense layers' products
    (the CAM gate once a segment) and the transitions."""
    f, t = cfg.num_mels, frames
    mc = cfg.m_channels
    total = 2 * 9 * mc * f * t                       # head.conv1
    for _ in range(2):                               # layer1, layer2
        f = (f - 1) // 2 + 1
        total += 2 * (9 * mc * mc * f * t) * 4 + 2 * mc * mc * f * t
    f = (f - 1) // 2 + 1
    total += 2 * 9 * mc * mc * f * t                 # head.conv2
    t2 = (t - 1) // 2 + 1
    total += 2 * 5 * mc * f * cfg.init_channels * t2  # TDNN
    c, bn = cfg.init_channels, cfg.bottleneck
    for n_layers in cfg.block_layers:
        for _ in range(n_layers):
            total += 2 * c * bn * t2 + 2 * cfg.kernel * bn * cfg.growth_rate * t2
            c += cfg.growth_rate
        total += 2 * c * (c // 2) * t2
        c //= 2
    return total


def check_campp_block(dev, card_model, cpu_model):
    """CAM++ on one block of CAMPP_BLOCK_WINDOWS 1.5 s windows gathered from
    a [6144, 80] region fbank (campp_window_block), card against the CPU
    twin: every window's cosine >= CAMPP_COSINE; the block's time and device
    time, its operations' rate; the forward refuses to run with TF32 on."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_senko import campp_window_block
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import profile_calls

    audio = speechlike(np.random.default_rng(11), 62 * SR)
    feat = fbank.compute_fbank(torch.from_numpy(audio).to(dev), fbank.CAMPP_FBANK)[:6144]
    starts = torch.linspace(0, feat.shape[0] - 150, CAMPP_BLOCK_WINDOWS).long().to(dev)
    lens = torch.full_like(starts, 150)
    lens[-1] = 97  # one ragged window, zero-padded after its end
    with torch.no_grad():
        got = campp_window_block(card_model, feat, starts, lens, 150).cpu().double()
        ref = campp_window_block(cpu_model, feat.cpu(), starts.cpu(), lens.cpu(), 150).double()
    cos = (got * ref).sum(1) / (got.norm(dim=1) * ref.norm(dim=1))
    err = float((got - ref).abs().max() / ref.abs().max())
    ms = time_ms(lambda: campp_window_block(card_model, feat, starts, lens, 150), reps=5)
    busy, per_name, counts = profile_calls(
        lambda: campp_window_block(card_model, feat, starts, lens, 150), reps=3)
    flops = campp_flops(card_model.cfg, 150) * CAMPP_BLOCK_WINDOWS
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"senko CAM++ block {CAMPP_BLOCK_WINDOWS} x 150 frames: card vs CPU cosine min "
        f"{float(cos.min()):.7f}, max |error| / max |CPU| {err:.2e}; {ms:.3f} ms, device busy "
        f"{busy:.3f} ms, {sum(counts.values()) / 3:.0f} device kernels a block, "
        f"{flops / 1e9:.1f} GFLOP at {flops / (busy * 1e-3) / 1e12:.2f} TFLOP/s (float32 "
        f"bound {flops / PEAK_FP32 * 1e3:.3f} ms); top kernels "
        + ", ".join(f"{k[:50]} {v:.3f}" for k, v in top) + f" ({card()})")
    assert float(cos.min()) >= CAMPP_COSINE, "CAM++ block: card vs CPU below the cosine gate"
    assert refuses_tf32(lambda: card_model(feat[None, :150])), "CAM++ ran with TF32 on"
    return {"ms": ms, "busy": busy}


def check_separation(dev, card_model, cpu_model):
    """Conv-TasNet on SEP_SECONDS of two mixed sources, card against the CPU
    twin within SEP_GATE; its time, device time and kernels a call; the
    forward refuses to run with TF32 on."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import profile_calls

    rng = np.random.default_rng(12)
    mix = speechlike(rng, SEP_SECONDS * SR) + 0.5 * speechlike(rng, SEP_SECONDS * SR)[::-1]
    x = torch.from_numpy(np.ascontiguousarray(mix, np.float32))[None]
    got = card_model(x.to(dev)).cpu()
    ref = cpu_model(x)
    err = float((got - ref).abs().max() / ref.abs().max())
    ms = time_ms(lambda: card_model(x.to(dev)), reps=5)
    busy, per_name, counts = profile_calls(lambda: card_model(x.to(dev)), reps=3)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:4]
    log(f"overlap Conv-TasNet {SEP_SECONDS} s: card vs CPU max |error| / max |CPU| {err:.2e}; "
        f"{ms:.3f} ms, device busy {busy:.3f} ms, {sum(counts.values()) / 3:.0f} device kernels "
        "a call; top kernels " + ", ".join(f"{k[:50]} {v:.3f}" for k, v in top) + f" ({card()})")
    assert got.shape == ref.shape == (1, 2, SEP_SECONDS * SR)
    assert err <= SEP_GATE, "Conv-TasNet: card vs CPU outside the gate"
    assert refuses_tf32(lambda: card_model(x.to(dev))), "Conv-TasNet ran with TF32 on"
    return {"ms": ms, "busy": busy}


def same_segments(got, ref):
    return len(got) == len(ref) and all(
        g["speaker"] == r["speaker"] and abs(g["start"] - r["start"]) <= 1e-6
        and abs(g["end"] - r["end"]) <= 1e-6 for g, r in zip(got, ref))


def check_campp_fbank(dev, diar, audio):
    """Kernel 1 at CAMPP_FBANK on the speech regions of `audio` as the Senko
    VAD finds them: each region's frames against the twin under phase 3's
    gate; the kernel and the twin over all regions, one launch a region,
    against the bound of all their frames."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import fbank

    cfg = fbank.CAMPP_FBANK
    x = torch.from_numpy(audio).to(dev)
    frames = []
    for rs, re_ in diar._pyannote_vad(audio):
        s0, e0 = int(rs * SR), min(int(re_ * SR), len(audio))
        if e0 - s0 >= 400 and fbank.num_frames(e0 - s0, cfg) >= 10:
            frames.append(fbank._frame_signal(x[s0:e0], cfg).reshape(-1, cfg.n_fft).contiguous())
    worst = (0.0, 0.0)
    for fr in frames:
        mean, mx = fbank_errors(fbank.logmel(fr, cfg), fbank._logmel_plain(fr, cfg))
        worst = (max(worst[0], mean), max(worst[1], mx))
    n = sum(fr.shape[0] for fr in frames)
    ms = time_ms(lambda: [fbank.logmel(fr, cfg) for fr in frames])
    plain_ms = time_ms(lambda: [fbank._logmel_plain(fr, cfg) for fr in frames])
    b = fbank_bound(n, cfg, dev)
    log(f"senko kernel 1 at CAMPP_FBANK: {len(frames)} regions, F {n} (largest "
        f"{max(fr.shape[0] for fr in frames)}), vs twin worst mean {worst[0]:.3e} max "
        f"{worst[1]:.3e}; kernel {ms:.4f} ms over the regions, twin {plain_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({card()})")
    assert fbank_gate(*worst), "kernel 1 at CAMPP_FBANK outside the gate"
    return {"name": "fbank_logmel_campp", "route": "cuda",
            "source": "sherpa_vietnamese_asr_tpu_torch/csrc/fbank_logmel.cu",
            "replaces": "sherpa_vietnamese_asr_tpu/ops/fbank.py:149", "max_abs_err": worst[1],
            "ms": ms, "plain_ms": plain_ms, "library_ms": None, **b}


def senko_requests(dev, model, card_models, cpu_models, tmp):
    """Senko diarization on the card: (a) 100 s, the card's segments equal
    to the CPU twin's; (b) a 600 s TranscriberPipeline request with the
    Senko facade (the launch counts zeroed just before, read just after),
    and a warm SenkoCamppDiarizer.process alone: wall, device busy, idle
    share, kernel 1 once a speech region; (c) the over-20-min route
    (UMAP + HDBSCAN) on 1,260 s with the native clusterkit loaded."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization import SpeakerDiarizer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_senko import SenkoCamppDiarizer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import _profiled_busy
    from sherpa_vietnamese_asr_tpu_torch.utils import native
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    card_diar = SenkoCamppDiarizer(seg_model=card_models[0], campp_model=card_models[1],
                                   device=dev)
    cpu_diar = SenkoCamppDiarizer(seg_model=cpu_models[0], campp_model=cpu_models[1],
                                  device="cpu")
    audio = diarization_audio(SENKO_SECONDS)
    t0 = time.perf_counter()
    got = card_diar.process(audio)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = cpu_diar.process(audio)
    t_cpu = time.perf_counter() - t0
    log(f"senko {SENKO_SECONDS} s: card {len(got)} segments, {len({s['speaker'] for s in got})} "
        f"speakers in {t_card:.3f} s (cold), CPU twin {len(ref)} segments in {t_cpu:.3f} s; "
        f"equal: {same_segments(got, ref)}")
    assert same_segments(got, ref), "senko 100 s: card segments differ from the CPU twin's"

    long_audio = diarization_audio(SENKO_LONG_SECONDS)
    kernel1 = check_campp_fbank(dev, card_diar, long_audio)
    path = os.path.join(tmp, "senko600.wav")
    write_wav(path, long_audio, SR)
    facade = SpeakerDiarizer("senko_campp")
    facade._backend = card_diar
    config = {"bypass_vad": True, "speaker_diarization": True, "speaker_model": "senko_campp"}
    TranscriberPipeline(path, model, config, diarizer=facade).run()  # warm
    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0
    t0 = time.perf_counter()
    res = TranscriberPipeline(path, model, config, diarizer=facade).run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
                "beam_search": beam_search_cuda.launches}
    log(f"senko {SENKO_LONG_SECONDS} s request (random Zipformer-30M, Senko in the "
        f"background): wall {wall:.3f} s, timing diarization {res['timing']['diarization']:.3f} "
        f"s transcription {res['timing']['transcription']:.3f} s, "
        f"{len(res['speaker_segments_raw'])} speaker segments, launches {launches} ({card()})")
    assert res["has_speaker_diarization"] and all(n > 0 for n in launches.values())

    fbank.launches = 0
    t0 = time.perf_counter()
    segments = card_diar.process(long_audio)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel1["launches"] = fbank.launches
    n_regions = len(card_diar._pyannote_vad(long_audio))
    busy, profiled = _profiled_busy(lambda: card_diar.process(long_audio))
    log(f"senko {SENKO_LONG_SECONDS} s process: warm wall {wall:.3f} s, {len(segments)} "
        f"segments, {n_regions} speech regions, kernel 1 launches {kernel1['launches']}; under "
        f"the profiler wall {profiled:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / profiled:.3f} ({card()})")
    assert segments and 0 < kernel1["launches"] <= n_regions

    umap_audio = diarization_audio(SENKO_UMAP_SECONDS)
    assert native.get_clusterkit() is not None, "the native clusterkit did not build"
    t0 = time.perf_counter()
    segments = card_diar.process(umap_audio)
    wall = time.perf_counter() - t0
    log(f"senko {SENKO_UMAP_SECONDS} s process (UMAP + HDBSCAN on {native.library_path()}): "
        f"wall {wall:.3f} s, {len(segments)} segments, "
        f"{len({s['speaker'] for s in segments})} speakers ({card()})")
    assert segments, "senko 1260 s: no segments"
    return kernel1, launches, got


def overlap_audio(seconds=24):
    """Speaker 0 an AM tone at 220 Hz, speaker 1 800 Hz with 1 kHz, both
    in the overlaps, noise at 0.01 (tests/test_torch_overlap.py)."""
    t = np.arange(SR * seconds) / SR
    s0 = 0.3 * np.sin(2 * np.pi * 220 * t) * (0.6 + 0.4 * np.sin(2 * np.pi * 2.0 * t))
    s1 = 0.2 * np.sin(2 * np.pi * 800 * t) + 0.1 * np.sin(2 * np.pi * 1000 * t)
    on0, on1 = np.zeros_like(t), np.zeros_like(t)
    for a, b in ((0, 6), (8, 14), (17, 20)):
        on0[int(a * SR): int(b * SR)] = 1
    for a, b in ((5, 8), (12.5, 16), (19, 24)):
        on1[int(a * SR): int(b * SR)] = 1
    x = s0 * on0 + s1 * on1 + 0.01 * np.random.default_rng(0).standard_normal(len(t))
    return x.astype(np.float32)


OVERLAP_SEGMENTS = [  # (start, end, speaker): tests/test_torch_overlap.py's
    (0.0, 5.0, 0), (4.5, 6.0, 0), (5.0, 8.0, 1), (6.2, 8.0, 1), (8.0, 12.5, 0), (12.0, 14.0, 0),
    (12.5, 16.0, 1), (15.0, 15.6, 2), (15.5, 16.5, 0), (17.0, 19.0, 0), (18.5, 20.0, 0),
    (19.0, 24.0, 1), (20.5, 24.0, 1)]
OVERLAP_REGIONS = [(5.0, 6.0), (12.5, 14.0), (15.2, 15.5), (15.0, 16.0), (19.0, 20.0)]


def overlap_requests(dev, model, card_models, senko_segments, tmp):
    """Overlap separation on the card: (a) one _run_overlap_separation on
    planted 2-speaker segments and regions (the launch counts zeroed just
    before, read just after): three regions separated, each stream
    re-decoded through kernels 1-3; kernel 1 at the ASR config on an
    embedding's frames against its twin; a re-decode of two streams timed;
    (b) TranscriberPipeline with Senko diarization and overlap_separation on
    100 s, through a facade that reports a region at the card's last
    speaker change of the 100 s run."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_post as dp
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization import SpeakerDiarizer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_senko import SenkoCamppDiarizer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.overlap import OverlapSeparator
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    seg_model, campp, ct = card_models
    sep = OverlapSeparator(convtasnet=ct, campp=campp, device=dev)

    class Planted:
        overlap_regions = OVERLAP_REGIONS

    audio = overlap_audio()
    path = os.path.join(tmp, "overlap.wav")
    write_wav(path, audio, SR)
    pipe = TranscriberPipeline(path, model, {"speaker_diarization": True,
                                             "overlap_separation": True,
                                             "_overlap_separator": sep}, diarizer=Planted())
    segs = [dp.Segment(s, e, k) for s, e, k in OVERLAP_SEGMENTS]
    pipe._run_overlap_separation(audio, segs, {})  # warm
    separated = sep.process(audio, [{"start": s.start, "end": s.end, "speaker": s.speaker}
                                    for s in segs], OVERLAP_REGIONS)
    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0
    timing = {}
    t0 = time.perf_counter()
    ov = pipe._run_overlap_separation(audio, segs, timing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
                "beam_search": beam_search_cuda.launches}
    streams = [a for reg in separated for a in reg["audio_per_speaker"].values()]
    decoder = BatchedChunkDecoder(model, max_batch=8)
    t0 = time.perf_counter()
    for a in streams[:2]:
        decoder.decode_spans(a, [(0, len(a))])
    torch.cuda.synchronize()
    reasr = time.perf_counter() - t0
    log(f"overlap _run_overlap_separation: {len(separated)} regions separated, {len(ov)} "
        f"parallel segments, wall {wall:.3f} s (timing {timing['overlap_separation']:.3f} s); "
        f"re-decode of two streams ({len(streams[0]) / SR:.2f} s, {len(streams[1]) / SR:.2f} s) "
        f"{reasr:.3f} s; launches {launches} ({card()})")
    assert len(separated) == 3, "overlap: the planted regions were not separated"
    assert all(n > 0 for n in launches.values()), "a kernel never ran on the overlap path"

    cfg = fbank.ASR_FBANK
    clip = torch.from_numpy(audio[: 10 * SR]).to(dev)
    frames = fbank._frame_signal(clip, cfg).reshape(-1, cfg.n_fft).contiguous()
    mean, mx = fbank_errors(fbank.logmel(frames, cfg), fbank._logmel_plain(frames, cfg))
    ms = time_ms(lambda: fbank.logmel(frames, cfg))
    plain_ms = time_ms(lambda: fbank._logmel_plain(frames, cfg))
    b = fbank_bound(frames.shape[0], cfg, dev)
    log(f"overlap kernel 1 at ASR_FBANK on a 10 s embedding clip: F {frames.shape[0]} vs twin "
        f"mean {mean:.3e} max {mx:.3e}; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
        f"{b['bound_ms']:.5f} ms by {b['bound_by']}")
    assert fbank_gate(mean, mx), "kernel 1 at the overlap's shape outside the gate"
    kernel1 = {"name": "fbank_logmel_overlap", "route": "cuda",
               "source": "sherpa_vietnamese_asr_tpu_torch/csrc/fbank_logmel.cu",
               "replaces": "sherpa_vietnamese_asr_tpu/ops/fbank.py:149", "max_abs_err": mx,
               "ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "launches": launches["fbank_logmel"], **b}

    changes = [nxt["start"] for seg, nxt in zip(senko_segments, senko_segments[1:])
               if seg["speaker"] != nxt["speaker"]]
    mid = changes[len(changes) // 2] if changes else 11.0
    region = (mid - 1.0, mid + 1.0)

    class PlantedFacade(SpeakerDiarizer):
        @property
        def overlap_regions(self):
            return [region]

    facade = PlantedFacade("senko_campp")
    facade._backend = SenkoCamppDiarizer(seg_model=seg_model, campp_model=campp, device=dev)
    path = os.path.join(tmp, "senko_overlap.wav")
    write_wav(path, diarization_audio(SENKO_SECONDS), SR)
    phases = []
    t0 = time.perf_counter()
    res = TranscriberPipeline(path, model, {"bypass_vad": True, "speaker_diarization": True,
                                            "speaker_model": "senko_campp",
                                            "overlap_separation": True,
                                            "_overlap_separator": sep},
                              diarizer=facade, progress_callback=phases.append).run()
    wall = time.perf_counter() - t0
    log(f"overlap pipeline {SENKO_SECONDS} s (Senko + overlap_separation, region "
        f"{region[0]:.2f}-{region[1]:.2f} s): wall {wall:.3f} s, "
        f"{len(res['overlap_segments'])} overlap segments, timing diarization (overlap "
        f"separation included) {res['timing']['diarization']:.3f} s ({card()})")
    assert any(p.startswith("PHASE:OverlapSep|Done") for p in phases), "overlap stage did not run"
    return kernel1, launches


def phase_senko_overlap(dev, model, tmp):
    """Senko diarization and overlap separation on the card at full width:
    CAM++ and Conv-TasNet against their CPU twins, kernel 1 at CAMPP_FBANK,
    Senko requests (100 s against the CPU, 600 s, the 1,260 s UMAP route)
    and the overlap stage with its re-decodes. Returns the two kernel 1
    entries of the kernels line and each path's launches."""
    t0 = time.perf_counter()
    card_models, cpu_models = senko_models(dev)
    log(f"senko: PyanNet, CAM++ and Conv-TasNet random (torch.Generator seed 0) on {dev} and "
        f"the CPU in {time.perf_counter() - t0:.1f} s")
    check_campp_block(dev, card_models[1], cpu_models[1])
    check_separation(dev, card_models[2], cpu_models[2])
    senko_k1, senko_launches, segments = senko_requests(dev, model, card_models, cpu_models,
                                                        tmp)
    overlap_k1, overlap_launches = overlap_requests(dev, model, card_models, segments, tmp)
    log(f"senko and overlap phase {time.perf_counter() - t0:.1f} s")
    return [senko_k1, overlap_k1], senko_launches, overlap_launches


# ---------------------------------------------------------------- phase 12

# TinyLlama-1.1B-Chat-v1.0's published config, the shapes config_from_gguf
# reads for the llama architecture.
TINYLLAMA = dict(vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
                 ffn_dim=5632, rope_base=10000.0, rms_eps=1e-5, max_seq=2048)
LLAMA_LOGIT_GATE = 1e-4  # max |card - CPU| of the logits over the CPU's max |logit|
LLAMA_PROMPT = 64
LLAMA_GREEDY = 32  # CPU greedy steps (4.1 GB of weights read a step on the host)
LLAMA_TIE = 1e-3  # a CPU step whose top-2 logits are closer than this is a near-tie
LLAMA_STEP_REPS = 20
GGUF_LAYERS = 2
SUMMARY_TOKENS = 48  # the summarizer's local generation, card against CPU
SERVE_SECONDS = 100.0
WS_SECONDS = 20.0
SERVE_CONFIG = {"speaker_diarization": False, "punctuation_confidence": 1}  # VAD on


def llama_cfg(**kw):
    from sherpa_vietnamese_asr_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(**{**TINYLLAMA, **kw})


def llama_bytes(model):
    """Bytes a decode step must read: every weight once (the tied output
    reads tok_emb whole; the embedding's one row is not counted apart)."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def greedy_margins(model, prompt, n):
    """generate()'s greedy loop (its prompt truncation too) with each step's
    top-2 logit margin."""
    import torch

    s_max = model.cfg.max_seq
    if len(prompt) + n > s_max:
        prompt = prompt[-(s_max - n):]
    logits, cache = model.prefill(prompt)
    tokens, margins, pos = [], [], len(prompt)
    for _ in range(n):
        top = torch.topk(logits, 2).values
        margins.append(float(top[0] - top[1]))
        tokens.append(int(torch.argmax(logits)))
        logits = model.step(cache, pos, tokens[-1])
        pos += 1
    return tokens, margins


def tie_compare(label, got, ref, margins):
    """Tokens must be equal up to the first CPU step with a top-2 margin under
    LLAMA_TIE; differences after it are counted. Returns that step or None."""
    tie = next((i for i, m in enumerate(margins) if m < LLAMA_TIE), None)
    upto = len(ref) if tie is None else tie
    assert got[:upto] == ref[:upto], \
        f"{label}: greedy tokens differ before the first near-tie ({got} vs {ref})"
    after = sum(a != b for a, b in zip(got[upto:], ref[upto:]))
    log(f"{label}: greedy tokens equal over {upto} of {len(ref)} steps; first near-tie "
        f"{tie} (min margin {min(margins):.3e}); {after} differ after it")
    return tie


def check_llama(dev):
    """(a) A TinyLlama-width Llama (random, torch.Generator seeded 0) on the
    card against its CPU twin: logits of a 64-token prompt, greedy tokens,
    TF32 refused; prefill, step and tokens/s against the step's bound."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.llama import Llama, generate, random_llama
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import use_full_fp32
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import profile_calls

    cfg = llama_cfg()
    t0 = time.perf_counter()
    twin = random_llama(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    t1 = time.perf_counter()
    model = Llama(cfg, device=dev)
    model.load_state_dict(twin.state_dict())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = llama_bytes(model)
    log(f"llama: TinyLlama-1.1B widths, {n_params / 1e9:.4f} B parameters, "
        f"{weight_bytes / 1e9:.3f} GB float32; random init {t1 - t0:.1f} s, upload "
        f"{time.perf_counter() - t1:.1f} s")
    prompt = np.random.default_rng(3).integers(3, cfg.vocab_size, LLAMA_PROMPT)

    ref = twin(prompt)
    got = model(prompt).cpu()
    err = float((got - ref).abs().max()) / float(ref.abs().max())
    log(f"llama: logits of a {LLAMA_PROMPT}-token prompt, max |card - CPU| {err:.3e} of "
        f"max |logit| {float(ref.abs().max()):.3f} (gate {LLAMA_LOGIT_GATE})")
    assert err <= LLAMA_LOGIT_GATE, f"llama logits {err:.3e} over the gate"

    t0 = time.perf_counter()
    ref_tokens, margins = greedy_margins(twin, prompt, LLAMA_GREEDY)
    cpu_s = time.perf_counter() - t0
    card_tokens = generate(model, prompt, max_new_tokens=LLAMA_GREEDY)
    log(f"llama: CPU greedy {LLAMA_GREEDY} tokens in {cpu_s:.1f} s")
    tie_compare("llama", card_tokens, ref_tokens, margins)
    del twin

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        model(prompt)
        raise AssertionError("llama: ran with TF32 on")
    except RuntimeError as e:
        assert "TF32" in str(e), e
    finally:
        use_full_fp32()
    log("llama: refused to run with TF32 on")

    def sync_ms(fn, reps):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return float(np.median(out))

    full = np.random.default_rng(4).integers(3, cfg.vocab_size, cfg.max_seq)
    model.prefill(full[:LLAMA_PROMPT])
    model.prefill(full)
    prefill_64 = sync_ms(lambda: model.prefill(full[:LLAMA_PROMPT]), 5)
    prefill_full = sync_ms(lambda: model.prefill(full), 3)
    _, cache = model.prefill(full[:LLAMA_PROMPT])
    pos, tok = LLAMA_PROMPT, int(full[LLAMA_PROMPT])
    step = sync_ms(lambda: model.step(cache, pos, tok), LLAMA_STEP_REPS)
    busy, per_name, counts = profile_calls(lambda: model.step(cache, pos, tok), reps=10)
    ops = sum(counts.values()) / 10
    bound_ms = weight_bytes / PEAK_BYTES * 1e3
    # the layers' products at every position, the logits at the last one, and
    # q.k and attn.v over the whole T x T square (the port masks, not skips)
    flops_full = (2 * cfg.max_seq * (n_params - cfg.vocab_size * cfg.dim)
                  + 2 * cfg.dim * cfg.vocab_size + 4 * cfg.n_layers * cfg.max_seq ** 2 * cfg.dim)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:3]
    log(f"llama: prefill {LLAMA_PROMPT} positions {prefill_64:.2f} ms, {cfg.max_seq} "
        f"positions {prefill_full:.2f} ms ({flops_full / 1e12:.2f} TFLOP, "
        f"{flops_full / prefill_full / 1e9:.1f} TFLOP/s); step wall {step:.3f} ms, device "
        f"busy {busy:.3f} ms, {ops:.0f} device operations, idle share {1 - busy / step:.3f}, "
        f"{1e3 / step:.1f} tokens/s; step bound {bound_ms:.3f} ms (weights read once at "
        f"3.35 TB/s), step device time {busy / bound_ms:.2f}x the bound; top: "
        + ", ".join(f"{k[:40]} {v:.3f}" for k, v in top) + f" ({card()})")
    del model, cache
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_64, "prefill_full_ms": prefill_full, "step_ms": step,
            "step_busy_ms": busy, "bound_ms": bound_ms}


def gguf_vocab(n):
    """A sentencepiece-style vocabulary of n pieces, as tests/test_llama_gguf.py
    builds one: specials, the 256 byte pieces, a few words, then fillers."""
    vocab = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)]
    vocab += ["▁xin", "▁chao", "▁viet", "▁nam", "▁hom", "▁nay", "▁the", "▁a"]
    vocab += [f"<extra_{i}>" for i in range(len(vocab), n)]
    return vocab


def write_llama_gguf(path, n_layers):
    """A GGUF at TinyLlama's widths with n_layers layers, every matrix Q8_0,
    written by the port's writer from a random Llama (seed 1)."""
    from sherpa_vietnamese_asr_tpu_torch.models import gguf
    from sherpa_vietnamese_asr_tpu_torch.models.llama import random_llama

    cfg = llama_cfg(n_layers=n_layers)
    src = random_llama(cfg, seed=1, device="cpu")
    names = {"attn_norm": "attn_norm", "ffn_norm": "ffn_norm", "wq": "attn_q",
             "wk": "attn_k", "wv": "attn_v", "wo": "attn_output", "w_gate": "ffn_gate",
             "w_up": "ffn_up", "w_down": "ffn_down"}
    t = {"token_embd.weight": src.tok_emb.numpy(), "output_norm.weight": src.out_norm.numpy()}
    for i, lp in enumerate(src.layers):
        for attr, name in names.items():
            w = getattr(lp, attr).numpy()
            t[f"blk.{i}.{name}.weight"] = w.T if w.ndim == 2 else w  # ggml [out, in]
    vocab = gguf_vocab(cfg.vocab_size)
    meta = {"general.architecture": "llama", "general.alignment": 32,
            "llama.embedding_length": cfg.dim, "llama.block_count": n_layers,
            "llama.attention.head_count": cfg.n_heads,
            "llama.attention.head_count_kv": cfg.n_kv_heads,
            "llama.feed_forward_length": cfg.ffn_dim, "llama.context_length": cfg.max_seq,
            "llama.rope.freq_base": cfg.rope_base,
            "llama.attention.layer_norm_rms_epsilon": cfg.rms_eps,
            "tokenizer.ggml.tokens": vocab,
            "tokenizer.ggml.scores": [float(-i) for i in range(len(vocab))],
            "tokenizer.ggml.token_type": [2, 3, 3] + [6] * 256 + [1] * (len(vocab) - 259),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}
    gguf.write_gguf(path, meta, t, quant_types={k: gguf.GGML_Q8_0 for k, v in t.items()
                                                 if v.ndim == 2})
    return cfg


def check_gguf(dev, tmp):
    """(b) The Q8_0 GGUF onto the card (every tensor the dequantised numpy
    one's) and the local summarizer generating there, equal to the CPU's."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models import gguf
    from sherpa_vietnamese_asr_tpu_torch.models.llama import (
        generate,
        gguf_params,
        load_gguf_llama,
    )
    from sherpa_vietnamese_asr_tpu_torch.web_service import summarizer as sm

    path = os.path.join(tmp, "tinyllama-2layer-q8_0.gguf")
    t0 = time.perf_counter()
    cfg = write_llama_gguf(path, GGUF_LAYERS)
    t1 = time.perf_counter()
    model, lcfg, tok, meta = load_gguf_llama(path, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # the file keeps the RMS epsilon as float32
    assert dataclasses.replace(lcfg, rms_eps=cfg.rms_eps) == cfg, lcfg
    assert abs(lcfg.rms_eps - cfg.rms_eps) < 1e-12 and model.device.type == dev.type
    want = gguf_params(gguf.read_gguf(path)["tensors"], lcfg)
    n = 0
    for name, p in model.named_parameters():
        leaf = want
        for key in name.split("."):
            leaf = leaf[int(key)] if key.isdigit() else leaf[key]
        assert torch.equal(p.cpu(), torch.from_numpy(np.asarray(leaf))), f"gguf: {name}"
        n += 1
    log(f"gguf: {GGUF_LAYERS} layers at TinyLlama widths in Q8_0, "
        f"{os.path.getsize(path) / 1e6:.1f} MB, written in {t1 - t0:.1f} s, loaded onto "
        f"{model.device} in {t2 - t1:.1f} s; {n} tensors equal to the dequantised file's")
    del model

    s = sm.Summarizer(gguf_path=path, device=dev)
    assert s.backend == "local", s.backend
    prompt = ("Summarize this Vietnamese meeting transcript chunk as JSON with keys "
              '"title", "summary", "key_points" (list), "action_items" (list):\n\n'
              + "xin chao viet nam. hom nay hop ve du an moi. " * 20)
    t0 = time.perf_counter()
    text = sm._local_generate(prompt, path, max_new_tokens=SUMMARY_TOKENS, device=dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    cpu_text = sm._local_generate(prompt, path, max_new_tokens=SUMMARY_TOKENS, device="cpu")
    card_model, _, tok, meta = sm._local_llm(path, dev)
    cpu_model = sm._local_llm(path, "cpu")[0]
    assert card_model.device.type == dev.type
    ids = [int(meta["tokenizer.ggml.bos_token_id"])] + tok.encode(prompt)
    ref, margins = greedy_margins(cpu_model, ids, SUMMARY_TOKENS)
    got = generate(card_model, ids, max_new_tokens=SUMMARY_TOKENS)
    eos = int(meta["tokenizer.ggml.eos_token_id"])
    ref_cut = ref[: ref.index(eos)] if eos in ref else ref
    tie = tie_compare("gguf summarizer", got, ref_cut, margins[: len(ref_cut)])
    if tie is None:
        assert text == cpu_text, "gguf summarizer: the card's text is not the CPU's"
    log(f"gguf summarizer: backend local on {card_model.device}, {len(ids)} prompt tokens, "
        f"{len(got)} generated, card {card_s:.2f} s (first call, load included), text "
        f"equal to the CPU's: {text == cpu_text} ({card()})")
    sm._LOCAL_LLM.pop((path, "cpu"), None)
    return path


class Serving:
    """The port's web service on the card, driven over urllib and raw
    websocket frames from this process."""

    def __init__(self, dev, model, tmp):
        import threading

        from sherpa_vietnamese_asr_tpu_torch.web_service.server import make_server

        self.server, self.state = make_server(port=0, use_tls=False,
                                              data_dir=os.path.join(tmp, "web"),
                                              model_provider=lambda name: model, device=dev)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.state.shutdown()
        self.thread.join(timeout=30)

    def req(self, path, method="GET", body=None, headers=None, raw=None, timeout=600):
        import urllib.error
        import urllib.request

        headers = dict(headers or {})
        data = raw
        if body is not None:
            data = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        r = urllib.request.Request(self.base + path, data=data, method=method, headers=headers)
        try:
            with urllib.request.urlopen(r, timeout=timeout) as resp:
                return resp.status, json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read().decode())

    def ws_stream(self, pcm, piece):
        """A /ws/stream client: (partials, final)."""
        import base64
        import socket
        import struct

        host, port = self.base.replace("http://", "").split(":")
        sock = socket.create_connection((host, int(port)), timeout=300)
        key = base64.b64encode(os.urandom(16)).decode()
        sock.sendall((f"GET /ws/stream HTTP/1.1\r\nHost: {host}\r\nUpgrade: websocket\r\n"
                      f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += sock.recv(1)
        assert b"101" in buf.split(b"\r\n", 1)[0], buf

        def frame(payload, opcode):
            mask = os.urandom(4)
            n = len(payload)
            head = bytes([0x80 | opcode])
            head += bytes([0x80 | n]) if n < 126 else bytes([0x80 | 126]) + struct.pack(">H", n)
            body = (np.frombuffer(payload, np.uint8)
                    ^ np.resize(np.frombuffer(mask, np.uint8), n)).tobytes()
            return head + mask + body

        def read():
            head = b""
            while len(head) < 2:
                head += sock.recv(2 - len(head))
            ln = head[1] & 0x7F
            if ln == 126:
                ln = struct.unpack(">H", sock.recv(2))[0]
            data = b""
            while len(data) < ln:
                data += sock.recv(ln - len(data))
            return json.loads(data)

        try:
            assert read()["type"] == "ready"
            for off in range(0, len(pcm), piece):
                sock.sendall(frame(pcm[off: off + piece].tobytes(), 0x2))
            sock.sendall(frame(b"", 0x8))
            partials = []
            while True:
                m = read()
                assert m["type"] in ("partial", "final"), m
                if m["type"] == "partial":
                    partials.append(m["text"])
                else:
                    return partials, m["text"]
        finally:
            sock.close()


def serve_request(srv, model, tmp):
    """Upload 100 s, process through the queue (kernels 1-3 counted while it
    runs), poll until completed; the stored words must be an in-memory
    TranscriberPipeline run's over the same config and model."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline.asr_json import serialize_segments
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    path = os.path.join(tmp, "serve_100s.wav")
    write_wav(path, default_path_audio(), SR)
    with open(path, "rb") as f:
        wav = f.read()
    _, s = srv.req("/api/session", "POST")
    h = {"X-Session-Id": s["session_id"]}
    status, up = srv.req("/api/upload", "POST", headers={**h, "X-Filename": "meeting.wav"},
                         raw=wav)
    assert status == 200, up
    fid = up["file_id"]
    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0
    t0 = time.perf_counter()
    status, pr = srv.req(f"/api/process/{fid}", "POST", body=SERVE_CONFIG, headers=h)
    assert status == 200, pr
    while True:
        _, st = srv.req(f"/api/files/{fid}/status", headers=h)
        assert st["status"] != "error", f"queued job failed: {st}"
        if st["status"] == "completed":
            break
        assert time.perf_counter() - t0 < 600, f"queued job stuck: {st}"
        time.sleep(0.02)
    wall = time.perf_counter() - t0
    launches = {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
                "beam_search": beam_search_cuda.launches}
    assert all(n > 0 for n in launches.values()), f"queue: a kernel did not run {launches}"
    stored = json.loads(srv.state.db.get_file(fid)["asr_result_json"])
    status, res = srv.req(f"/api/files/{fid}/result", headers=h)
    assert status == 200
    cfg = srv.state.queue._build_pipeline_config(SERVE_CONFIG)
    ref = TranscriberPipeline(path, model, cfg).run()
    torch.cuda.synchronize()
    ref_json = serialize_segments(ref["segments"], duration_sec=ref["duration_sec"])

    def words(segs):
        return [(w["text"], w.get("start"), w.get("end")) for seg in segs
                if seg["type"] == "text" for w in seg.get("raw_words", [])]

    got_words, ref_words = words(stored["segments"]), words(ref_json["segments"])
    assert got_words == ref_words and got_words, "queue: words differ from the in-memory run"
    assert stored["text"] == ref["text"] == res["result"]["text"]
    log(f"serve: queued {SERVE_SECONDS:.0f} s upload completed, process -> completed "
        f"{wall:.3f} s wall, {len(got_words)} words equal to the in-memory run's, timing "
        f"{ {k: round(v, 3) for k, v in stored['timing'].items()} }, launches {launches} "
        f"({card()})")
    return fid, h, launches


def serve_summary(srv, fid, h, gguf_path):
    """POST /api/files/{id}/summarize with SVT_SUMMARIZER_GGUF at (b)'s file:
    generation must run on the card (the port's generate counted)."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models import llama

    calls, tokens, inner = [], [], llama.generate

    def counted(model, prompt_ids, *a, **k):
        out = inner(model, prompt_ids, *a, **k)
        calls.append((model.device.type, len(prompt_ids)))
        tokens.append(len(out))
        return out

    os.environ["SVT_SUMMARIZER_GGUF"] = gguf_path
    llama.generate = counted
    try:
        t0 = time.perf_counter()
        status, out = srv.req(f"/api/files/{fid}/summarize", "POST", body={}, headers=h)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        llama.generate = inner
        del os.environ["SVT_SUMMARIZER_GGUF"]
    assert status == 200, out
    assert set(out["summary"]) == {"title", "summary", "key_points", "action_items"}
    assert calls and all(d == srv.state.device.type for d, _ in calls), \
        f"summarize: generate ran on {calls}"
    log(f"serve: summarize {wall:.3f} s wall, generate called {len(calls)} times on the card "
        f"(prompt tokens {[n for _, n in calls]}), {sum(tokens)} tokens generated "
        f"({sum(tokens) / wall:.1f} tokens/s of request wall) ({card()})")


def serve_streams(srv, model):
    """Two /ws/stream clients of 20 s each in 0.1 s frames at once: finals
    equal single-stream recognizers' on the card, kernel 1 once a step."""
    import threading

    from sherpa_vietnamese_asr_tpu_torch.ops import fbank
    from sherpa_vietnamese_asr_tpu_torch.pipeline.streaming_online import _pieces_text

    audios = [a[: int(WS_SECONDS * SR)] for a in stream_audio()[:2]]
    refs = [_pieces_text(model, single_stream(model, a)) for a in audios]
    streamer = srv.state.get_streamer()
    inner, walls = streamer._step, []

    def timed(*args):
        t = time.perf_counter()
        out = inner(*args)
        out[2].cpu()
        walls.append((time.perf_counter() - t) * 1e3)
        return out

    streamer._step = timed
    fbank.launches = 0
    results, errors = [None, None], []

    def client(i):
        try:
            pcm = np.clip(np.rint(audios[i] * 32768), -32768, 32767).astype(np.int16)
            results[i] = srv.ws_stream(pcm, STREAM_PIECE)
        except Exception as e:  # reported below, the phase fails
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    streamer._step = inner
    assert not errors and all(r is not None for r in results), f"ws clients: {errors}"
    assert len(walls) == fbank.launches > 0, \
        f"ws: kernel 1 {fbank.launches} launches in {len(walls)} fused steps"
    for i, ((partials, final), ref) in enumerate(zip(results, refs)):
        assert final == ref, f"ws stream {i}: final differs from the single-stream recognizer"
        assert partials, f"ws stream {i}: no partial"
    log(f"serve: 2 websocket streams of {WS_SECONDS:.0f} s in 0.1 s frames, {wall:.2f} s "
        f"wall, finals equal single-stream recognizers ({len(refs[0].split())} and "
        f"{len(refs[1].split())} words, {len(results[0][0])} and {len(results[1][0])} "
        f"partials); {len(walls)} fused steps, kernel 1 {fbank.launches} launches, step "
        f"wall median {np.median(walls):.3f} ms (min {min(walls):.3f}) ({card()})")
    return fbank.launches


def serve_calibration(srv):
    """POST /api/calibration/run: cpu and cuda for each stage, within
    STAGE_TOLERANCES."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.calibration import within_tolerance

    t0 = time.perf_counter()
    status, rep = srv.req("/api/calibration/run", "POST", body={})
    wall = time.perf_counter() - t0
    assert status == 200, rep
    assert set(rep["devices"]) == {"cpu", "cuda"}, rep["devices"]
    for name, e in rep["stages"].items():
        assert "time_sec" in e.get("cpu", {}) and "time_sec" in e.get("cuda", {}), (name, e)
        assert within_tolerance(e["diff"], name), (name, e["diff"])
    log(f"serve: calibration {wall:.1f} s wall, devices {rep['devices']}: " + "; ".join(
        f"{n} cpu {e['cpu']['time_sec']:.4f} s cuda {e['cuda']['time_sec']:.4f} s speedup "
        f"{e['speedup']} max_abs {e['diff']['max_abs']:.2e} rel_l2 {e['diff']['rel_l2']:.2e}"
        for n, e in rep["stages"].items()) + f"; accepted {rep['accelerated_stages']} "
        f"({card()})")


def warmup_dir(tmp):
    """Diarization and ViBERT files written by the port's exporters from
    random full-width models, for warmup's models_dir."""
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_aux import export_vibert_files
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_diar import (
        export_diarization_files,
    )
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import random_pyannet
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import random_resnet_speaker
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import random_vibert

    d = os.path.join(tmp, "warmup-models")
    os.makedirs(d, exist_ok=True)
    export_diarization_files(random_pyannet(seed=0, device="cpu"),
                             random_resnet_speaker(seed=1, device="cpu"), d)
    export_vibert_files(random_vibert(seed=0, device="cpu"), gec_vocab(), d)
    return d


def serve_warmup(srv, model, model16, tmp):
    """warmup_programs on the server's model and streamer, cold then warm:
    every stage returns a time; then the bfloat16 decode stage (kernel 4)."""
    from sherpa_vietnamese_asr_tpu_torch.ops import beam_search_cuda, encoder_layer
    from sherpa_vietnamese_asr_tpu_torch.pipeline.warmup import STAGES, warmup_programs

    d = warmup_dir(tmp)
    runs = []
    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        timings = warmup_programs(model, models_dir=d, log=lambda m: None,
                                  streamer=srv.state.get_streamer())
        runs.append(time.perf_counter() - t0)
        assert list(timings) == list(STAGES) and all(v is not None for v in timings.values()), \
            f"warmup ({label}): a stage returned None: {timings}"
        log(f"serve: warmup {label} {runs[-1]:.2f} s: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in timings.items()) + f" ({card()})")
    encoder_layer.launches = beam_search_cuda.hotword_launches = 0
    timings = warmup_programs(model16, stages=("decode",), log=lambda m: None)
    assert timings["decode"] is not None
    launches = {"encoder_layer_bf16": encoder_layer.launches,
                "beam_search_hotwords": beam_search_cuda.hotword_launches}
    assert all(n > 0 for n in launches.values()), f"bf16 warmup: {launches}"
    log(f"serve: warmup --dtype bfloat16 decode {timings['decode']:.3f} s, launches {launches}")
    return launches


def phase_serving(dev, model, model16, tmp):
    """(a) the 1.1 B Llama against its CPU twin, (b) the Q8_0 GGUF and the
    local summarizer, (c) the web service: a queued request, a summary, two
    live streams, a calibration and warmup. Returns each kernel's launches
    on the serving path."""
    t0 = time.perf_counter()
    check_llama(dev)
    gguf_path = check_gguf(dev, tmp)
    sharp = sharp_copy(model)  # near-ties between 8-slot and single-stream steps
    srv = Serving(dev, sharp, tmp)
    try:
        fid, h, launches = serve_request(srv, sharp, tmp)
        serve_summary(srv, fid, h, gguf_path)
        serve_streams(srv, sharp)
        serve_calibration(srv)
        launches.update(serve_warmup(srv, sharp, model16, tmp))
    finally:
        srv.close()
    log(f"serving phase {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 13

REHEARSAL_T_IN = 96  # the executable encoder export's frames (verify_assets probes 96)
REHEARSAL_SAMPLES = REHEARSAL_T_IN * 160  # golden audio giving 96 fbank frames (snip_edges off)
# The skips models/verify_assets takes over from the JAX package, word for word.
JAX_SKIPS = ("skipped: weight-only export (no executable graph)",
             "skipped: stateful streaming graph exec not wired; offline twin covers "
             "tensor parity",
             "skipped: stateful If/LSTM streaming graph exec not wired; importer "
             "oracle-tested vs torch")
NATIVE_RESAMPLE_GATE = 5e-3  # tests/test_native.py: audiokit against resample_poly, interior
NATIVE_WAV_SECONDS = 0.5  # 44.1 kHz stereo; the numpy resample_poly is a polyphase sum


def rehearsal_models(model, model68):
    """The stand-in of every asset: the float32 Zipformer-30M and 68M
    sharpened (joiner x AUTO_SHARPEN, against near-tied beam steps of random
    weights), the streaming 30M, and full-width PyanNet, ResNet34, CAM++,
    Silero, Conv-TasNet, ViBERT (vocab 62,000) and DNSMOS from one CPU
    torch.Generator seeded 0, with a seeded PLDA."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.campplus import random_campp
    from sherpa_vietnamese_asr_tpu_torch.models.convtasnet import random_convtasnet
    from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import random_dnsmos
    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import random_pyannet
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import random_resnet_speaker
    from sherpa_vietnamese_asr_tpu_torch.models.silero_vad import random_silero_vad
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import random_vibert
    from sherpa_vietnamese_asr_tpu_torch.tools.rehearsal_assets import random_plda

    gen = torch.Generator().manual_seed(0)
    vibert = random_vibert(device="cpu", generator=gen)
    vocab = gec_vocab()
    vocab += [f"##x{i}" for i in range(vibert.cfg.vocab_size - len(vocab))]
    return {"zipformer-30m": sharp_copy(model), "zipformer-68m": sharp_copy(model68),
            "zipformer-30m-streaming": model,
            "vibert-capu": (vibert, vocab),
            "segmentation": random_pyannet(device="cpu", generator=gen),
            "embedding-split": random_resnet_speaker(device="cpu", generator=gen),
            "plda": random_plda(seed=0),
            "campp": random_campp(device="cpu", generator=gen),
            "silero-vad": random_silero_vad(device="cpu", generator=gen),
            "convtasnet": random_convtasnet(device="cpu", generator=gen),
            "dnsmos": random_dnsmos(device="cpu", generator=gen)}


def kernel_counts():
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank

    return {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
            "beam_search": beam_search_cuda.launches}


def zero_counts():
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank

    for mod in (fbank, attention, beam_search_cuda):
        mod.launches = 0


def verify_assets_cli(tmp):
    """`cli verify-assets --json --device cuda` in process over the written
    assets: ok, every asset verified or partial, no skip but JAX's own, each
    exec row printed. Returns (report, launches of the run)."""
    rc, out, err = run_cli(["verify-assets", "--json", "--device", "cuda"])
    report = json.loads(out)
    from sherpa_vietnamese_asr_tpu_torch.models.verify_assets import format_report

    for line in format_report(report).splitlines():
        if ".exec" in line or "tokens." in line or line[:1] != " ":
            log(f"verify-assets: {line.strip()}")
    assert rc == 0 and report["ok"] is True, f"verify-assets rc {rc}:\n{out[-4000:]}{err[-2000:]}"
    for key, r in report["assets"].items():
        assert r["status"] in ("verified", "partial"), f"{key}: {r['status']}"
        for c in r["checks"]:
            assert c["ok"] is not False, f"{key}: {c}"
            if c["ok"] is None:
                assert c["detail"] in JAX_SKIPS, f"{key}: a skip of its own: {c}"
    return report


def golden_stacks(dev, sharp, model_dir):
    """run_torch_stack on the card against run_exec_stack on the same
    executable export (REHEARSAL_T_IN frames of the golden audio), and the
    same torch stack on the host CPU against it: the tokens that differ on
    each, and the encoder outputs' largest difference."""
    import copy

    from sherpa_vietnamese_asr_tpu_torch.models import golden
    from sherpa_vietnamese_asr_tpu_torch.models.registry import with_pos_dtype

    sharp = with_pos_dtype(sharp, "float32")  # the golden model's setting (the CPU twin reads it)
    audio = golden.golden_audio()[:REHEARSAL_SAMPLES]
    t0 = time.perf_counter()
    ref_tokens, _, ref_enc, ref_feats = golden.run_exec_stack(sharp, audio, model_dir)
    t1 = time.perf_counter()
    zero_counts()
    tokens, _, enc, feats = golden.run_torch_stack(sharp, audio)
    launches = kernel_counts()
    t2 = time.perf_counter()
    cpu_tokens, _, cpu_enc, _ = golden.run_torch_stack(copy.deepcopy(sharp).to("cpu"), audio)
    assert feats.shape == ref_feats.shape == (REHEARSAL_T_IN, 80)
    assert enc.shape == ref_enc.shape and np.isfinite(enc).all()

    def differ(a, b):
        return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))

    n_card, n_cpu = differ(tokens, ref_tokens), differ(cpu_tokens, ref_tokens)
    log(f"golden stacks: exec stack (numpy fbank, graph executor, oracle beam 8) "
        f"{t1 - t0:.2f} s, {len(ref_tokens)} tokens; torch stack on {dev} "
        f"{(t2 - t1) * 1e3:.1f} ms, {n_card} tokens differ; on the host CPU {n_cpu} differ; "
        f"fbank max |card - numpy| {np.abs(feats - ref_feats).max():.3e}, encoder max "
        f"|card - exec| {np.abs(enc - ref_enc).max():.3e} (CPU {np.abs(cpu_enc - ref_enc).max():.3e}) "
        f"of max |exec| {np.abs(ref_enc).max():.3f}; launches {launches}")
    assert n_card <= n_cpu, f"golden stacks: {n_card} tokens differ on the card, {n_cpu} on the CPU"
    assert all(v > 0 for v in launches.values()), f"a kernel did not run: {launches}"
    return launches


def audiokit_wav(tmp):
    """get_audiokit() loaded; a 44.1 kHz stereo WAV through load_audio's
    native path against the pure-numpy reader and resampler."""
    from sherpa_vietnamese_asr_tpu_torch.utils import native
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import (
        load_audio,
        read_wav,
        resample_poly,
        write_wav,
    )

    t0 = time.perf_counter()
    lib = native.get_audiokit()
    assert lib is not None, "the native audiokit did not build"
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    sr = 44100
    x = speechlike(rng, int(NATIVE_WAV_SECONDS * sr))
    stereo = np.stack([x, 0.5 * x], axis=1) * 2.0  # peak over 0.5: no normalisation
    path = os.path.join(tmp, "stereo_44k.wav")
    write_wav(path, stereo, sr)
    decoded, rate = native.wav_decode_native(path)
    ref, _ = read_wav(path)
    decode_err = float(np.abs(decoded - ref.mean(axis=1)).max())
    t0 = time.perf_counter()
    got = load_audio(path)
    native_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = resample_poly(ref.mean(axis=1), sr, SR)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    n = min(len(got), len(want))
    err = float(np.abs(got[200: n - 200] - want[200: n - 200]).max())
    log(f"audiokit: {native.library_path('audiokit')} built and loaded in {build_s:.2f} s; "
        f"{NATIVE_WAV_SECONDS} s 44.1 kHz stereo WAV: decode max |native - numpy| {decode_err:.2e}, "
        f"load_audio {len(got)} samples in {native_ms:.1f} ms (numpy resampler "
        f"{numpy_ms:.1f} ms), interior max |native - numpy| {err:.2e} (gate {NATIVE_RESAMPLE_GATE})")
    assert rate == sr and decode_err <= 1e-6
    assert abs(len(got) - len(want)) <= 2 and err <= NATIVE_RESAMPLE_GATE


def phase_verify_assets(dev, model, model68, tmp):
    """The asset rehearsal: full-width stand-ins of every asset under their
    MANIFEST names (the 30M and 68M as executable exports at REHEARSAL_T_IN),
    the MANIFEST re-pinned to them, `cli verify-assets --device cuda`, the
    golden stacks on the same export, and the native WAV path. Returns the
    launches of kernels 1-3 over the phase."""
    from sherpa_vietnamese_asr_tpu_torch.models import assets
    from sherpa_vietnamese_asr_tpu_torch.tools.rehearsal_assets import write_assets

    t0 = time.perf_counter()
    models = rehearsal_models(model, model68)
    root = os.path.join(tmp, "models")
    manifest = write_assets(root, models, t_in=REHEARSAL_T_IN)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    t1 = time.perf_counter()
    log(f"verify assets: {len(manifest) - 1} assets written ({size / 1e6:.0f} MB) and "
        f"re-pinned in {t1 - t0:.1f} s; the 30M and 68M joiners x {AUTO_SHARPEN}")
    saved = (assets.MANIFEST, assets._cache, os.environ.get("SVT_MODELS_DIR"))
    assets.MANIFEST, assets._cache = manifest, {}
    os.environ["SVT_MODELS_DIR"] = root
    try:
        zero_counts()
        verify_assets_cli(tmp)
        run_launches = kernel_counts()
        t2 = time.perf_counter()
    finally:
        assets.MANIFEST, assets._cache = saved[0], saved[1]
        if saved[2] is None:
            os.environ.pop("SVT_MODELS_DIR")
        else:
            os.environ["SVT_MODELS_DIR"] = saved[2]
    log(f"verify assets: cli verify-assets --device cuda {t2 - t1:.1f} s, launches {run_launches}")
    assert run_launches["attention_weights"] > 0 and run_launches["beam_search"] > 0, \
        f"verify-assets did not run kernels 2 and 3: {run_launches}"
    asr_dir = os.path.join(root, assets.MANIFEST["zipformer-30m"]["local_dir"])
    stack_launches = golden_stacks(dev, models["zipformer-30m"], asr_dir)
    audiokit_wav(tmp)
    log(f"verify assets phase {time.perf_counter() - t0:.1f} s on {card()}")
    return {k: run_launches[k] + stack_launches[k] for k in run_launches}


# ---------------------------------------------------------------- phase 14

BENCH_ARGV = ["--device", "cuda", "--n-batches", "2", "--minutes", "2"]
BENCH_KERNELS = ("fbank_logmel", "attention_weights", "beam_search", "encoder_layer_bf16")


def all_counts():
    """Every kernel wrapper's launch count, by the kernels line's names."""
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, encoder_layer, fbank

    return {"fbank_logmel": fbank.launches, "attention_weights": attention.launches,
            "beam_search": beam_search_cuda.launches,
            "encoder_layer_bf16": encoder_layer.launches,
            "beam_search_hotwords": beam_search_cuda.hotword_launches,
            "attention_weights_bf16band": attention.bf16band_launches}


def zero_all_counts():
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, encoder_layer, fbank

    fbank.launches = attention.launches = attention.bf16band_launches = 0
    beam_search_cuda.launches = beam_search_cuda.hotword_launches = encoder_layer.launches = 0
    beam_search_cuda.tiled_launches = 0


def phase_bench():
    """The package's bench (`cli bench`'s main) at a reduced size: two timed
    batches a tier and a 2-minute full pipeline. Any `skipped` but
    time_budget (a failed check_contract among them) or a value that is not
    positive fails the phase. Returns each kernel's launches over the run."""
    import contextlib
    import io

    from sherpa_vietnamese_asr_tpu_torch import bench

    t0 = time.perf_counter()
    buf = io.StringIO()
    zero_all_counts()
    with contextlib.redirect_stdout(buf):
        out = bench.main(BENCH_ARGV)
    launches = all_counts()
    line = buf.getvalue().strip()
    log(f"bench {' '.join(BENCH_ARGV)}: {line}")
    assert json.loads(line) == out
    for entry in [out] + out["extras"]:
        skipped = entry.get("skipped")
        assert skipped in (None, "time_budget"), f"bench: {entry['metric']} skipped: {skipped}"
        assert skipped or entry["value"] > 0, f"bench: {entry['metric']} value {entry['value']}"
    assert [e["metric"] for e in out["extras"]][:1] == ["rtfx_zipformer30m_beam8_fp32_per_chip"]
    assert out["extras"][0].get("default_tier") is True
    log(f"bench launches {launches} in {time.perf_counter() - t0:.1f} s ({card()})")
    missing = [k for k in BENCH_KERNELS if launches[k] == 0]
    assert not missing, f"bench: kernels never launched: {missing}"
    return launches


# ---------------------------------------------------------------- phase 15

MESH_SPANS = 16  # 30 s spans: two batches of 8, or one of 16 split in two


def mesh_words(model, audio, spans, **kw):
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder

    dec = BatchedChunkDecoder(model, **kw)
    return dec, dec.decode_spans(audio, spans)


def phase_multi_device(dev, model):
    """Data parallelism over a list of devices on the one card. The decoder
    with mesh [cuda:0], and with a CPU copy of the model replicated to
    cuda:0 by the mesh, must give mesh=None's words bit for bit; two
    replicas on the card, [cuda:0, cuda:0] at max_batch 16, launch the same
    shapes as mesh=None at max_batch 8 and must give the same words bit for
    bit; likewise QualityAnalyzer on six windows split in two (against the
    unsplit analyzer on each half; the six-window batch within
    DNSMOS_GATE), PureDiarizer's superblocks and GecBert's minibatches."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.dnsmos import random_dnsmos
    from sherpa_vietnamese_asr_tpu_torch.parallel.sharding import default_mesh, make_mesh, shard_model
    from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import DNSMOS_LEN, QualityAnalyzer

    t0 = time.perf_counter()
    assert default_mesh() is None, "one card: default_mesh() must be None"
    rng = np.random.default_rng(15)
    audio = speechlike(rng, MESH_SPANS * 30 * SR)
    spans = [(i * 30 * SR, (i + 1) * 30 * SR) for i in range(MESH_SPANS)]
    zero_all_counts()
    plain, ref = mesh_words(model, audio, spans, max_batch=8)
    launches = all_counts()
    assert plain.mesh is None and launches["beam_search"] == 2, launches
    one, got_one = mesh_words(model, audio, spans, max_batch=8, mesh=make_mesh(["cuda:0"]))
    assert one.model is model
    cpu_model = shard_model(model, make_mesh(["cpu"]))[0]
    copied, got_copy = mesh_words(cpu_model, audio, spans, max_batch=8,
                                  mesh=make_mesh(["cuda:0"]))
    assert copied.model is not cpu_model and copied.model.device == dev
    assert cpu_model.device.type == "cpu"
    zero_all_counts()
    two, got_two = mesh_words(model, audio, spans, max_batch=16,
                              mesh=make_mesh(["cuda:0", "cuda:0"]))
    launches_two = all_counts()
    assert two.max_batch == 16 and len(two.devices) == 2
    assert launches_two["beam_search"] == 2, launches_two  # one batch, two pieces of 8
    n_words = sum(map(len, ref))
    for label, got in (("mesh [cuda:0]", got_one), ("a CPU copy on mesh [cuda:0]", got_copy),
                       ("two replicas at max_batch 16", got_two)):
        differ = sum(g != r for g, r in zip(got, ref)) + abs(len(got) - len(ref))
        log(f"multi-device: {label} against mesh=None at max_batch 8: {differ} of "
            f"{len(spans)} spans differ ({n_words} words)")
        assert differ == 0, f"multi-device: {label} is not bit-identical to mesh=None"
    card_model = random_dnsmos(seed=0, device=dev)
    with torch.no_grad():
        card_model.head.bias.add_(DNSMOS_HEAD_BIAS)
    windows = [speechlike(rng, DNSMOS_LEN) * g for g in (1.0, 0.6, 0.3, 0.1, 0.05, 0.02)]
    plain_qa = QualityAnalyzer(model=card_model)
    halves = np.concatenate([plain_qa.raw_scores(windows[:3]), plain_qa.raw_scores(windows[3:])])
    split = QualityAnalyzer(model=card_model, mesh=make_mesh(["cuda:0", "cuda:0"]))
    got = split.raw_scores(windows)
    whole = float(np.abs(got - plain_qa.raw_scores(windows)).max())
    log(f"multi-device: DNSMOS on 6 windows, two replicas against mesh=None on each half: "
        f"max |d| {float(np.abs(got - halves).max()):.3e}; against the 6-window batch "
        f"{whole:.3e} (gate {DNSMOS_GATE}); decoder launches mesh=None {launches}, two "
        f"replicas {launches_two}; phase {time.perf_counter() - t0:.1f} s ({card()})")
    assert got.shape == (6, 3) and np.array_equal(got, halves), \
        "multi-device: DNSMOS split is not bit-identical to the halves"
    assert whole <= DNSMOS_GATE
    mesh_diarizer(dev)
    mesh_gec(dev)
    log(f"multi-device phase {time.perf_counter() - t0:.1f} s")
    return launches_two


def mesh_diarizer(dev):
    """A full-width PureDiarizer's superblocks on 100 s (two superblocks of
    64 windows): two replicas on the card, one superblock each, bit-identical
    to mesh=None (the same launch shapes); kernel 1 once a superblock."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.pyannet import random_pyannet
    from sherpa_vietnamese_asr_tpu_torch.models.resnet_speaker import random_resnet_speaker
    from sherpa_vietnamese_asr_tpu_torch.ops import fbank
    from sherpa_vietnamese_asr_tpu_torch.parallel.sharding import make_mesh
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer

    gen = torch.Generator().manual_seed(0)
    kw = dict(seg_model=random_pyannet(device=dev, generator=gen),
              emb_model=random_resnet_speaker(device=dev, generator=gen), device=dev)
    with torch.no_grad():
        kw["seg_model"].classifier.bias.add_(torch.tensor(DIAR_SPEAKER_BIAS, device=dev))
    audio = diarization_audio(100)
    outs = []
    for mesh in (None, make_mesh(["cuda:0", "cuda:0"])):
        fbank.launches = 0
        outs.append(PureDiarizer(mesh=mesh, **kw)._segment_and_embed_fused(audio))
        assert fbank.launches == 2, f"multi-device: kernel 1 launches {fbank.launches}"
    (bin_p, starts_p, emb_p), (bin_s, starts_s, emb_s) = outs
    valid = int((~np.isnan(emb_p[..., 0])).sum())
    log(f"multi-device: PureDiarizer on 100 s, {len(starts_p)} windows, two replicas "
        f"against mesh=None: argmax equal {np.array_equal(bin_s, bin_p)}, embeddings "
        f"bit-identical {np.array_equal(emb_s, emb_p, equal_nan=True)} ({valid} valid slots)")
    assert starts_s == starts_p and valid > 0
    assert np.array_equal(bin_s, bin_p) and np.array_equal(emb_s, emb_p, equal_nan=True), \
        "multi-device: PureDiarizer split is not bit-identical to mesh=None"


def mesh_gec(dev):
    """GecBert (full-width random ViBERT) on the phase-9 text with pause
    hints: two replicas at mini_batch_size 32 (pieces of 16) against
    mesh=None at 16, the same launch shapes: every decode call's labels and
    the restored text bit-identical."""
    from sherpa_vietnamese_asr_tpu_torch.models.vibert import ViBertConfig, random_vibert
    from sherpa_vietnamese_asr_tpu_torch.parallel.sharding import make_mesh
    from sherpa_vietnamese_asr_tpu_torch.pipeline.gec import GecBert
    from sherpa_vietnamese_asr_tpu_torch.utils.wordpiece import WordPieceTokenizer

    model = random_vibert(ViBertConfig(), seed=0, device=dev)
    text, hints = gec_text()
    runs = []
    for mesh, mb in ((None, 16), (make_mesh(["cuda:0", "cuda:0"]), 32)):
        gec = GecBert(model, WordPieceTokenizer(gec_vocab()), confidence=0.3,
                      mini_batch_size=mb, mesh=mesh)
        record = recorded_gec(gec)
        out = gec(text, pause_hints=hints)[0]
        runs.append((out, [np.asarray(r[0]) for r in record]))
    (out_p, idx_p), (out_s, idx_s) = runs
    same = len(idx_p) == len(idx_s) and all(np.array_equal(a, b) for a, b in zip(idx_p, idx_s))
    log(f"multi-device: GecBert on {GEC_WORDS} words, two replicas at mini_batch 32 against "
        f"mesh=None at 16: {len(idx_s)} decode calls, labels equal {same}, text equal "
        f"{out_s == out_p}")
    assert same and out_s == out_p and out_p != text, \
        "multi-device: GecBert split is not bit-identical to mesh=None"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout whose attention, beam and layer kernels are timed "
                         "against these")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(REPO, "sherpa_vietnamese_asr_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    t_phase = [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        log(f"PHASE {name} ok ({now - t_phase[0]:.1f} s)")
        t_phase[0] = now

    dev = phase_device()
    done("device")
    phase_build()
    t_phase[0] = time.perf_counter()
    parent = parent_entries(os.path.abspath(args.parent)) if args.parent else None

    from sherpa_vietnamese_asr_tpu_torch.models.registry import MODEL_68M, random_asr_model
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import synthetic_hotword_tables

    t0 = time.perf_counter()
    model = random_asr_model(vocab_size=2000, beam_size=8, compute_dtype="float32",
                             device=dev)
    model16 = random_asr_model(vocab_size=2000, beam_size=8, compute_dtype="bfloat16",
                               device=dev)
    tables = synthetic_hotword_tables(model16.rnnt_cfg.vocab_size, dev)
    model16.hotword_tables = tables
    model68 = random_asr_model(MODEL_68M, vocab_size=2000, beam_size=8, device=dev)
    model68_16 = random_asr_model(MODEL_68M, vocab_size=2000, beam_size=8,
                                  compute_dtype="bfloat16", device=dev)
    log(f"models: Zipformer-30M random (seed 0), float32 and bfloat16 (hotword table "
        f"S {tables.next_state.shape[0]}), Zipformer-68M random (seed 0), float32 and "
        f"bfloat16, on {dev} in {time.perf_counter() - t0:.1f} s")
    kernels = [check_fbank(dev), check_attention(dev, model, parent),
               check_beam(dev, model, parent), check_encoder_layer(dev, model16, parent),
               check_beam_hotwords(dev, model16, tables, parent),
               check_attention_bf16band(dev, model),
               check_encoder_layer(dev, model68_16, None, LAYER_SHAPES_68M,
                                   "encoder_layer_bf16_68m", plain_layer=True)]
    check_beam_e512(dev, model68)
    done("kernel parity")
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(dev, model, tmp)
        done("slice")
        launches_bf16 = phase_slice_bf16(dev, model16, model, tmp)
    done("slice bf16")
    launches_probe = phase_probe()
    done("probe bf16band")
    with tempfile.TemporaryDirectory() as tmp:
        launches_default = phase_default_path(dev, model, model68, model68_16, tmp)
    done("default path")
    with tempfile.TemporaryDirectory() as tmp:
        launches_diar = phase_diarization(dev, model, tmp)
    done("diarization")
    with tempfile.TemporaryDirectory() as tmp:
        launches_punct = phase_punctuation(dev, model, tmp)
    done("punctuation and quality")
    launches_stream = phase_streaming(dev, model, model16)
    done("streaming")
    with tempfile.TemporaryDirectory() as tmp:
        senko_kernels, launches_senko, launches_overlap = phase_senko_overlap(dev, model, tmp)
    done("senko and overlap")
    with tempfile.TemporaryDirectory() as tmp:
        launches_serving = phase_serving(dev, model, model16, tmp)
    done("serving")
    with tempfile.TemporaryDirectory() as tmp:
        launches_verify = phase_verify_assets(dev, model, model68, tmp)
    done("verify assets")
    launches_bench = phase_bench()
    done("bench")
    phase_multi_device(dev, model)
    done("multi-device")
    # Last: millions of plain-twin launches, after which torch.profiler's
    # windows lost events (phases 3 and 6 of two runs with it in phase 3).
    kernels += check_beam_caps(dev, model, model68, tables, parent)
    done("beam past 8")
    paths = (launches, launches_bf16, launches_probe, launches_default, launches_diar,
             launches_punct, launches_stream, launches_senko, launches_overlap)
    for k in kernels:  # each kernel's count from the first path that runs it
        k["route"] = "cuda"
        k["launches"] = next((p[k["name"]] for p in paths if k["name"] in p), 0)
    kernels += senko_kernels  # kernel 1 on the Senko and overlap paths, counted there
    assert all(k["launches"] > 0 for k in kernels), "a kernel ran on no path"
    for k in kernels:  # launches on the serving (12), verify-assets (13) and bench (14) paths
        k["serving_launches"] = launches_serving.get(k["name"], 0)
        k["verify_launches"] = launches_verify.get(k["name"], 0)
        k["bench_launches"] = launches_bench.get(k["name"], 0)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms", "serving_launches",
             "verify_launches", "bench_launches")
    print(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
