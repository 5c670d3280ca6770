#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card's name and power limit; TF32 off for fp32 products
     and cuDNN convolutions;
  2. build: compile the package's CUDA kernels (csrc/*.cu) from source;
  3. kernel parity: each kernel against its plain PyTorch twin on the card,
     at the shapes the transcription path gives it, with both median times;
  4. slice: TranscriberPipeline(..., {"bypass_vad": True}).run() on three
     WAV files with a random-weight Zipformer-30M model (vocab 2000, beam 8,
     float32), checking the result contract and that every kernel ran.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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

def check_fbank(dev):
    import torch

    from sherpa_vietnamese_asr_tpu_torch.ops import fbank
    from sherpa_vietnamese_asr_tpu_torch.utils import fbank_ref

    rng = np.random.default_rng(0)
    audio = np.stack([speechlike(rng, CHUNK_SAMPLES) for _ in range(SLICE_BATCH)])
    cfg = fbank.ASR_FBANK
    frames = fbank._frame_signal(torch.from_numpy(audio).to(dev), cfg)
    frames = frames.reshape(-1, cfg.n_fft).contiguous()
    got = fbank.logmel(frames, cfg)
    ref = fbank._logmel_plain(frames, cfg)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    cos = float(torch.nn.functional.cosine_similarity(got, ref, dim=-1).min())
    oracle = fbank_ref.compute_fbank(audio[0], cfg)
    n0 = oracle.shape[0]
    err_oracle = float(np.abs(got[:n0].cpu().numpy() - oracle).max())
    ms = time_ms(lambda: fbank.logmel(frames, cfg))
    plain_ms = time_ms(lambda: fbank._logmel_plain(frames, cfg))
    log(f"fbank: frames {tuple(frames.shape)} max_abs {err:.3e} min_cos {cos:.7f} "
        f"max_abs_vs_kaldi_f64 {err_oracle:.3e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
    assert err < 2e-2 and cos > 0.9999 and err_oracle < 2e-2, "fbank parity"
    return {"name": "fbank_logmel", "source": "sherpa_vietnamese_asr_tpu_torch/csrc/fbank_logmel.cu",
            "replaces": "sherpa_vietnamese_asr_tpu/ops/fbank.py:149",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
        log(f"attention: stack {stack} B {SLICE_BATCH} T {t} H {h} lens {lens_list} "
            f"max_abs {err:.3e} key_sum_err {sum_err:.3e} bf16_bound_ratio {rel:.4f} "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        assert err < 2e-2 and sum_err < 2e-2, "attention parity"
        assert rel <= 1.0, "attention parity: beyond bf16 rounding of the twin"
        if out is None:  # the stack-0 shape is the one the summary reports
            out = {"name": "attention_weights",
                   "source": "sherpa_vietnamese_asr_tpu_torch/csrc/attention_weights.cu",
                   "replaces": "sherpa_vietnamese_asr_tpu/ops/attention.py:35",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
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


def check_beam(dev, model):
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
    ms = time_ms(lambda: beam_search_cuda.beam_search_batch_cuda(
        enc, lens, model.decoder, model.joiner, cfg, 8), reps=5, warmup=1)
    plain_ms = time_ms(lambda: beam_search.beam_search_batch(
        enc, lens, model.decoder, model.joiner, cfg, 8), reps=5, warmup=1)
    log(f"beam: B {SLICE_BATCH} T 823 V {cfg.vocab_size} beam 8 kernel {ms:.3f} ms "
        f"plain {plain_ms:.3f} ms")
    return {"name": "beam_search", "source": "sherpa_vietnamese_asr_tpu_torch/csrc/beam_search.cu",
            "replaces": "sherpa_vietnamese_asr_tpu/ops/beam_search_pallas.py:101",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------- phase 4

def phase_slice(dev, model, tmp):
    import torch

    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline
    from sherpa_vietnamese_asr_tpu_torch.models.golden import golden_audio
    from sherpa_vietnamese_asr_tpu_torch.ops import attention, beam_search_cuda, fbank
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import am_tone
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import write_wav

    files = {"golden_6s": golden_audio(), "am_tone_95s": am_tone(95.0, 3),
             "short_0.3s": golden_audio()[int(0.5 * SR): int(0.8 * SR)]}
    paths = {}
    for name, x in files.items():
        paths[name] = os.path.join(tmp, f"{name}.wav")
        write_wav(paths[name], x, SR)

    counters = (fbank, attention, beam_search_cuda)
    for mod in counters:
        mod.launches = 0
    results = {}
    for name in ("golden_6s", "am_tone_95s", "short_0.3s"):
        t0 = time.perf_counter()
        res = TranscriberPipeline(paths[name], model, config={"bypass_vad": True}).run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[name] = res
        n_words = sum(len(s["raw_words"]) for s in res["segments"])
        log(f"slice: {name} wall {wall:.3f} s duration {res['duration_sec']:.2f} s "
            f"segments {len(res['segments'])} words {n_words} "
            f"provider {res['asr_provider_info']}")
        assert abs(res["duration_sec"] - len(files[name]) / SR) < 1e-6, "duration"
        assert res["asr_provider_info"]["backend"] == "torch"
        assert res["asr_provider_info"]["device"].startswith("cuda")
        assert not os.path.exists(paths[name] + ".asr_phase")
        if name != "short_0.3s":
            assert res["segments"] and n_words > 0, f"{name}: no words"
            assert all(np.isfinite(w["prob"]) for s in res["segments"]
                       for w in s["raw_words"])
    launches = {"fbank_logmel": fbank.launches,
                "attention_weights": attention.launches,
                "beam_search": beam_search_cuda.launches}
    log(f"slice launches: {launches}")
    assert all(n > 0 for n in launches.values()), "a kernel never ran in the slice"

    t0 = time.perf_counter()  # the 95 s request again, warm
    TranscriberPipeline(paths["am_tone_95s"], model, config={"bypass_vad": True}).run()
    torch.cuda.synchronize()
    log(f"slice: am_tone_95s warm wall {time.perf_counter() - t0:.3f} s")
    return launches


def main():
    if not os.path.isdir(os.path.join(REPO, "sherpa_vietnamese_asr_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import torch

    dev = phase_device()
    log("PHASE device ok")
    phase_build()

    from sherpa_vietnamese_asr_tpu_torch.models.registry import random_asr_model

    t0 = time.perf_counter()
    model = random_asr_model(vocab_size=2000, beam_size=8, compute_dtype="float32",
                             device=dev)
    log(f"model: Zipformer-30M random (seed 0) on {dev} in "
        f"{time.perf_counter() - t0:.1f} s")
    kernels = [check_fbank(dev), check_attention(dev, model), check_beam(dev, model)]
    log("PHASE kernel parity ok")
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_slice(dev, model, tmp)
    log("PHASE slice ok")
    for k in kernels:
        k["route"] = "cuda"
        k["launches"] = launches[k["name"]]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
             "plain_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in order} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
