# Command-line interface of the port.
#
# Port of sherpa_vietnamese_asr_tpu/cli.py's `transcribe`, `serve`,
# `warmup`, `calibrate`, `verify-assets`, `install-service`, `monitor` and
# `bench` subcommands (their functions and arguments):
#
#   python -m sherpa_vietnamese_asr_tpu_torch.cli transcribe <audio>
#       [--model DIR|ID] [--rover] [--wpe] [--enable-resume] [--no-vad]
#       [--diarize [--num-speakers N]] [--punctuate] [--quality] ...
#       -> prints the text, writes <audio>.asr.json
#   ... serve [--host H] [--port P] [--data-dir DIR] [--warmup] [--http]
#       -> the web service (web_service/server.py): uploads through the
#          queue, /ws/stream live captions, summaries, calibration
#   ... warmup [--stages a,b] -> pipeline/warmup.py, each stage once
#   ... calibrate [--autotune] [--full] -> calibration_report.json
#   ... verify-assets [--asset KEY]... [--json] -> models/verify_assets.py,
#       exit code 1 when a present asset fails
#   ... install-service [--port P] [--data-dir DIR] [--output FILE]
#       -> a systemd unit that runs `serve` of this package
#   ... monitor [--interval S] [--samples N] [--output CSV] -> RSS and CPU
#   ... bench [--n-batches N] [--minutes M] -> bench.py of this package:
#       one JSON line (bf16 and float32 decode RTFx, full-pipeline RTFx)
#
# Each device-facing command runs on the card unless --device cpu is given;
# without a card the default raises. --diarize runs the pure
# pyannote-Community-1 diarizer (pipeline/diarization_pure.PureDiarizer) on
# the same device, its models from the --model directory when it holds
# them. --punctuate restores punctuation and case with ViBERT
# (pipeline/punctuation), its vibert-capu.onnx and vocab.txt from the
# --model directory when it holds them; --quality adds DNSMOS
# (pipeline/quality.QualityAnalyzer), from the asset registry; both run on
# the same device, with loudly flagged random weights when no checkpoint is
# found, as in the JAX CLI. `serve` loads its models in float32, as the JAX
# CLI does. The JAX CLI's `bench` runs the repository's bench.py, which
# imports the JAX package; this package's `bench` runs its own
# sherpa_vietnamese_asr_tpu_torch/bench.py, the same three measurements on
# the card.

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time


def _load_model(args):
    from sherpa_vietnamese_asr_tpu_torch.models import assets
    from sherpa_vietnamese_asr_tpu_torch.models.registry import (
        MODEL_30M,
        MODEL_68M,
        load_asr_model,
        random_asr_model,
    )

    if getattr(args, "models_dir", None):
        os.environ["SVT_MODELS_DIR"] = args.models_dir
    name = args.model
    kw = dict(beam_size=args.beam, compute_dtype=args.dtype, device=args.device)
    if os.path.isdir(name):
        return load_asr_model(name, **kw)
    big = "68" in name or "2025" in name
    model_dir = assets.asr_model_dir("zipformer-68m" if big else "zipformer-30m")
    if model_dir is not None:
        return load_asr_model(model_dir, **kw)
    # Refuse silent garbage: random weights only behind an explicit flag.
    assets.require_real_or_allowed(f"ASR model {name}", args.allow_random)
    return random_asr_model(MODEL_68M if big else MODEL_30M, **kw)


def cmd_transcribe(args):
    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.registry import (
        MODEL_68M,
        model_device,
        random_asr_model,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.asr_json import (
        save_asr_json,
        serialize_segments,
    )
    from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import (
        TranscriberPipeline,
    )

    device = model_device(args.device)
    model_dir = args.model if os.path.isdir(args.model) else None
    model = _load_model(args)
    if args.hotwords_file:
        from sherpa_vietnamese_asr_tpu_torch.utils.config import (
            build_hotword_tables_for_model,
        )
        tables, kept = build_hotword_tables_for_model(
            model_dir or ".", model.rnnt_cfg.vocab_size,
            hotwords_file=args.hotwords_file,
            default_score=args.hotwords_score)
        if tables is None:
            print("[cli] hotwords requested but no usable hotword file / "
                  "bpe.model found; continuing without", file=sys.stderr)
        else:
            model = dataclasses.replace(model, hotword_tables=tables).to(device)
            print(f"[cli] hotword boosting active for {len(kept)} phrases",
                  file=sys.stderr)
    if args.rover:
        model = (model, random_asr_model(MODEL_68M, beam_size=args.beam,
                                         device=device))

    config = {
        "speaker_diarization": args.diarize,
        "restore_punctuation": args.punctuate,
        "max_batch": args.max_batch,
        "preprocess_rms_normalize": args.rms_normalize,
        "preprocess_wpe": args.wpe,
        "bypass_vad": args.no_vad,
        "enable_resume": args.enable_resume,
    }

    def progress(msg):
        if args.verbose and msg.startswith("PHASE:"):
            print(msg, file=sys.stderr)

    diarizer = None
    if args.diarize:
        from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import (
            PureDiarizer,
        )
        diarizer = PureDiarizer(num_speakers=args.num_speakers or -1,
                                model_dir=model_dir, device=device)
    punct_restorer = None
    if args.punctuate:
        from sherpa_vietnamese_asr_tpu_torch.pipeline.punctuation import (
            build_punctuation_restorer,
        )
        punct_restorer = build_punctuation_restorer(model_dir=model_dir, device=device)
    quality_analyzer = None
    if args.quality:
        from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer
        quality_analyzer = QualityAnalyzer(device=device)
    pipeline = TranscriberPipeline(args.audio, model, config,
                                   progress_callback=progress,
                                   diarizer=diarizer, punct_restorer=punct_restorer,
                                   quality_analyzer=quality_analyzer)
    t0 = time.time()
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            result = pipeline.run()
        prof.export_chrome_trace(args.profile)
        print(f"[cli] profiler trace written to {args.profile}",
              file=sys.stderr)
    else:
        result = pipeline.run()
    dt = time.time() - t0
    if result is None:
        print("cancelled", file=sys.stderr)
        return 1
    print(result["text"])
    rtfx = result["duration_sec"] / max(dt, 1e-6)
    print(f"[cli] {result['duration_sec']:.1f}s audio in {dt:.1f}s "
          f"({rtfx:.1f}x realtime), {len(result['segments'])} segments",
          file=sys.stderr)
    out_path = args.output or (args.audio + ".asr.json")
    data = serialize_segments(result["segments"],
                              model_name=getattr(model, "name", "rover"),
                              duration_sec=result["duration_sec"],
                              timing=result["timing"],
                              overlap_segments=result["overlap_segments"])
    data["text"] = result["text"]
    save_asr_json(out_path, data)
    print(f"[cli] wrote {out_path}", file=sys.stderr)
    return 0


def cmd_serve(args):
    from sherpa_vietnamese_asr_tpu_torch.models.registry import MODEL_30M, model_device
    from sherpa_vietnamese_asr_tpu_torch.web_service.server import make_server

    device = model_device(args.device)
    models = {}
    lock = threading.Lock()

    def model_provider(name):
        key = name or MODEL_30M
        with lock:  # the queue worker and the websocket handlers both ask
            if key not in models:
                ns = argparse.Namespace(model=key, beam=8, dtype="float32",
                                        device=device,
                                        allow_random=args.allow_random,
                                        models_dir=args.models_dir)
                models[key] = _load_model(ns)
            return models[key]

    # --http forces plain HTTP; otherwise the persisted server config
    # decides (http_mode, reference default: HTTPS with a self-signed cert)
    server, state = make_server(host=args.host, port=args.port,
                                data_dir=args.data_dir,
                                model_provider=model_provider,
                                use_tls=False if args.http else None,
                                device=device)
    if args.warmup:
        from sherpa_vietnamese_asr_tpu_torch.pipeline.warmup import warmup_programs

        t0 = time.time()
        print("[serve] warmup: decode, streaming, diarization, punctuation...")
        warmup_programs(model_provider(None), models_dir=args.models_dir,
                        stages=("decode", "streaming", "diarization",
                                "punctuation"),
                        log=lambda m: print(f"[serve] {m}"),
                        streamer=state.get_streamer())
        print(f"[serve] warmup done in {time.time() - t0:.0f}s")
    scheme = "https" if getattr(state, "tls_active", False) else "http"
    print(f"[serve] listening on {scheme}://{args.host}:"
          f"{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        state.shutdown()
    return 0


def cmd_warmup(args):
    """Each serving stage once on the card (pipeline/warmup.py), so that a
    later request finds the kernel library built and the libraries'
    first-use costs paid."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline.warmup import STAGES, warmup_programs

    stages = tuple(args.stages.split(",")) if args.stages else STAGES
    t0 = time.time()
    model = _load_model(args)
    timings = warmup_programs(model, models_dir=args.models_dir,
                              stages=stages, jobs=args.jobs)
    done = [k for k, v in timings.items() if v is not None]
    print(f"[warmup] {len(done)}/{len(timings)} stages ran "
          f"({', '.join(done)}) in {time.time() - t0:.0f}s on {model.device}")
    return 0


def cmd_calibrate(args):
    from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device
    from sherpa_vietnamese_asr_tpu_torch.pipeline.calibration import (
        auto_batch_size,
        autotune_max_batch,
        run_device_calibration,
        run_full_pipeline_calibration,
    )

    device = model_device(args.device)
    report = run_device_calibration(progress_callback=print)
    if args.full:
        # Reference-style end-to-end compare: one real pipeline run on the
        # device and one on the CPU (core/calibration.py:1395-1560).
        report["full_pipeline"] = run_full_pipeline_calibration(
            minutes=args.full_minutes,
            confidence_tol=args.confidence_tol,
            progress_callback=print, device=device)
    if args.autotune:
        # Reference batch autotune (core/calibration.py:968) + memory-aware
        # sizing (hardware_accel.py:639-678) over the card's free memory.
        cands = tuple(int(x) for x in args.candidates.split(","))
        tune = autotune_max_batch(candidates=cands, progress_callback=print,
                                  device=device)
        report["batch_autotune"] = tune
        report["recommended"] = {
            "max_batch": tune["best_batch"]
            or auto_batch_size("decode", 8, device=device),
            "embedding_batch": auto_batch_size("embedding", 16, device=device),
            "vibert_batch": auto_batch_size("vibert", 16, device=device),
            "campp_batch": auto_batch_size("campp", 32, device=device),
        }
    with open(args.output, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items() if k != "stages"}))
    print(f"wrote {args.output}")
    return 0


def cmd_verify_assets(args):
    """Real-asset rehearsal (models/verify_assets.py): hash -> import ->
    forward on the device -> graph-executor cross-check -> token parity,
    per asset."""
    from sherpa_vietnamese_asr_tpu_torch.models.verify_assets import (
        format_report,
        verify_assets,
    )

    keys = args.asset or None
    report = verify_assets(keys, device=args.device)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(format_report(report))
    return 0 if report["ok"] else 1


def cmd_install_service(args):
    """Write a systemd unit (reference service_installer.py installs a
    Windows service; this is the Linux analogue)."""
    import shutil

    unit = f"""[Unit]
Description=Vietnamese ASR API server (PyTorch/CUDA)
After=network.target

[Service]
Type=simple
ExecStart={shutil.which("python3") or "/usr/bin/python3"} -m \
sherpa_vietnamese_asr_tpu_torch.cli serve --host 0.0.0.0 --port {args.port} \
--data-dir {args.data_dir}
WorkingDirectory={os.path.dirname(os.path.dirname(os.path.abspath(__file__)))}
Restart=on-failure
RestartSec=5

[Install]
WantedBy=multi-user.target
"""
    with open(args.output, "w") as f:
        f.write(unit)
    print(f"wrote {args.output}; install with:\n"
          f"  sudo cp {args.output} /etc/systemd/system/ && "
          "sudo systemctl enable --now svt-asr")
    return 0


def cmd_monitor(args):
    """RAM/CPU/disk sampler (reference resource_monitor.py equivalent)."""
    import csv
    import resource

    out = open(args.output, "w", newline="") if args.output else None
    writer = csv.writer(out) if out else None
    if writer:
        writer.writerow(["t", "rss_mb", "cpu_user_s", "cpu_sys_s"])
    t0 = time.time()
    try:
        for _ in range(args.samples):
            ru = resource.getrusage(resource.RUSAGE_SELF)
            rss_mb = ru.ru_maxrss / 1024
            row = [round(time.time() - t0, 1), round(rss_mb, 1),
                   round(ru.ru_utime, 2), round(ru.ru_stime, 2)]
            print(f"t={row[0]}s rss={row[1]}MB user={row[2]}s sys={row[3]}s")
            if writer:
                writer.writerow(row)
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        if out:
            out.close()
    return 0


def cmd_bench(args):
    from sherpa_vietnamese_asr_tpu_torch import bench

    argv = ["--device", args.device, "--minutes", str(args.minutes)]
    if args.n_batches is not None:
        argv += ["--n-batches", str(args.n_batches)]
    bench.main(argv)
    return 0


def _device_arg(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device; the default needs a card, 'cpu' "
                             "runs every kernel's plain PyTorch twin")


def build_parser():
    p = argparse.ArgumentParser(
        prog="svt-torch",
        description="Vietnamese ASR on an NVIDIA GPU (PyTorch/CUDA port)")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("transcribe", help="transcribe an audio file")
    t.add_argument("audio")
    t.add_argument("--model", default="zipformer-30m-rnnt-6000h",
                   help="model dir (with ONNX + tokens.txt) or model id")
    t.add_argument("--beam", type=int, default=8)
    t.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="encoder compute dtype; bfloat16 transcripts are "
                        "not bit-identical to float32")
    _device_arg(t)
    t.add_argument("--rover", action="store_true")
    t.add_argument("--diarize", action="store_true")
    t.add_argument("--num-speakers", type=int, default=0)
    t.add_argument("--punctuate", action="store_true")
    t.add_argument("--quality", action="store_true",
                   help="DNSMOS audio-quality analysis")
    t.add_argument("--hotwords-file", default=None,
                   help="hotword phrases file (one per line, optional "
                        ":score suffix); needs bpe.model in the model dir")
    t.add_argument("--hotwords-score", type=float, default=1.5)
    t.add_argument("--max-batch", type=int, default=8)
    t.add_argument("--rms-normalize", action="store_true")
    t.add_argument("--wpe", action="store_true")
    t.add_argument("--no-vad", action="store_true")
    t.add_argument("--output", default=None)
    t.add_argument("--profile", default=None,
                   help="write a torch.profiler Chrome trace to this file")
    t.add_argument("--resume", "--enable-resume", dest="enable_resume",
                   action="store_true",
                   help="resume from a .asr_ckpt.json if present")
    t.add_argument("--models-dir", default=None,
                   help="root of downloaded model assets "
                        "(default: $SVT_MODELS_DIR or ./models)")
    t.add_argument("--allow-random", action="store_true",
                   help="permit RANDOM-weight models when no checkpoint is "
                        "found (output is garbage; tests/benchmarks only)")
    t.add_argument("-v", "--verbose", action="store_true")
    t.set_defaults(fn=cmd_transcribe)

    s = sub.add_parser("serve", help="run the HTTP API server")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--data-dir", default="web_data")
    s.add_argument("--warmup", action="store_true",
                   help="run the decode, streaming, diarization and "
                        "punctuation stages once before accepting requests")
    s.add_argument("--http", action="store_true",
                   help="plain HTTP (default: TLS with a self-signed cert "
                        "unless server config sets http_mode=1)")
    s.add_argument("--models-dir", default=None)
    s.add_argument("--allow-random", action="store_true",
                   help="permit RANDOM-weight models (garbage output; "
                        "tests/benchmarks only)")
    _device_arg(s)
    s.set_defaults(fn=cmd_serve)

    w = sub.add_parser(
        "warmup",
        help="run every serving stage once (builds the kernel library and "
             "pays the libraries' first-use costs)")
    w.add_argument("--model", default="zipformer-30m-rnnt-6000h")
    w.add_argument("--beam", type=int, default=8)
    w.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    w.add_argument("--models-dir", default=None)
    w.add_argument("--allow-random", action="store_true",
                   help="warm with random weights when no checkpoints "
                        "exist")
    w.add_argument("--stages", default=None,
                   help="comma-separated subset of: decode,vad,streaming,"
                        "diarization,punctuation,quality,senko")
    w.add_argument("--jobs", type=int, default=1,
                   help="stages run concurrently on a thread pool; they "
                        "share one card, so 1 (sequential) is the default")
    _device_arg(w)
    w.set_defaults(fn=cmd_warmup)

    c = sub.add_parser("calibrate", help="device calibration report")
    c.add_argument("--output", default="calibration_report.json")
    c.add_argument("--autotune", action="store_true",
                   help="time decode batch sizes and emit recommended "
                        "max_batch per stage")
    c.add_argument("--candidates", default="8,16,32,48,64,96",
                   help="comma-separated batch sizes to time")
    c.add_argument("--full", action="store_true",
                   help="also run the full pipeline on the device and on "
                        "the CPU on a synthetic 10-min sample and compare "
                        "wall/stage speedups + output parity (reference "
                        "core/calibration.py:1395-1560)")
    c.add_argument("--full-minutes", type=float, default=10.0)
    c.add_argument("--confidence-tol", type=float, default=1e-4,
                   help="asr_confidence parity gate (reference default "
                        "1e-4; widen for random-weight rehearsals)")
    _device_arg(c)
    c.set_defaults(fn=cmd_calibrate)

    va = sub.add_parser(
        "verify-assets",
        help="verify downloaded checkpoints: pinned hashes, importer "
             "mapping, forward on the device, numpy graph-executor "
             "cross-check, decode token parity")
    va.add_argument("--asset", action="append",
                    help="restrict to one asset key (repeatable); "
                         "default: all")
    va.add_argument("--json", action="store_true")
    _device_arg(va)
    va.set_defaults(fn=cmd_verify_assets)

    sv = sub.add_parser("install-service",
                        help="write a systemd unit for the API server "
                             "(reference service_installer.py analogue)")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--data-dir", default="/var/lib/svt-asr")
    sv.add_argument("--output", default="svt-asr.service")
    sv.set_defaults(fn=cmd_install_service)

    m = sub.add_parser("monitor", help="resource monitor")
    m.add_argument("--interval", type=float, default=1.0)
    m.add_argument("--samples", type=int, default=60)
    m.add_argument("--output", default=None)
    m.set_defaults(fn=cmd_monitor)

    b = sub.add_parser("bench", help="print one JSON line of decode and "
                                     "full-pipeline RTFx on the device")
    b.add_argument("--n-batches", type=int, default=None,
                   help="timed decode batches a tier (default: 5 on a card)")
    b.add_argument("--minutes", type=float, default=10.0,
                   help="length of the full-pipeline file")
    _device_arg(b)
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
