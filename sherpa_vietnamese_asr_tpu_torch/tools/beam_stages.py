"""Split the beam kernel's frame time by step on a CUDA card.

Run from the repository root:

    python3 -m sherpa_vietnamese_asr_tpu_torch.tools.beam_stages [--rounds 7]

It builds csrc/beam_search.cu alone once per SVT_BEAM_CUT mask (the
kernel's timing switch: 0 is the kernel as shipped, each other mask skips
steps of every frame and gives wrong results), one nvcc per build, all
started together. Then it times every build on the beam check's shapes of
chip_smoke.py: the random-weight Zipformer-30M RNN-T (seed 0, vocab 2000),
B 8, T 823, beam 8, lens BEAM_LENS_823, N(0, 1) encoder frames. The builds
take turns, one launch each a round, timed with CUDA events; medians over
the rounds. It prints each build's median ms and us a frame of the longest
row, what each cut step costs (shipped minus cut), and the card's name and
power limit as nvidia-smi prints them. The last line is a JSON object with
these numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib

# build name -> SVT_BEAM_CUT mask (bits of csrc/beam_search.cu kCut*)
CUTS = {"shipped": 0, "no vocab product": 1, "no hidden layer": 2,
        "no leader merge": 4, "no softmax or top-k": 8,
        "decoder conv and barriers only": 15}
LENS = [823, 611, 1, 823, 402, 0, 823, 77]  # chip_smoke.BEAM_LENS_823


def build_entries(builds, out_dir, symbol="svt_beam_search"):
    """{name: C entry `symbol`} of standalone builds of one source, one nvcc
    each, all started together. builds: {name: (source, nvcc flags)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_lib.find_nvcc()
    jobs = {}
    for i, (name, (src, flags)) in enumerate(builds.items()):
        lib = out_dir / f"lib{symbol}_{i}.so"
        cmd = [nvcc, *cuda_lib.NVCC_FLAGS, *flags, "-o", str(lib), str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = cuda_lib.SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    from sherpa_vietnamese_asr_tpu_torch.models.registry import random_asr_model
    from sherpa_vietnamese_asr_tpu_torch.ops.beam_search_cuda import _beam_search_cuda

    if not torch.cuda.is_available():
        raise SystemExit("beam_stages: needs a CUDA card")
    dev = torch.device("cuda", 0)
    src = cuda_lib.CSRC_DIR / "beam_search.cu"
    fns = build_entries({name: (src, [f"-DSVT_BEAM_CUT={mask}"]) for name, mask in CUTS.items()},
                        cuda_lib.BUILD_DIR.parent / "beam_stages")
    model = random_asr_model(vocab_size=2000, beam_size=8, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(2)
    enc = torch.randn((len(LENS), 823, model.rnnt_cfg.encoder_out_dim), generator=gen).to(dev)
    lens = torch.tensor(LENS, dtype=torch.int32, device=dev)

    def launch(fn):
        return _beam_search_cuda(enc, lens, model.decoder, model.joiner, model.rnnt_cfg, 8,
                                 None, entry=fn)

    for fn in fns.values():  # warm-up
        launch(fn)
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(args.rounds):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(fn)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    ms = {name: float(np.median(t)) for name, t in times.items()}
    frames = max(LENS)
    for name, t in ms.items():
        cost = ms["shipped"] - t
        print(f"{name:32s} {t:9.3f} ms  {1e3 * t / frames:7.2f} us a frame"
              + ("" if name == "shipped" else
                 f"  step cost {cost:8.3f} ms, {1e3 * cost / frames:6.2f} us a frame"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"card": smi, "frames": frames, "rounds": args.rounds, "ms": ms}))


if __name__ == "__main__":
    main()
