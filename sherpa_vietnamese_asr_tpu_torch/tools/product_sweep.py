"""Time the whole-layer kernel's linear products at every tile width on a CUDA card.

Run from the repository root:

    python3 -m sherpa_vietnamese_asr_tpu_torch.tools.product_sweep [--reps 20]

It builds csrc/encoder_layer.cu once more with a C entry point that runs one
linear product alone (product_kernel with the kStore epilogue), then for
each distinct linear of a Zipformer-30M layer at the six stack shapes of the
bf16 slice (B 8, 33 s chunks) runs every width of ops/encoder_layer.LINEAR_BN
on random bf16 operands: it checks the output against the twin's _linear16
(within one bf16 rounding of the f32 sum) and takes the kernel's device time
from torch.profiler. It prints, per product, each width's microseconds, the
fastest and the width tile_plan picks, and the card's name and power limit
as nvidia-smi prints them. The last line is a JSON object with these
numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib
from sherpa_vietnamese_asr_tpu_torch.ops import encoder_layer as el

STACK_FRAMES = (1646, 823, 412, 206, 412, 823)  # t_ds of a 33 s chunk
ENTRY = r"""
#include "{source}"
extern "C" int svt_linear_alone(const int* plan, const void* a, const void* wt,
                                const void* bias, int M, int K, int N, void* out, int sms,
                                void* stream) {{
  ProdArgs p = {{}};
  p.bias = static_cast<const bf16*>(bias);
  p.out = static_cast<bf16*>(out);
  p.ldo = N;
  return (int)linear(*reinterpret_cast<const Plan*>(plan), kStore,
                     static_cast<const bf16*>(a), static_cast<const bf16*>(wt), M, K, N, p,
                     sms, (cudaStream_t)stream);
}}
"""


def build_entry():
    """svt_linear_alone from a build of csrc/encoder_layer.cu in build/product_sweep/."""
    out_dir = cuda_lib.BUILD_DIR.parent / "product_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "linear_alone.cu"
    src.write_text(ENTRY.format(source=cuda_lib.CSRC_DIR / "encoder_layer.cu"))
    lib = out_dir / "liblinear_alone.so"
    proc = subprocess.run([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).svt_linear_alone
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, p, i, p]
    fn.restype = i
    return fn


def stack_products(stack):
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer import ZIPFORMER_30M as cfg

    d, ff = cfg.encoder_dim[stack], cfg.ffn_dim[stack]
    t_pad = -(-STACK_FRAMES[stack] // el.R) * el.R
    return el.layer_products(8, t_pad, d, cfg.num_heads[stack], cfg.query_head_dim,
                             cfg.pos_head_dim, cfg.value_head_dim, 3 * d // 4, ff * 3 // 4, ff,
                             ff * 5 // 4)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import profile_calls

    if not torch.cuda.is_available():
        raise SystemExit("product_sweep: needs a CUDA card")
    fn = build_entry()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, seen = [], set()
    for stack in range(len(STACK_FRAMES)):
        for p in stack_products(stack):
            if p.attend or (p.m, p.n, p.k) in seen:
                continue
            seen.add((p.m, p.n, p.k))
            a = torch.randn((p.m, p.k), generator=gen, device=dev).to(torch.bfloat16)
            w = (torch.randn((p.k, p.n), generator=gen, device=dev) / p.k ** 0.5) \
                .to(torch.bfloat16)
            bias = (0.1 * torch.randn(p.n, generator=gen, device=dev)).to(torch.bfloat16)
            wt, out = w.t().contiguous(), torch.empty((p.m, p.n), dtype=torch.bfloat16,
                                                      device=dev)
            ref = el._linear16(a, w, bias).float()
            times = {}
            for bn in el.LINEAR_BN:
                stages = min(el.MAX_STAGES, (el.SMEM_LIMIT - 1024) // ((el.BM + bn) * el.BK * 2
                                                                       + 16))
                plan = (ctypes.c_int * 4)(el.BM, bn, el.LINEAR_NW, stages)

                def run():
                    cuda_lib.check(fn(plan, a.data_ptr(), wt.data_ptr(), bias.data_ptr(), p.m,
                                      p.k, p.n, out.data_ptr(), sms, stream), "svt_linear_alone")

                run()
                # one bf16 rounding of |y| <= 8, and the bias add's
                err = float((out.float() - ref).abs().max())
                assert err <= 2 ** -4 * 2, f"{p.name} width {bn}: max |kernel - twin| {err}"
                _, per_name, _ = profile_calls(run, reps=args.reps)
                times[bn] = 1e3 * sum(v for k, v in per_name.items() if "product_kernel" in k)
            pick = el.tile_plan(p, sms).bn
            fastest = min(times, key=times.get)
            rows.append({"stack": stack, "name": p.name, "m": p.m, "n": p.n, "k": p.k,
                         "us": times, "fastest": fastest, "picked": pick})
            print(f"stack {stack} {p.name:10s} M {p.m} N {p.n} K {p.k}: " + " ".join(
                f"{bn}:{us:.1f}" for bn, us in times.items()) + f" us; fastest {fastest}, "
                f"tile_plan {pick} ({times[pick] / times[fastest]:.3f}x)", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"card": smi, "reps": args.reps, "products": rows}))


if __name__ == "__main__":
    main()
