"""Tests of the benchmark. Those marked `card` need a CUDA device and skip
without one; they decide inside the fixture, never at import.

    python -m pytest portbench/tests -q            # CPU: the rest
    python -m pytest portbench/tests -q -m card    # on a machine with a card
"""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(num_encoder_layers=[1, 1, 1], downsampling_factor=[1, 2, 4], encoder_dim=[64, 96, 96],
            ffn_dim=[96, 128, 128], num_heads=[2, 2, 2], cnn_module_kernel=[15, 15, 7],
            query_head_dim=16, pos_head_dim=4, value_head_dim=8, pos_dim=16,
            decoder_dim=128, joiner_dim=128, vocab_size=100,
            attention_weights="float32")  # the CPU twin of kernel 2 keeps float32 weights
# The stage models of the tiny preset (the tests' widths of the program's
# own tests: TINY_RESNET, TINY_VIBERT, a small PyanNet; DNSMOS at full width).
TINY_WIDTHS = {"segmentation": dict(sinc_filters=16, conv_channels=12, lstm_hidden=16, lstm_layers=2,
                                    linear_dim=16),
               "embedding": dict(base_channels=8, blocks=[1, 1, 1, 1], embed_dim=32),
               "punctuation": dict(vocab_size=200, hidden=32, layers=2, heads=2, intermediate=64,
                                   max_position=128)}


def _tiny_stages():
    with open(os.path.join(ROOT, "portbench", "configs", "zipformer30m-fp32.json")) as f:
        stages = json.load(f)["stages"]
    return {name: dict(e, widths=dict(e["widths"], **TINY_WIDTHS.get(name, {}))) for name, e in stages.items()}


TINY["stages"] = _tiny_stages()
# Short traffic of each mix for CPU runs of the tiny preset.
SHORT = {"longform": {"durations_s": [20, 40], "check_requests": 2, "trace_requests": 1},
         "uploads": {"lognormal_s": {"median": 8, "sigma": 0.5, "min": 3, "max": 20, "count": 4},
                     "check_requests": 2, "trace_requests": 1},
         "live8": {"streams": 2, "margin_s": 2.0, "trace_steps": 2},
         "meeting": {"durations_s": [40, 25], "check_requests": 2, "trace_requests": 1},
         "punctuated": {"durations_s": [40, 25], "check_requests": 2, "trace_requests": 1}}

# Limits of the CPU runs: the program's plain twins on the CPU against the
# reference (the twin's fbank is a DFT by products: 1e-3 from the FFT).
CPU_LIMITS = {"vad_max_abs": 1e-5, "plan_mismatches": 0, "fbank_rel_err": 1e-3,
              "embed_rel_err": 1e-4, "encoder_rel_err": 1e-3, "encoder_pooled_rel_err": 1e-3,
              "token_logp_gap": 1e-4, "beam_path_deficit": 1e-4,
              "stream_enc_rel_err": 1e-4, "greedy_gap": 1e-4,
              "seg_rel_err": 5e-6, "embed_cos_gap": 1e-8, "punct_logit_gap": 1e-4, "dnsmos_abs_err": 3e-5}


# The bfloat16 encoder's plain layer (position scores in bf16 too): 1e-2.
CPU_LIMITS_BF16 = dict(CPU_LIMITS, embed_rel_err=3e-2, encoder_rel_err=3e-2, encoder_pooled_rel_err=3e-2)


def cpu_limits(workload):
    from portbench.harness import cell

    _, _, cfg, _, limits = cell.spec(workload)
    table = CPU_LIMITS_BF16 if cfg["compute_dtype"] == "bfloat16" else CPU_LIMITS
    return {k: table[k] for k in limits}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
