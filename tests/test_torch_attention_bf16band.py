# The port's bf16-band attention weights (sherpa_vietnamese_asr_tpu_torch/
# ops/attention.py attention_weights_bf16band, plain twin on the CPU) against
# the TPU probe kernel benchmarks/_skewbf16.py _attn_kernel_t_bf16band in
# interpret mode, and the probe tool tools/skew_bf16 on the CPU.
#
# benchmarks/_skewbf16.py runs its whole benchmark at import (its top level
# reads sys.argv and builds stack-0 inputs), so only its imports and its two
# functions are taken from the file's syntax tree and executed.
import ast
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sherpa_vietnamese_asr_tpu_torch.ops import attention as tatt
from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib
from sherpa_vietnamese_asr_tpu_torch.tools import skew_bf16

torch.set_num_threads(2)

PROBE = Path(__file__).resolve().parents[1] / "benchmarks" / "_skewbf16.py"
HEADS, PD = 2, 4
# Every weight within the bf16 rounding of its reference: unit roundoff
# 2**-8 plus 2**-12 of float32 slack (chip_smoke.py's attention gate).
GATE = 2**-8 + 2**-12
CASES = [(128, 32), (128, 16), (256, 32), (256, 16)]  # (T, qd)


@functools.lru_cache(maxsize=1)
def _probe_functions():
    tree = ast.parse(PROBE.read_text(), str(PROBE))
    keep = ("_attn_kernel_t_bf16band", "attn_weights_bf16band")
    tree.body = [n for n in tree.body
                 if isinstance(n, (ast.Import, ast.ImportFrom))
                 or (isinstance(n, ast.FunctionDef) and n.name in keep)]
    scope = {"__name__": "skewbf16_functions"}
    exec(compile(tree, str(PROBE), "exec"), scope)
    assert scope["ROW_BLOCK"] == skew_bf16.ROW_BLOCK
    return scope["attn_weights_bf16band"]


def _inputs(t, qd):
    """The probe's tensors at a small size, batch 3 (skew_bf16.probe_inputs:
    standard normal q, k, p [BH, T, qd|pd], position table [H, 2T-1+R, pd]),
    with lens full, ragged and 0."""
    rng = np.random.default_rng(t + qd)
    q, k, p, pos, _ = skew_bf16.probe_inputs(rng, 3, t, HEADS, qd, PD)
    return q, k, p, pos, np.asarray([t, t // 2 + 13, 0], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_kernel5(t, qd):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    fn = _probe_functions()
    q, k, p, pos, lens = _inputs(t, qd)
    with pltpu.force_tpu_interpret_mode():
        out = fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(p),
                 jnp.asarray(pos), jnp.asarray(lens), HEADS)
    return np.asarray(out, np.float32).reshape(-1, HEADS, t, t)


def _port(fn, t, qd):
    """fn (a twin or wrapper) on the probe's inputs, through the port's
    arguments (skew_bf16.port_args: the position table's rows 0..2T-2, the
    rows the kernel reads, as pos_emb with an identity projection)."""
    with torch.no_grad():
        return fn(*skew_bf16.port_args(_inputs(t, qd), HEADS, "cpu")).numpy()


def _ratio(got, ref):
    return np.abs(got - ref) / (GATE * np.abs(ref) + 1e-6)


@pytest.mark.parametrize("t,qd", CASES)
def test_twin_matches_jax_kernel5(t, qd):
    """The rounded-band twin is within bf16 rounding of the TPU probe kernel
    at every weight (masked keys and the lens-0 row included)."""
    ref = _jax_kernel5(t, qd)
    got = _port(tatt.attention_weights_bf16band_plain, t, qd)
    assert got.shape == ref.shape == (3, HEADS, t, t)
    assert _ratio(got, ref).max() <= 1.0
    np.testing.assert_allclose(got[2], 1.0 / t, atol=1e-7)


# Near-misses of the twin: kernel 2's (the band left in float32), and
# pos_dtype=bfloat16 (the position table and pq rounded, the band computed in
# bf16: the JAX package's XLA-path option, not this kernel).
WRONG_TWINS = {
    "band_unrounded": tatt.attention_weights_plain,
    "inputs_rounded": functools.partial(tatt.attention_weights_plain,
                                        pos_dtype=torch.bfloat16),
}


@pytest.mark.parametrize("wrong", sorted(WRONG_TWINS))
@pytest.mark.parametrize("t,qd", CASES)
def test_wrong_twins_fail_the_gate(wrong, t, qd):
    """Each near-miss is beyond the same gate on at least 1% of the weights:
    the gate tells the kernel's rounding apart from both."""
    ref = _jax_kernel5(t, qd)
    got = _port(WRONG_TWINS[wrong], t, qd)
    assert (_ratio(got, ref) > 1.0).mean() >= 0.01


def test_cpu_tensor_runs_plain_twin_without_launch(monkeypatch):
    def no_library():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    tatt.bf16band_launches = 0
    got = _port(tatt.attention_weights_bf16band, 128, 16)
    assert tatt.bf16band_launches == 0
    np.testing.assert_array_equal(
        got, _port(tatt.attention_weights_bf16band_plain, 128, 16))


def test_probe_tool_on_cpu(capsys):
    """tools/skew_bf16 --device cpu runs the two twins at a tiny shape:
    non-zero drift between them, each wrapper equal to its twin, no time."""
    rows = skew_bf16.main(["--device", "cpu", "--batch", "2",
                           "--shape", "tiny:128:2:16:4"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"] == "cpu" and last["shapes"] == rows
    (row,) = rows
    assert row["name"] == "tiny" and row["kernel_ms"] is row["device_ms"] is None
    assert 0.0 < row["drift_mean"] <= row["drift_max"] < 2e-2
    assert row["band_f32"]["max_abs"] == row["band_bf16"]["max_abs"] == 0.0
    assert row["bf16band_launches"] == 0
