"""What the benchmark imports: nothing of JAX or the JAX package, by the
top-level name of each module (the part before the first dot, compared
whole: the port's name begins with the JAX package's); the reference
nothing of the port either."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for name in {modules!r}:
    __import__(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
HARNESS = ["portbench.harness.cell", "portbench.harness.offline", "portbench.harness.live",
           "portbench.harness.check_offline", "portbench.harness.check_live",
           "portbench.harness.weights", "portbench.harness.readers", "portbench.readings"] + [
    "portbench.harness.stages." + m for m in ("pyannet", "resnet_speaker", "vibert", "dnsmos")]
REFERENCE = ["portbench.reference." + m for m in
             ("host", "vad", "fbank", "zipformer", "streaming", "rnnt", "precision",
              "pyannet", "resnet_speaker", "vibert", "dnsmos")]


def top_level_modules(modules):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, modules=modules)],
                         capture_output=True, text=True, check=True, cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("modules", [HARNESS, REFERENCE], ids=["harness", "reference"])
def test_no_jax_and_no_jax_package(modules):
    loaded = top_level_modules(modules)
    assert not loaded & {"jax", "jaxlib", "flax", "sherpa_vietnamese_asr_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    assert "sherpa_vietnamese_asr_tpu_torch" not in top_level_modules(REFERENCE)


def test_the_run_compares_whole_top_level_names(monkeypatch):
    import types

    from portbench.harness import cell

    monkeypatch.setitem(sys.modules, "sherpa_vietnamese_asr_tpu_torch.fake", types.ModuleType("x"))
    assert "sherpa_vietnamese_asr_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sherpa_vietnamese_asr_tpu.fake", types.ModuleType("y"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("z"))
    assert {"jax", "sherpa_vietnamese_asr_tpu"} <= set(cell.forbidden_modules())
