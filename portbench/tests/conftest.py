"""Tests of the benchmark. Those marked `card` need a CUDA device and skip
without one; they decide inside the fixture, never at import. A cell's CPU
preset is data: presets/configs/<config>.json and presets/traffic/<mix>.json.

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

PRESETS = os.path.join(ROOT, "portbench", "tests", "presets")


def preset(kind, name):
    """presets/configs/<config>.json or presets/traffic/<mix>.json: what a
    CPU run of the benchmark takes in place of the configuration's widths
    and limits or the mix's traffic."""
    with open(os.path.join(PRESETS, kind, f"{name}.json")) as f:
        return json.load(f)


def tiny(config):
    """The configuration's tiny widths: the preset's "tiny", and the
    configuration's stage models (if any) at the preset's "stage_widths"."""
    from portbench.harness import cell

    p = preset("configs", config)
    conf = next(c for c in cell.load_bench(ROOT)["configs"] if c["name"] == config)
    with open(os.path.join(ROOT, conf["file"])) as f:
        stages = json.load(f).get("stages")
    if stages is None:
        return dict(p["tiny"])
    widths = p["stage_widths"]
    return dict(p["tiny"], stages={name: dict(e, widths=dict(e["widths"], **widths.get(name, {})))
                                   for name, e in stages.items()})


def overrides(workload, form="short"):
    """cell.measure's overrides for a CPU run of the cell: the tiny widths,
    the CPU limits of the cell's numbers and the mix's traffic of that form
    ("short", "faults")."""
    from portbench.harness import cell

    _, entry, _, _, limits = cell.spec(workload)
    table = preset("configs", entry["config"])["cpu_limits"]
    return {"config": tiny(entry["config"]), "traffic": preset("traffic", entry["traffic"])[form],
            "limits": {k: table[k] for k in limits}}


TINY = tiny("zipformer30m-fp32")
TINY_WIDTHS = preset("configs", "zipformer30m-fp32")["stage_widths"]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
