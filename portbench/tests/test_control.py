"""The control fails the check: the reference put in the program's place,
one precision step below the configuration's (TF32 for float32, fp8 for
the bfloat16 encoder), judged against the cell's limits, at the cell's
widths on shorter traffic. On the card only: TF32 exists there alone."""

import tempfile

import pytest

from portbench.harness import cell, check_live, check_offline, traffic, weights
from portbench.harness.offline import OfflineCell

pytestmark = pytest.mark.card

SHORTER = {"longform": {"durations_s": [90, 60], "check_requests": 2},
           "uploads": {"lognormal_s": {"median": 15, "sigma": 0.8, "min": 3, "max": 90, "count": 4},
                       "check_requests": 2}}


def failed(checks, limits):
    return [k for k, lim in limits.items() if not checks[k] <= lim]


@pytest.mark.parametrize("workload", ["zipformer30m-fp32.longform", "zipformer68m-bf16.longform",
                                      "zipformer30m-fp32.uploads"])
def test_offline_control_is_not_correct(workload, card):
    _, _, cfg, mix, limits = cell.spec(workload)
    mix = dict(mix, **SHORTER[mix_name(workload)])
    oc = OfflineCell(cfg, mix, 41, card)
    with tempfile.TemporaryDirectory(prefix="portbench-") as work:
        oc.setup(work)
        requests = [(oc.pool[i][0], check_offline.control_outputs(cfg, oc.weights, oc.vad_weights,
                                                                   oc.pool[i][0], card, cfg["control"]))
                    for i in oc.sample]
        checks = check_offline.judge_all(cfg, oc.weights, oc.vad_weights, requests, card)
    assert failed(checks, limits), checks


def test_live_control_is_not_correct(card):
    _, _, cfg, mix, limits = cell.spec("zipformer30m-fp32.live8")
    _, w = weights.asr_model(cfg, 41, card)
    streams = traffic.live_streams(mix, 41, 4.0)
    enc, served = check_live.control_outputs(cfg, w, streams, [6] * len(streams), card, cfg["control"]["encoder"])
    checks = check_live.judge(cfg, w, streams, enc, served, card)
    assert failed(checks, limits), checks


def mix_name(workload):
    return workload.split(".")[1]
