"""The control fails the check: the reference put in the program's place,
one precision step below the configuration's (TF32 for float32, fp8 for
the bfloat16 encoder; TF32 for the meeting cell's stage models), judged
against the cell's limits, at the cell's widths on shorter traffic. On the
card only: TF32 exists there alone."""

import pytest

from portbench import readings
from portbench.harness import cell, check_live, traffic, weights

pytestmark = pytest.mark.card

SHORTER = {"longform": {"durations_s": [90, 60], "check_requests": 2},
           "uploads": {"lognormal_s": {"median": 15, "sigma": 0.8, "min": 3, "max": 90, "count": 4},
                       "check_requests": 2},
           "meeting": {"durations_s": [90, 60], "check_requests": 2},
           "punctuated": {"durations_s": [90, 60], "check_requests": 2}}
# The stage models' numbers: the control fails one of them as well.
STAGE_CHECKS = ("seg_rel_err", "embed_cos_gap", "punct_logit_gap", "dnsmos_abs_err")


def failed(checks, limits):
    return [k for k, lim in limits.items() if not checks[k] <= lim]


@pytest.mark.parametrize("workload", ["zipformer30m-fp32.longform", "zipformer68m-bf16.longform",
                                      "zipformer30m-fp32.uploads", "zipformer30m-fp32.meeting",
                                      "zipformer30m-fp32.punctuated"])
def test_offline_control_is_not_correct(workload, card):
    _, _, cfg, mix, limits = cell.spec(workload)
    mix = dict(mix, **SHORTER[mix_name(workload)])
    checks = readings.offline_control_checks(cfg, mix, 41, card)
    assert failed(checks, limits), checks
    new = [k for k in STAGE_CHECKS if k in limits]
    assert not new or failed(checks, {k: limits[k] for k in new}), checks


def test_live_control_is_not_correct(card):
    _, _, cfg, mix, limits = cell.spec("zipformer30m-fp32.live8")
    _, w = weights.asr_model(cfg, 41, card)
    streams = traffic.live_streams(mix, 41, 4.0)
    enc, served = check_live.control_outputs(cfg, w, streams, [6] * len(streams), card, cfg["control"]["encoder"])
    checks = check_live.judge(cfg, w, streams, enc, served, card)
    assert failed(checks, limits), checks


def mix_name(workload):
    return workload.split(".")[1]
