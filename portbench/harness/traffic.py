"""The general traffic generator: a mix is a data file of parameters
(portbench/traffic/<name>.json) and this module turns it into requests or
streams from the seed. Every seed gets the same set of sizes, in another
order, so that the seed changes the content and order and not the work.

Offline mixes ("kind": "offline"): a pool of recordings, cycled in a
seed-drawn order by one closed-loop client. Their durations are either
"durations_s" (a list) or "lognormal_s" (the `count` quantiles of a
log-normal with that median and sigma, clipped to [min, max]); their
audio is the kind named by "content" with the mix's "content_params".
"options" is the dict handed to TranscriberPipeline with each request
({} when the mix has none).

Live mixes ("kind": "live"): `streams` streams fed `piece_s` pieces in real
time, each from a phase drawn within `phase_spread_s`.
"""

from __future__ import annotations

import json
import math
import os
import statistics

import numpy as np

from portbench.harness import audio as audio_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    with open(os.path.join(ROOT, "traffic", f"{name}.json")) as f:
        return json.load(f)


def durations(mix):
    """The pool's durations in seconds, in the file's order."""
    if "durations_s" in mix:
        return [float(d) for d in mix["durations_s"]]
    p = mix["lognormal_s"]
    n = p["count"]
    dist = statistics.NormalDist()
    return [round(min(p["max"], max(p["min"], p["median"] * math.exp(p["sigma"] * dist.inv_cdf((i + 0.5) / n)))), 2)
            for i in range(n)]


def rng(seed, stream):
    return np.random.default_rng([seed, stream])


def offline_pool(mix, seed):
    """[(duration_s, samples)] in the order the client sends them."""
    durs = durations(mix)
    order = rng(seed, 0).permutation(len(durs))
    make = audio_mod.KINDS[mix["content"]]
    params = mix.get("content_params", {})
    gen = rng(seed, 1)
    return [(durs[i], make(durs[i], gen, **params)) for i in order]


def live_streams(mix, seed, seconds):
    """[(phase_s, samples)] of each stream, long enough for the window and
    the margin."""
    make = audio_mod.KINDS[mix["content"]]
    gen = rng(seed, 2)
    phases = np.sort(rng(seed, 3).uniform(0.0, mix["phase_spread_s"], mix["streams"]))
    length = seconds + mix["margin_s"]
    return [(float(p), make(length, gen)) for p in phases]
