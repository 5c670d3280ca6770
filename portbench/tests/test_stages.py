"""Pipeline options from a traffic file and stage models from a
configuration: which stages a mix turns on, the options each request hands
the pipeline, the stage weights loading into the program's modules, the
existing cells' weights unchanged bit for bit, and each stage's plain
reference against the program's module on the CPU at tiny widths."""

import hashlib
import math

import numpy as np
import pytest
import torch

from conftest import TINY, TINY_WIDTHS
from portbench.harness import audio, cell, offline, stages, weights
from portbench.harness.stages import pyannet as seg_stage
from portbench.reference import dnsmos as ref_dnsmos
from portbench.reference import pyannet as ref_pyannet
from portbench.reference import resnet_speaker as ref_resnet
from portbench.reference import vibert as ref_vibert
from portbench.reference.precision import Precision

CPU = torch.device("cpu")
P = Precision("fp32")
MEETING = "zipformer30m-fp32.meeting"
# sha256 over the sorted names and bytes of the ASR model's and Silero's
# weights at seed 7 on the CPU, as the benchmark drew them before stage
# models existed.
DIGESTS = {"zipformer30m-fp32.longform": ("125e428dc601259d317615aeb6589c86b7326f7ce9094fcc77c7499d40cacddf",
                                          "974579f8366719a3e18893980a22b228effbe8d74d56ba83acb8e51aab2ce373"),
           "zipformer68m-bf16.longform": ("b55eec67cde50c1f3a232c5a7ce861a2c69c6f0dc40957064a366d26a6c7ef2e",
                                          "974579f8366719a3e18893980a22b228effbe8d74d56ba83acb8e51aab2ce373"),
           "zipformer30m-fp32.uploads": ("125e428dc601259d317615aeb6589c86b7326f7ce9094fcc77c7499d40cacddf",
                                         "974579f8366719a3e18893980a22b228effbe8d74d56ba83acb8e51aab2ce373")}


def digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def meeting():
    _, _, cfg, mix, _ = cell.spec(MEETING)
    return dict(cfg, stages=TINY["stages"]), mix


@pytest.mark.parametrize("options, names", [
    ({}, []),
    ({"speaker_diarization": True}, []),  # the pipeline's default speaker_model is not named
    ({"speaker_diarization": True, "speaker_model": "pure_ort"}, ["segmentation", "embedding"]),
    ({"speaker_diarization": True, "speaker_model": "senko_campp"}, []),
    ({"restore_punctuation": True, "quality_analysis": False}, ["punctuation"]),
    ({"speaker_diarization": True, "speaker_model": "pure_ort", "num_speakers": 0,
      "restore_punctuation": True, "quality_analysis": True},
     ["segmentation", "embedding", "punctuation", "quality"]),
])
def test_a_mixs_options_turn_on_the_stages_they_use(options, names):
    cfg, _ = meeting()
    assert [name for name, _ in stages.active(cfg, options)] == names


@pytest.mark.parametrize("workload", ["zipformer30m-fp32.longform", MEETING])
def test_each_request_hands_the_pipeline_the_mixs_options(workload, monkeypatch, tmp_path):
    from sherpa_vietnamese_asr_tpu_torch.pipeline import transcriber

    _, _, cfg, mix, _ = cell.spec(workload)
    seen = []

    class Pipeline:
        def __init__(self, path, model, config):
            seen.append(config)

        def run(self):
            return {"segments": [{}]}

    monkeypatch.setattr(transcriber, "TranscriberPipeline", Pipeline)
    oc = offline.OfflineCell(cfg, mix, 1, CPU)
    oc.pool = [(str(tmp_path / "a.wav"), 2.0)]
    oc.sample, oc.model = [], None
    oc.request(0)
    oc.warm()
    assert seen == [mix.get("options", {})] * 2
    assert ("options" in mix) == (workload == MEETING)
    assert (oc.stages != []) == (workload == MEETING)


@pytest.mark.parametrize("name, loader", [
    ("segmentation", "pyannet_from_numpy"), ("embedding", "resnet_from_numpy"),
    ("punctuation", "vibert_from_numpy"), ("quality", "dnsmos_from_numpy")])
def test_stage_weights_load_into_the_programs_module(name, loader):
    from sherpa_vietnamese_asr_tpu_torch.models import convert

    cfg, _ = meeting()
    entry = cfg["stages"][name]
    state, scfg = weights.stage(entry, 9, CPU)
    again, _ = weights.stage(entry, 9, CPU)
    other, _ = weights.stage(dict(entry, seed_offset=entry["seed_offset"] + 1), 9, CPU)
    module = getattr(convert, loader)(state, scfg, device="cpu")  # strict: every key
    assert set(state) == set(module.state_dict())
    assert all(np.array_equal(state[k], again[k]) for k in state)
    assert any(not np.array_equal(state[k], other[k]) for k in state)
    widths = dict(entry["widths"], **TINY_WIDTHS.get(name, {}))
    for k, v in widths.items():
        assert tuple(getattr(scfg, k)) == tuple(v) if isinstance(v, list) else getattr(scfg, k) == v


@pytest.mark.parametrize("workload", sorted(DIGESTS))
def test_the_existing_cells_draw_the_same_weights_as_before(workload):
    _, _, cfg, mix, _ = cell.spec(workload)
    assert offline.OfflineCell(cfg, mix, 7, CPU).stages == []
    _, w = weights.asr_model(cfg, 7, CPU)
    _, v = weights.silero(cfg, 7, CPU)
    assert (digest(w), digest(v)) == DIGESTS[workload]
    no_stages = {k: x for k, x in cfg.items() if k != "stages"}
    _, w2 = weights.asr_model(no_stages, 7, CPU)
    assert digest(w2) == DIGESTS[workload][0]


def stage(name, seed=3):
    cfg, _ = meeting()
    entry = cfg["stages"][name]
    state, scfg = weights.stage(entry, seed, CPU)
    return entry["widths"], state, scfg, stages.to_device(state, CPU)


def test_pyannet_reference_equals_the_programs_module():
    from sherpa_vietnamese_asr_tpu_torch.models import convert

    widths, state, scfg, w = stage("segmentation")
    model = convert.pyannet_from_numpy(state, scfg, device="cpu")
    x = torch.from_numpy(stages.quantized(audio.two_speaker_turns(11.0, np.random.default_rng(1))))
    wins = seg_stage.windows(x.numpy(), CPU)
    assert wins.shape == (3, ref_pyannet.WINDOW)
    with torch.no_grad():
        got = model(wins)
    ref = ref_pyannet.forward(P, w, widths, wins)
    assert got.shape == ref.shape == (3, ref_pyannet.FRAMES, 7)
    assert float((got - ref).norm() / ref.norm()) < 1e-5


def test_window_starts_equal_the_programs():
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import PureDiarizer

    for n in (1000, 160000, 160001, 16000 * 37 + 5):
        assert ref_pyannet.window_starts(n) == PureDiarizer._window_starts(None, n)


def test_resnet_reference_equals_the_programs_superblock():
    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_pure as dp

    seg_widths, seg_state, seg_cfg, _ = stage("segmentation")
    widths, state, scfg, w = stage("embedding")
    seg = convert.pyannet_from_numpy(seg_state, seg_cfg, device="cpu")
    emb = convert.resnet_from_numpy(state, scfg, device="cpu")
    x = stages.quantized(audio.two_speaker_turns(14.0, np.random.default_rng(2)))
    n = len(ref_pyannet.window_starts(len(x)))
    block = np.zeros(dp.superblock_samples(n), np.float32)
    block[: len(x)] = x
    am, got, valid = dp._superblock_body(seg, emb, torch.from_numpy(block), n,
                                         math.ceil(589 * 1680 / 160000), False)
    wins = seg_stage.windows(x, CPU)
    ref, has = ref_resnet.embeddings(P, w, widths, wins, am.long())
    assert torch.equal(has, valid) and bool(has.any())
    a, b = got[has].double(), ref[has].double()
    assert float((1 - (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).max()) < 1e-9


def test_resnet_speaker_masks_follow_the_programs_rule():
    from sherpa_vietnamese_asr_tpu_torch.pipeline import diarization_pure as dp

    gen = torch.Generator().manual_seed(3)
    classes = torch.randint(0, 7, (6, 589), generator=gen)
    classes[1] = 1  # one speaker alone throughout
    classes[2, :] = 4  # two speakers at once throughout: no clean frames
    classes[3, :] = 0  # no speaker
    binarized = torch.from_numpy(ref_pyannet.POWERSET)[classes]
    want, want_has = dp._pool_weights(binarized, 125, math.ceil(589 * 1680 / 160000))
    got, has = ref_resnet.speaker_masks(classes, 125)
    assert torch.equal(has, want_has) and torch.equal(got, want)


def test_vibert_reference_equals_the_programs_module():
    from sherpa_vietnamese_asr_tpu_torch.models import convert

    widths, state, scfg, w = stage("punctuation")
    model = convert.vibert_from_numpy(state, scfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    ids = torch.randint(0, 77, (3, 64), generator=gen, dtype=torch.int32)
    att = torch.zeros_like(ids)
    for r, n in enumerate((64, 40, 9)):
        att[r, :n] = 1
    offs = torch.sort(torch.randint(0, 9, (3, 12), generator=gen), dim=1).values.int()
    with torch.no_grad():
        got = model(ids, att, torch.zeros_like(ids), offs)
    ref = ref_vibert.forward(P, w, widths, ids, att, offs)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) < 1e-5


def test_dnsmos_reference_equals_the_programs_analyzer(monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch.models import convert
    from sherpa_vietnamese_asr_tpu_torch.pipeline.quality import QualityAnalyzer

    widths, state, scfg, w = stage("quality")
    qa = QualityAnalyzer(convert.dnsmos_from_numpy(state, scfg, device="cpu"), mesh=None)
    seen = []
    orig = qa.raw_scores
    monkeypatch.setattr(qa, "raw_scores", lambda windows: seen.append(orig(windows)) or seen[-1])
    for seconds in (0.3, 4.0, 30.0):
        speech = audio.two_speaker_turns(seconds, np.random.default_rng(5))
        seen.clear()
        qa.analyze_speech(speech)
        wins = ref_dnsmos.speech_windows(speech)
        got = np.concatenate(seen) if seen else np.zeros((0, 3), np.float32)
        assert got.shape == (len(wins), 3)
        if len(wins):
            ref = ref_dnsmos.forward(P, w, widths, torch.from_numpy(wins)).numpy()
            assert float(np.abs(got - ref).max()) < 1e-5
