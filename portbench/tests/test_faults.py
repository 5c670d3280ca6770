"""A run with the timed path broken underneath comes out not correct: the
rest of a run (the look for a card skipped) on the tiny preset, the
program's plain twins on the CPU, once for each fault a cell can have.
Offline cells carry no state between steps of the decode and run on one
chip; their VAD carries its LSTM state across blocks of 60 s."""

import time

import pytest
import torch

from conftest import SHORT, TINY, cpu_limits
from portbench.harness import cell

LONG = dict(SHORT["longform"], durations_s=[70, 40])


def run(workload, traffic, seconds=1.0):
    res = cell.measure(workload, 5, seconds, False, "cpu", time.perf_counter(),
                       overrides={"config": TINY, "traffic": traffic, "limits": cpu_limits(workload)})
    return res


def altered_beam(monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch.pipeline import decoder

    orig = decoder.beam_search_batch_cuda

    def beam(*a, **kw):
        res = orig(*a, **kw)
        res.tokens[:, 0] = torch.where(res.num_tokens > 0, (res.tokens[:, 0] + 1) % TINY["vocab_size"],
                                       res.tokens[:, 0])
        return res

    monkeypatch.setattr(decoder, "beam_search_batch_cuda", beam)


def narrow_beam(monkeypatch):
    """The search keeps one hypothesis a frame instead of the configuration's beam."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline import decoder

    orig = decoder.beam_search_batch_cuda
    monkeypatch.setattr(decoder, "beam_search_batch_cuda",
                        lambda *a, **kw: orig(*a, **dict(kw, beam_size=1)))


def half_batch(monkeypatch):
    """Every second row of each decode batch left out (its outputs zero)."""
    from sherpa_vietnamese_asr_tpu_torch.pipeline import decoder

    orig = decoder.decode_feats

    def decode_feats(feats, n_frames, model):
        res, lens = orig(feats[0::2], n_frames[0::2], model)

        def spread(x):
            out = torch.zeros((feats.shape[0],) + x.shape[1:], dtype=x.dtype)
            out[0::2] = x
            return out

        return type(res)(*(spread(x) for x in (res.tokens, res.frames, res.tok_logp, res.entropy,
                                               res.num_tokens, res.total_logp))), spread(lens)

    monkeypatch.setattr(decoder, "decode_feats", decode_feats)


def stale_vad_state(monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch.models import silero_vad

    orig = silero_vad.lstm_scan
    monkeypatch.setattr(silero_vad, "lstm_scan", lambda vad, feats, state=None: (orig(vad, feats, state)[0], state))


@pytest.mark.parametrize("fault", [altered_beam, narrow_beam, half_batch, stale_vad_state])
def test_offline_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run("zipformer30m-fp32.longform", LONG)
    assert res["correct"] is False, res["checks"]


def padding_leak(monkeypatch):
    """The attention's key mask left out: a padded row's valid frames attend
    to its padding."""
    from sherpa_vietnamese_asr_tpu_torch.models import zipformer

    orig = zipformer.attention_weights

    def attention_weights(q, k, pq, pos_proj_weight, pos_emb, lens, *a, **kw):
        return orig(q, k, pq, pos_proj_weight, pos_emb, torch.full_like(lens, q.shape[1]), *a, **kw)

    monkeypatch.setattr(zipformer, "attention_weights", attention_weights)


@pytest.mark.parametrize("fault", [padding_leak, narrow_beam])
def test_uploads_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run("zipformer30m-fp32.uploads", SHORT["uploads"])
    assert res["correct"] is False, res["checks"]


def live_state_unchanged(monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch.pipeline import streaming_online

    orig = streaming_online.fused_stream_step

    def step(model, scfg, state, ctx, wav, f0s, mask):
        _, new_ctx, toks, counts, enc = orig(model, scfg, state, ctx, wav, f0s, mask)
        return state, new_ctx, toks, counts, enc

    monkeypatch.setattr(streaming_online, "fused_stream_step", step)


def live_half_batch(monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch.pipeline import streaming_online

    orig = streaming_online.fused_stream_step

    def step(model, scfg, state, ctx, wav, f0s, mask):
        kept = mask.clone()
        kept[mask.shape[0] // 2:] = False
        return orig(model, scfg, state, ctx, wav, f0s, kept)

    monkeypatch.setattr(streaming_online, "fused_stream_step", step)


def live_altered_token(monkeypatch):
    from sherpa_vietnamese_asr_tpu_torch.pipeline import streaming_online

    orig = streaming_online.greedy_chunk_decode

    def greedy(*a):
        toks, counts, ctx = orig(*a)
        return torch.where(toks >= 0, (toks + 1) % TINY["vocab_size"], toks), counts, ctx

    monkeypatch.setattr(streaming_online, "greedy_chunk_decode", greedy)


@pytest.mark.parametrize("fault", [live_state_unchanged, live_half_batch, live_altered_token])
def test_live_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = run("zipformer30m-fp32.live8", dict(SHORT["live8"], streams=4), seconds=2.5)  # 3 chunks
    assert res["correct"] is False, res["checks"]
