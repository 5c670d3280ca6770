"""A run with the timed path broken underneath comes out not correct: the
rest of a run (the look for a card skipped) on the tiny preset, the
program's plain twins on the CPU, once for each fault a cell can have.
Offline cells carry no state between steps of the decode and run on one
chip; their VAD carries its LSTM state across blocks of 60 s. The stage
models of the meeting and punctuated cells each get a fault of their own."""

import time

import pytest
import torch

from conftest import TINY, overrides
from portbench.harness import cell


def run(workload, form="short", seconds=1.0):
    return cell.measure(workload, 5, seconds, False, "cpu", time.perf_counter(),
                        overrides=overrides(workload, form))


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
    res = run("zipformer30m-fp32.longform", "faults")
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
    res = run("zipformer30m-fp32.uploads")
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
    res = run("zipformer30m-fp32.live8", "faults", seconds=2.5)  # 3 chunks
    assert res["correct"] is False, res["checks"]


def lstm_one_direction(monkeypatch):
    """PyanNet's LSTM with its backward direction left out (zero)."""
    orig = torch.nn.LSTM.forward

    def forward(self, x, *a, **kw):
        out, state = orig(self, x, *a, **kw)
        if self.bidirectional:
            out = torch.cat([out[..., : self.hidden_size], torch.zeros_like(out[..., self.hidden_size:])], -1)
        return out, state

    monkeypatch.setattr(torch.nn.LSTM, "forward", forward)


def bn_fold_left_out(monkeypatch):
    """ResNet34's first convolution without its BatchNorm folded in."""
    from sherpa_vietnamese_asr_tpu_torch.models import resnet_speaker

    orig = resnet_speaker.ResNetSpeaker.folded_convs

    def folded_convs(self):
        convs = list(orig(self))
        w, b, stride, padding = convs[0]
        convs[0] = (self.resnet.conv1.weight, torch.zeros_like(b), stride, padding)
        return convs

    monkeypatch.setattr(resnet_speaker.ResNetSpeaker, "folded_convs", folded_convs)


def attention_mask_left_out(monkeypatch):
    """ViBERT attending to the padding of every row."""
    from sherpa_vietnamese_asr_tpu_torch.models import vibert

    orig = vibert.ViBert.forward
    monkeypatch.setattr(vibert.ViBert, "forward",
                        lambda self, ids, att, types, offs: orig(self, ids, torch.ones_like(att), types, offs))


def dnsmos_heads_swapped(monkeypatch):
    """DNSMOS's SIG and BAK scores swapped."""
    from sherpa_vietnamese_asr_tpu_torch.models import dnsmos

    orig = dnsmos.Dnsmos.forward
    monkeypatch.setattr(dnsmos.Dnsmos, "forward", lambda self, audio: orig(self, audio)[:, [1, 0, 2]])


@pytest.mark.parametrize("workload, fault, check", [
    ("zipformer30m-fp32.meeting", lstm_one_direction, "seg_rel_err"),
    ("zipformer30m-fp32.meeting", bn_fold_left_out, "embed_cos_gap"),
    ("zipformer30m-fp32.meeting", attention_mask_left_out, "punct_logit_gap"),
    ("zipformer30m-fp32.meeting", dnsmos_heads_swapped, "dnsmos_abs_err"),
    ("zipformer30m-fp32.punctuated", attention_mask_left_out, "punct_logit_gap"),
    ("zipformer30m-fp32.punctuated", dnsmos_heads_swapped, "dnsmos_abs_err"),
    ("zipformer30m-fp32.punctuated", altered_beam, "token_logp_gap"),
    ("zipformer30m-fp32.punctuated", half_batch, "encoder_rel_err")])
def test_stage_cell_fault_is_not_correct(workload, fault, check, monkeypatch):
    fault(monkeypatch)
    res = run(workload)
    assert res["correct"] is False, res["checks"]
    assert not float(res["checks"][check]["value"]) <= res["checks"][check]["limit"], res["checks"]
