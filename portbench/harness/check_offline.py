"""The comparison that decides `correct` in an offline cell.

For each sampled request, from what the timed path itself produced (the
VAD's probabilities, the chunk plan and speech audio handed to the
decoder, every decode batch's fbank, encoder output and beam result) and
the reference, which reads the request's file itself:

  vad_max_abs      widest |program - reference| of the speech probabilities;
  plan_mismatches  chunk spans (and the speech audio) differing from the
                   reference's rules applied to the program's probabilities;
  fbank_rel_err    worst row's ||program - reference|| / ||reference|| of the
                   log-mel features over its valid frames (the reference on
                   the exact-length chunk);
  embed_rel_err    worst row's ||program - reference|| / ||reference|| of
                   the encoder's front end (Conv2dSubsampling + ConvNeXt +
                   BiasNorm) over its valid frames;
  encoder_rel_err  worst row's ||program - reference|| / ||reference|| of
                   the encoder output (the reference from its own fbank,
                   exact length), or inf when the valid lengths differ;
  encoder_pooled_rel_err  the same over every sampled row of the run at
                   once: ||program - reference|| / ||reference|| of all
                   their valid frames;
  token_logp_gap   widest |program - reference| of an emitted token's
                   log-probability, at its frame with the two tokens before
                   it, on the program's encoder output; inf where a row's
                   token count is off the reference's modified beam search
                   (on the same encoder output) by more than
                   max(2, COUNT_SLACK of it), a row left out or cut short;
  beam_path_deficit  how far, in nats a frame over every sampled row of
                   the run, the program's hypotheses score below the
                   reference search's best, each scored by the reference as
                   one alignment (its tokens at their frames, blank
                   elsewhere) on the program's encoder output.

With stage models (a mix whose options turn on diarization, punctuation or
quality; portbench/harness/stages), each stage's kind adds its numbers
(seg_rel_err, embed_cos_gap, punct_logit_gap, dnsmos_abs_err), the
reference reading the request's file itself for the audio the stage sees.

A cell compares the numbers its limits name. With bfloat16-stored attention
weights every float32 implementation, the reference against itself in
float64 too, reads an encoder gap that grows as rows get shorter (3e-4 at 3
s against 5e-5 at 33 s), while a TF32 encoder reads 6-7e-4 at any length:
a cell of short rows compares the pooled gap, in which the longer rows
weigh by their frames.

token_logp_gap and beam_path_deficit follow the program from its own
encoder output, which the encoder numbers check on their own. The search
is compared by its mean over many rows and from one side: on random weights
near-tied beam steps, which the order of a float32 sum decides, move a
row's winner either way by up to 2e-4 nats a frame, while a search that
keeps too few hypotheses or picks a worse one scores lower on every row.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.harness import stages as stages_mod
from portbench.reference import fbank as ref_fbank
from portbench.reference import host, rnnt, vad as ref_vad, zipformer as ref_zip
from portbench.reference.precision import Precision

NAMES = ("vad_max_abs", "plan_mismatches", "fbank_rel_err", "embed_rel_err", "encoder_rel_err",
         "token_logp_gap")
COUNT_SLACK = 0.1
PAD_SAMPLES = 33 * host.SAMPLE_RATE


def _max(a, b):
    return b if (math.isnan(b) or b > a) else a


def rel(got, ref):
    return float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))


def rows_of(got):
    """The program's captured request as batches of real rows:
    [(rows [(span index, feats [F, 80], embed [T', D0], enc [T, E], enc_len, beam row)],
      enc [B, T, E], lens [B])]."""
    out, spans, mb = [], got["spans"], got["max_batch"]
    for bi, (feats, emb, (enc, lens, res)) in enumerate(zip(got["feats"], got["embeds"], got["batches"])):
        n_real = min(mb, len(spans) - bi * mb)
        rows = []
        for r in range(n_real):
            beam = {"n": int(res.num_tokens[r]), "tokens": res.tokens[r], "frames": res.frames[r],
                    "tok_logp": res.tok_logp[r]}
            rows.append((bi * mb + r, feats[r], emb[r], enc[r], int(lens[r]), beam))
        out.append((rows, enc[:n_real], lens[:n_real]))
    return out


def judge_all(cfg, weights, vad_weights, requests, device, stages=()):
    """{name: number} of a run's sampled requests [(path, got)]: the worst
    request's per-request numbers and the pooled ones. `stages`: [(entry,
    state)] of the cell's stage models."""
    nums, pool = {}, {"enc_d2": 0.0, "enc_r2": 0.0, "deficit": 0.0, "frames": 0}
    on_device = [(entry, stages_mod.to_device(state, device)) for entry, state in stages]
    for path, got in requests:
        for name, v in judge(cfg, weights, vad_weights, path, got, device, pool, on_device).items():
            nums[name] = _max(nums.get(name, 0.0), v)
    nums["encoder_pooled_rel_err"] = (math.sqrt(pool["enc_d2"] / pool["enc_r2"]) if pool["enc_r2"]
                                      else math.inf)
    nums["beam_path_deficit"] = pool["deficit"] / pool["frames"] if pool["frames"] else math.inf
    return nums


def judge(cfg, weights, vad_weights, path, got, device, pool, stages=()):
    """{name: number} of one request, adding its rows to `pool` (judge_all):
    `got` holds "probs", "concat", "spans" and "batches" as rows_of gives
    them, and "stages", the stage models' captures; `stages` [(entry,
    weights on the device)]."""
    P = Precision("fp32")
    nums = dict.fromkeys(NAMES, 0.0)
    audio = host.read_request_audio(path)
    ref_probs = ref_vad.speech_probs(P, vad_weights, host.vad_input(audio), device).cpu().numpy()
    probs = np.asarray(got["probs"])
    nums["vad_max_abs"] = (float(np.max(np.abs(probs - ref_probs))) if probs.shape == ref_probs.shape
                           and probs.size else math.inf)
    speech, spans = host.request_plan(audio, probs)
    nums["plan_mismatches"] = float(sum(a != tuple(b) for a, b in zip(spans, got["spans"]))
                                    + abs(len(spans) - len(got["spans"]))
                                    + (not np.array_equal(speech, got["concat"])))
    for rows, enc_b, lens_b in got["rows"]:
        for idx, feats, emb, enc, enc_len, beam in rows:
            if idx >= len(spans):
                nums["fbank_rel_err"] = nums["embed_rel_err"] = nums["encoder_rel_err"] = math.inf
                pool["enc_d2"] = math.inf
                continue
            s, e = spans[idx]
            chunk = torch.from_numpy(np.ascontiguousarray(speech[s: s + min(e - s, PAD_SAMPLES)])).to(device)
            ref_f = ref_fbank.fbank(P, chunk)
            f = ref_f.shape[0]
            if f:
                nums["fbank_rel_err"] = _max(nums["fbank_rel_err"], rel(feats[:f].float(), ref_f))
            if f <= 7:
                continue
            with P.active():
                ref_m = ref_zip.embed(P, weights, cfg, ref_f[None])[0]
            nums["embed_rel_err"] = _max(nums["embed_rel_err"], rel(emb[: ref_m.shape[0]].float(), ref_m))
            ref_e = ref_zip.encoder(P, weights, cfg, ref_f)
            t = ref_e.shape[0]
            if enc_len != t:
                nums["encoder_rel_err"] = pool["enc_d2"] = math.inf
                continue
            nums["encoder_rel_err"] = _max(nums["encoder_rel_err"], rel(enc[:t], ref_e))
            pool["enc_d2"] += float(torch.sum((enc[:t].float() - ref_e) ** 2))
            pool["enc_r2"] += float(torch.sum(ref_e ** 2))
        ref_b = rnnt.beam_search(P, weights, enc_b.float(), lens_b.to(device), cfg["beam_size"])
        for r, (_, _, _, enc, _, beam) in enumerate(rows):
            n, n_ref = beam["n"], int(ref_b["n"][r])
            if abs(n - n_ref) > max(2, COUNT_SLACK * n_ref):
                nums["token_logp_gap"] = math.inf
                continue
            toks = beam["tokens"][:n].long().to(device)
            frames = beam["frames"][:n].long().to(device)
            t_len = int(lens_b[r])
            if n and (int(frames.max()) >= t_len or int(toks.max()) >= cfg["vocab_size"]
                      or bool((frames[1:] <= frames[:-1]).any())):
                nums["token_logp_gap"] = pool["deficit"] = math.inf
                continue
            if n:
                ref_lp = rnnt.token_logprobs(P, weights, enc.float(), toks, frames)
                nums["token_logp_gap"] = _max(
                    nums["token_logp_gap"], float((beam["tok_logp"][:n].float().to(device) - ref_lp).abs().max()))
            if t_len:
                e = enc[:t_len].float()
                ref_path = rnnt.path_logprob(P, weights, e, ref_b["tokens"][r][:n_ref], ref_b["frames"][r][:n_ref])
                path_lp = rnnt.path_logprob(P, weights, e, toks, frames)
                pool["deficit"] += ref_path - path_lp
                pool["frames"] += t_len
    ctx = {"audio": host.peak_limit(audio), "speech": speech}
    for entry, w in stages:
        with P.active():
            nums.update(stages_mod.plugin(entry["kind"]).judge(entry["widths"], w, got["stages"], ctx,
                                                               device, P))
    return nums


def program_outputs(got):
    """The captured request in the form judge() reads."""
    return {"probs": got["probs"], "concat": got["concat"], "spans": got["spans"],
            "rows": rows_of(got), "stages": got}


def control_outputs(cfg, weights, vad_weights, path, device, modes, stages=(), program=None):
    """The reference put in the program's place, each stage in the
    precision `modes` gives it ({"vad", "fbank", "encoder", "search"},
    "stages" for the stage models), in the same form as program_outputs.
    `stages` [(entry, state)]; `program` the program's captures of the same
    request, whose inputs a stage that follows the program reads (ViBERT's
    subword ids)."""
    audio = host.read_request_audio(path)
    probs = ref_vad.speech_probs(Precision(modes["vad"]), vad_weights, host.vad_input(audio),
                                 device).cpu().numpy()
    speech, spans = host.request_plan(audio, probs)
    mb, batches = cfg["max_batch"], []
    for b0 in range(0, len(spans), mb):
        feats, embs, encs = [], [], []
        pe = Precision(modes["encoder"])
        for s, e in spans[b0: b0 + mb]:
            chunk = torch.from_numpy(np.ascontiguousarray(speech[s: s + min(e - s, PAD_SAMPLES)])).to(device)
            f = ref_fbank.fbank(Precision(modes["fbank"]), chunk)
            feats.append(f)
            long_enough = f.shape[0] > 7
            with pe.active():
                embs.append(ref_zip.embed(pe, weights, cfg, f[None])[0] if long_enough else f[:0])
            encs.append(ref_zip.encoder(pe, weights, cfg, f) if long_enough
                        else f.new_zeros(0, max(cfg["encoder_dim"])))
        t_max = max(1, max(x.shape[0] for x in encs))
        enc_b = torch.stack([torch.nn.functional.pad(x, (0, 0, 0, t_max - x.shape[0])) for x in encs])
        lens_b = torch.tensor([x.shape[0] for x in encs], device=device)
        res = rnnt.beam_search(Precision(modes["search"]), weights, enc_b, lens_b, cfg["beam_size"])
        rows = []
        for r in range(len(encs)):
            n = int(res["n"][r])
            beam = {"n": n, "tokens": res["tokens"][r], "frames": res["frames"][r],
                    "tok_logp": res["tok_logp"][r]}
            rows.append((b0 + r, feats[r], embs[r], enc_b[r], int(lens_b[r]), beam))
        batches.append((rows, enc_b, lens_b))
    got = {}
    ctx = {"audio": host.peak_limit(audio), "speech": speech}
    for entry, state in stages:
        P = Precision(modes["stages"])
        with P.active():
            got.update(stages_mod.plugin(entry["kind"]).control(
                entry["widths"], stages_mod.to_device(state, device), dict(program or {}, **got), ctx,
                device, P))
    return {"probs": probs, "concat": speech, "spans": spans, "rows": batches, "stages": got}
