# True-size end-to-end golden fixture: the golden test signal and the two
# stacks of sherpa_vietnamese_asr_tpu/models/golden.py, on this package.
#
# tests/data/golden_e2e.json pins the COMPOSITION fbank -> encoder -> beam
# -> words at full Zipformer-30M size. Here it is reproduced by
#   run_exec_stack — numpy fbank reference (utils/fbank_ref) -> executable
#     ONNX files (models/onnx_export_rnnt.export_asr_dir with t_in) run by
#     the numpy graph executor (models/onnx_exec) -> dict-based oracle beam
#     search (utils/beam_search_ref) driving the decoder/joiner graphs per
#     frame, all on the host (copied from the JAX module);
#   run_torch_stack — ops/fbank -> the model's ZipformerEncoder ->
#     ops/beam_search_cuda, this package's path: on the card the fbank
#     kernel, the attention kernel and the beam kernel.
# golden_audio is copied (formula, no RNG). golden_model draws this
# package's own random weights (torch.Generator); the fixture's weights are
# the JAX package's seed-0 draw, which reaches this package through
# models/convert.py (tests/test_torch_golden_exec.py).

from __future__ import annotations

import numpy as np
import torch

GOLDEN_SEED = 0
GOLDEN_VOCAB = 2000
GOLDEN_BEAM = 8
GOLDEN_SR = 16000
GOLDEN_DURATION_SEC = 6.0


def golden_audio(duration_sec: float = GOLDEN_DURATION_SEC,
                 sr: int = GOLDEN_SR) -> np.ndarray:
    """Deterministic speech-band test signal: three AM voiced 'syllable'
    bands with a pitch glide and a quiet gap."""
    n = int(duration_sec * sr)
    t = np.arange(n, dtype=np.float64) / sr
    x = np.zeros(n, np.float64)
    for (a, b, f0, am) in ((0.2, 2.1, 220.0, 3.0),
                           (2.5, 4.2, 340.0, 2.2),
                           (4.5, 5.8, 180.0, 4.0)):
        seg = (t >= a) & (t < b)
        ts = t[seg] - a
        glide = f0 * (1.0 + 0.12 * np.sin(2 * np.pi * 0.5 * ts))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * am * ts)
        x[seg] += (0.28 * np.sin(2 * np.pi * glide * ts) * env
                   + 0.1 * np.sin(2 * np.pi * 2.0 * glide * ts) * env)
    return x.astype(np.float32)

def golden_model(device="cuda"):
    """The fixture's architecture: true-size 30M, f32 compute, f32 pos
    scores, with this package's seed-0 random weights, on `device` (the
    card by default)."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import (
        random_asr_model,
        with_pos_dtype,
    )

    m = random_asr_model(vocab_size=GOLDEN_VOCAB, seed=GOLDEN_SEED,
                         beam_size=GOLDEN_BEAM, compute_dtype="float32",
                         device=device)
    return with_pos_dtype(m, "float32")


def weights_abs_sum(model) -> float:
    return float(sum(np.abs(v.detach().cpu().numpy()).sum()
                     for m in (model.encoder, model.decoder, model.joiner)
                     for v in m.state_dict().values()))


def tokens_to_words(tokens, id2token) -> list:
    """BPE pieces -> lowercase word strings (pipeline/words.py merge rule)."""
    words, cur = [], None
    for tok_id in tokens:
        tok = id2token[int(tok_id)] if int(tok_id) < len(id2token) else ""
        if tok.startswith("▁") or tok.startswith(" ") or cur is None:
            if cur:
                words.append(cur)
            cur = tok.lstrip(" ").lstrip("▁").lower()
        else:
            cur += tok.lower()
    if cur:
        words.append(cur)
    return words


def run_exec_stack(model, audio, model_dir):
    """fbank_ref -> ONNX graph executor encoder -> oracle beam search.

    model_dir must contain the files written by
    onnx_export_rnnt.export_asr_dir for this model and this audio's frame
    count. Returns (tokens list, result dict, enc_out [T,E], fbank [T,80]).
    """
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_exec import run_onnx
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import read_onnx
    from sherpa_vietnamese_asr_tpu_torch.utils import fbank_ref
    import os

    feats = fbank_ref.compute_fbank(audio, fbank_ref.ASR_FBANK)

    def find(prefix):
        (name,) = [f for f in os.listdir(model_dir)
                   if f.startswith(prefix) and f.endswith(".onnx")]
        return read_onnx(os.path.join(model_dir, name))

    enc_g, dec_g, joi_g = (find("encoder-"), find("decoder-"),
                           find("joiner-"))
    (enc_out,) = run_onnx(enc_g, {"x": feats[None].astype(np.float32)})

    def decoder_fn(ctx):
        (out,) = run_onnx(dec_g, {"y": ctx.astype(np.int64)})
        return out

    def joiner_fn(enc, dec):
        (out,) = run_onnx(joi_g, {"encoder_out": enc.astype(np.float32),
                                  "decoder_out": dec.astype(np.float32)})
        return out

    from sherpa_vietnamese_asr_tpu_torch.utils.beam_search_ref import (
        ref_beam_search,
    )

    cfg = model.rnnt_cfg
    res = ref_beam_search(enc_out[0].astype(np.float32), decoder_fn,
                          joiner_fn, cfg.vocab_size, beam_size=GOLDEN_BEAM,
                          blank_id=cfg.blank_id, unk_id=cfg.unk_id,
                          context_size=cfg.context_size)
    return list(res["tokens"]), res, enc_out[0], feats


def run_torch_stack(model, audio):
    """ops/fbank -> ZipformerEncoder -> beam_search_batch_cuda, on the
    model's device (the counterpart of the JAX module's run_jax_stack).

    Returns (tokens list, BeamResult, enc_out [T,E], fbank [T,80]).
    """
    from sherpa_vietnamese_asr_tpu_torch.ops import fbank as fb
    from sherpa_vietnamese_asr_tpu_torch.ops.beam_search_cuda import (
        beam_search_batch_cuda,
    )

    dev = model.device
    with torch.no_grad():
        feats = fb.compute_fbank(torch.from_numpy(np.asarray(audio, np.float32)).to(dev),
                                 fb.ASR_FBANK)
        enc, enc_lens = model.encoder(
            feats[None], torch.tensor([feats.shape[0]], device=dev))
    res = beam_search_batch_cuda(enc, enc_lens, model.decoder, model.joiner,
                                 model.rnnt_cfg, beam_size=GOLDEN_BEAM)
    n = int(res.num_tokens[0])
    tokens = [int(v) for v in res.tokens[0, :n].tolist()]
    t_valid = int(enc_lens[0])
    return tokens, res, enc[0, :t_valid].cpu().numpy(), feats.cpu().numpy()
