"""Batch-size drift of the float32 transcription path on a CUDA card.

Run from the repository root:

    python3 -m sherpa_vietnamese_asr_tpu_torch.tools.batch_drift [--seconds 95]

With the random-weight Zipformer-30M model (vocab 2000, beam 8, float32)
and a synthetic AM-tone request, it prints:
  - max |B - B 8| of the fbank features and of the encoder outputs of the
    request's real chunks (valid frames), over the B 8 values' max, when
    the chunks are decoded in batches of 8, 16, 32 and 64 (padding rows
    after them), with the attention kernel, and at B 64 with its plain
    twin in its place;
  - the request's words at max_batch 64 against max_batch 8, and the same
    request decoded on the host CPU against the card's at max_batch 8 (the
    near-tie spread of random weights), counted as words that difflib
    leaves unmatched;
  - the card's name and power limit, as nvidia-smi prints them.
"""

from __future__ import annotations

import argparse
import copy
import difflib
import os
import subprocess
import tempfile

import numpy as np

SR = 16000
BASE_BATCH = 8


def word_differ(a, b):
    """Words of one list not matched in the other (difflib's matching
    blocks): a flipped beam step changes a few words, not every later
    position."""
    sm = difflib.SequenceMatcher(None, a, b, autojunk=False)
    return max(len(a), len(b)) - sum(m.size for m in sm.get_matching_blocks())


def encoder_rows_err(model, x, big):
    """(real rows, fbank error, encoder error): max |B big - B 8| of the
    features and of the encoder outputs of x's real chunks (valid frames),
    each over the B 8 values' max; the transcriber's chunk plan and int16
    upload."""
    import torch

    from sherpa_vietnamese_asr_tpu_torch.pipeline import chunking
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import (
        BatchedChunkDecoder,
        fbank_batch,
    )

    spans = [(s, e) for s, e, _ in chunking.plan_chunks(len(x), chunking.find_silent_regions(x))]
    n = min(len(spans), BASE_BATCH)
    outs = []
    for b in (BASE_BATCH, big):
        audio, lens = BatchedChunkDecoder(model, max_batch=b)._build_batch(
            x, spans[:n] + [(0, 1)] * (b - n))
        audio = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype(np.int16)
        with torch.no_grad():
            feats = fbank_batch(torch.from_numpy(audio).to(model.device))
            enc, enc_lens = model.encoder(feats, torch.from_numpy((lens + 80) // 160)
                                          .to(model.device))
        outs.append((feats[:n], enc[:n], enc_lens[:n].tolist()))
    (f8, e8, l8), (fb, eb, lb) = outs
    assert l8 == lb
    f_err = float((fb - f8).abs().max() / f8.abs().max())
    e_err = max(float((eb[i, :ln] - e8[i, :ln]).abs().max()) for i, ln in enumerate(l8)) \
        / float(e8.abs().max())
    return n, f_err, e_err


def request_words(model, path, max_batch):
    from sherpa_vietnamese_asr_tpu_torch import TranscriberPipeline

    res = TranscriberPipeline(path, model, {"bypass_vad": True, "max_batch": max_batch}).run()
    return [w["text"] for seg in res["segments"] for w in seg["raw_words"]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=95.0)
    args = ap.parse_args(argv)

    import torch

    from sherpa_vietnamese_asr_tpu_torch.models import zipformer
    from sherpa_vietnamese_asr_tpu_torch.models.registry import random_asr_model
    from sherpa_vietnamese_asr_tpu_torch.ops import attention
    from sherpa_vietnamese_asr_tpu_torch.tools.profile_slice import am_tone
    from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import load_audio, write_wav

    if not torch.cuda.is_available():
        raise SystemExit("batch_drift: needs a CUDA card")
    model = random_asr_model(vocab_size=2000, beam_size=8, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "request.wav")
        write_wav(path, am_tone(args.seconds, 3), SR)
        x = load_audio(path, SR)
        for big in (8, 16, 32, 64):
            n, f_err, e_err = encoder_rows_err(model, x, big)
            print(f"kernel 2, B {big} vs B {BASE_BATCH}, {n} real rows: fbank max |d| "
                  f"{f_err:.3e}, encoder output max |d| {e_err:.3e} of the max")
        kernel = zipformer.attention_weights

        def twin(q, k, pq, w, pe, lens, pos_dtype=torch.float32, pos_table=None):
            return attention.attention_weights_plain(q, k, pq, w, pe, lens,
                                                     pos_dtype).to(torch.bfloat16)

        zipformer.attention_weights = twin
        try:
            n, f_err, e_err = encoder_rows_err(model, x, 64)
        finally:
            zipformer.attention_weights = kernel
        print(f"kernel 2's twin, B 64 vs B {BASE_BATCH}: fbank max |d| {f_err:.3e}, "
              f"encoder output max |d| {e_err:.3e} of the max")
        base = request_words(model, path, BASE_BATCH)
        big = request_words(model, path, 64)
        host = request_words(copy.deepcopy(model).to("cpu"), path, BASE_BATCH)
        print(f"words: max_batch 64 vs {BASE_BATCH}: {word_differ(big, base)} of {len(base)} "
              f"differ; the host CPU vs the card at {BASE_BATCH}: {word_differ(host, base)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")


if __name__ == "__main__":
    main()
