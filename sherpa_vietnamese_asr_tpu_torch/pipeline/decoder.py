# Batched chunk decoder: fbank -> Zipformer -> beam search for a whole batch
# of ~30 s chunks at once.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/decoder.py. Chunks are
# zero-padded to one static length (33 s = 30 s + 3 s overlap) and the last
# group of a plan is padded with (0, 1) spans, so every launch has the same
# shapes; each chunk's tail is reflect-filled first so the snip_edges=False
# frames near its end equal those of an exact-length fbank. PyTorch's CUDA
# work is asynchronous, so up to three batches are in flight: the host
# builds and uploads the next batch while the card decodes the previous
# ones, and only collecting a result waits for the card.

from __future__ import annotations

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.models.registry import AsrModel
from sherpa_vietnamese_asr_tpu_torch.ops import fbank as fbank_ops
from sherpa_vietnamese_asr_tpu_torch.ops.beam_search_cuda import beam_search_batch_cuda
from sherpa_vietnamese_asr_tpu_torch.pipeline.words import beam_result_to_words
from sherpa_vietnamese_asr_tpu_torch.utils.fbank_ref import ASR_FBANK

SAMPLE_RATE = 16000
CHUNK_PAD_SEC = 33.0  # 30 s chunk + 3 s overlap
REFLECT_FILL = 400    # samples of tail reflection for fbank bit-parity
IN_FLIGHT = 3         # batches decoded ahead of the host


def fbank_batch(audio: torch.Tensor) -> torch.Tensor:
    """[B, L] float32, or int16 PCM dequantised on the device -> [B, F, 80]."""
    if audio.dtype == torch.int16:
        audio = audio.to(torch.float32) / 32768.0
    return fbank_ops.compute_fbank(audio, ASR_FBANK)


def decode_feats(feats, n_frames, model: AsrModel):
    """[B, F, 80] fbank -> (BeamResult, enc_lens)."""
    enc_out, enc_lens = model.encoder(feats, n_frames)
    result = beam_search_batch_cuda(enc_out, enc_lens, model.decoder,
                                    model.joiner, model.rnnt_cfg,
                                    beam_size=model.beam_size,
                                    hw_tables=model.hotword_tables)
    return result, enc_lens


class BatchedChunkDecoder:
    """Decode chunk plans over concat audio in fixed-size device batches."""

    def __init__(self, model: AsrModel, max_batch: int = 8,
                 chunk_pad_sec: float = CHUNK_PAD_SEC,
                 transfer_dtype: str | None = None):
        self.model = model
        self.max_batch = max_batch
        self.pad_len = int(chunk_pad_sec * SAMPLE_RATE)
        # float32 by default; "int16" halves the upload and is lossless for
        # audio decoded from 16-bit PCM (utils/audio_io.is_int16_exact).
        self.transfer_dtype = transfer_dtype or "float32"

    def _build_batch(self, concat_audio, spans):
        """spans: [(start, end)] -> (audio [B, pad_len], lens [B])."""
        b = len(spans)
        batch = np.zeros((b, self.pad_len), dtype=np.float32)
        lens = np.zeros((b,), dtype=np.int32)
        for i, (s, e) in enumerate(spans):
            n = min(e - s, self.pad_len)
            batch[i, :n] = concat_audio[s: s + n]
            lens[i] = n
            # Reflect-fill the tail so snip_edges=False frames near the end
            # match an exact-length fbank (utils/fbank_ref.reflect_index).
            fill = min(REFLECT_FILL, n, self.pad_len - n)
            if fill > 0:
                batch[i, n: n + fill] = batch[i, n - fill: n][::-1]
        return batch, lens

    def _words_from_result(self, result, enc_lens, group):
        tokens = result.tokens.cpu().numpy()
        frames = result.frames.cpu().numpy()
        tok_logp = result.tok_logp.cpu().numpy()
        entropy = result.entropy.cpu().numpy()
        num_tokens = result.num_tokens.cpu().numpy()
        enc_lens_np = enc_lens.cpu().numpy()
        out = []
        for i, (s, e) in enumerate(group):
            dur = (e - s) / SAMPLE_RATE
            out.append(beam_result_to_words(
                tokens[i], frames[i], tok_logp[i], entropy[i],
                num_tokens[i], enc_lens_np[i], self.model.id2token, dur,
                time_offset=s / SAMPLE_RATE))
        return out

    def _launch(self, concat_audio, group):
        # Keep the batch dimension static: pad the last group.
        padded = list(group) + [(0, 1)] * (self.max_batch - len(group))
        audio, lens = self._build_batch(concat_audio, padded)
        if self.transfer_dtype == "int16":
            audio = np.clip(np.rint(audio * 32768.0), -32768, 32767
                            ).astype(np.int16)
        dev = self.model.device
        audio_dev = torch.from_numpy(audio).to(dev)
        n_frames = torch.from_numpy((lens + 80) // 160).to(dev)
        with torch.no_grad():
            feats = fbank_batch(audio_dev)
            return decode_feats(feats, n_frames, self.model)

    def decode_spans(self, concat_audio, spans, progress_callback=None,
                     phase="Transcription", cancel_check=None):
        """Decode [(start, end)] sample spans.

        Returns per-span word lists (timestamps offset by start/16000).
        """
        out = []
        total = len(spans)
        inflight = []

        def drain_one():
            group, (result, enc_lens) = inflight.pop(0)
            out.extend(self._words_from_result(result, enc_lens, group))
            if progress_callback:
                progress_callback(
                    f"PHASE:{phase}|Decoding chunks|{len(out) * 100 // total}")

        for base in range(0, total, self.max_batch):
            if cancel_check is not None and cancel_check():
                raise RuntimeError("Cancelled by user")
            group = spans[base: base + self.max_batch]
            inflight.append((group, self._launch(concat_audio, group)))
            if len(inflight) >= IN_FLIGHT:
                drain_one()
        while inflight:
            drain_one()
        return out
