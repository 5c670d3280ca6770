# Batched chunk decoder: fbank -> Zipformer -> beam search for a whole batch
# of ~30 s chunks at once; in ROVER mode one fbank a batch feeds two models.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/decoder.py. Chunks are
# zero-padded to one static length (33 s = 30 s + 3 s overlap) and the last
# group of a plan is padded with (0, 1) spans, so every launch has the same
# shapes; each chunk's tail is reflect-filled first so the snip_edges=False
# frames near its end equal those of an exact-length fbank. PyTorch's CUDA
# work is asynchronous, so up to three batches are in flight: the host
# builds and uploads the next batch while the card decodes the previous
# ones, and only collecting a result waits for the card. A chunk transform
# (WPE dereverberation) runs on each chunk on the host before the upload.
# With a mesh (parallel/sharding.py) each batch is split over its devices,
# one model replica each: every device's piece is uploaded and launched
# before any result is read, and IN_FLIGHT counts batches, not pieces.

from __future__ import annotations

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.models.registry import AsrModel
from sherpa_vietnamese_asr_tpu_torch.ops import fbank as fbank_ops
from sherpa_vietnamese_asr_tpu_torch.ops.beam_search_cuda import beam_search_batch_cuda
from sherpa_vietnamese_asr_tpu_torch.parallel import sharding
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
                 transfer_dtype: str | None = None,
                 model_b: AsrModel | None = None,
                 chunk_transform=None, mesh=None):
        # mesh None: every card of a multi-card host, else one device.
        # max_batch is rounded up to a multiple of the mesh, and each model
        # (the ROVER partner too) gets one replica a device.
        self.mesh = mesh if mesh is not None else sharding.default_mesh()
        models = [model] + ([model_b] if model_b is not None else [])
        self.replicas = [sharding.shard_model(m, self.mesh) for m in models]  # [model][device]
        devices = [[r.device for r in reps] for reps in self.replicas]
        if any(d != devices[0] for d in devices[1:]):
            raise ValueError(f"ROVER pair on two devices: {devices[0]} and "
                             f"{devices[1]}")
        self.devices = devices[0]
        self.models = [reps[0] for reps in self.replicas]
        self.model = self.models[0]
        self.model_b = self.models[1] if model_b is not None else None
        self.chunk_transform = chunk_transform  # e.g. WPE per chunk
        self.max_batch = sharding.round_up(max_batch, self.mesh)
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
            chunk = concat_audio[s: s + n]
            if self.chunk_transform is not None:
                chunk = self.chunk_transform(chunk)
            batch[i, :n] = chunk
            lens[i] = n
            # Reflect-fill the tail so snip_edges=False frames near the end
            # match an exact-length fbank (utils/fbank_ref.reflect_index).
            fill = min(REFLECT_FILL, n, self.pad_len - n)
            if fill > 0:
                batch[i, n: n + fill] = batch[i, n - fill: n][::-1]
        return batch, lens

    def _words_from_result(self, launched, group, model):
        """Words of each span of `group` from the devices' (BeamResult,
        enc_lens) pieces, read back here and concatenated in device order."""
        pieces = [r for r, _ in launched]
        tokens, frames, tok_logp, entropy, num_tokens = (
            sharding.gather([getattr(r, k) for r in pieces])
            for k in ("tokens", "frames", "tok_logp", "entropy", "num_tokens"))
        enc_lens_np = sharding.gather([e for _, e in launched])
        out = []
        for i, (s, e) in enumerate(group):
            dur = (e - s) / SAMPLE_RATE
            out.append(beam_result_to_words(
                tokens[i], frames[i], tok_logp[i], entropy[i],
                num_tokens[i], enc_lens_np[i], model.id2token, dur,
                time_offset=s / SAMPLE_RATE))
        return out

    def _launch(self, concat_audio, group):
        """One batch: upload, then on each device one fbank of its piece and
        each model's encoder and beam search from it. Returns
        [model][device] (BeamResult, enc_lens); nothing is read back."""
        # Keep the batch dimension static: pad the last group.
        padded = list(group) + [(0, 1)] * (self.max_batch - len(group))
        audio, lens = self._build_batch(concat_audio, padded)
        if self.transfer_dtype == "int16":
            audio = np.clip(np.rint(audio * 32768.0), -32768, 32767
                            ).astype(np.int16)
        audio_pieces, _ = sharding.shard_batch(audio, self.mesh, self.devices[0])
        frame_pieces, _ = sharding.shard_batch((lens + 80) // 160, self.mesh, self.devices[0])
        launched = [[] for _ in self.replicas]
        with torch.no_grad():
            for d, (a, f) in enumerate(zip(audio_pieces, frame_pieces)):
                with sharding.device_scope(a.device):
                    feats = fbank_batch(a)
                    for out, reps in zip(launched, self.replicas):
                        out.append(decode_feats(feats, f, reps[d]))
        return launched

    def decode_spans(self, concat_audio, spans, progress_callback=None,
                     phase="Transcription", cancel_check=None):
        """Decode [(start, end)] sample spans.

        Returns per-span word lists (timestamps offset by start/16000).
        In ROVER mode returns (words_a_lists, words_b_lists).
        """
        outs = [[] for _ in self.models]
        total = len(spans)
        inflight = []

        def drain_one():
            group, launched = inflight.pop(0)
            for pieces, model, out in zip(launched, self.models, outs):
                out.extend(self._words_from_result(pieces, group, model))
            if progress_callback:
                progress_callback(
                    f"PHASE:{phase}|Decoding chunks|"
                    f"{len(outs[0]) * 100 // total}")

        for base in range(0, total, self.max_batch):
            if cancel_check is not None and cancel_check():
                raise RuntimeError("Cancelled by user")
            group = spans[base: base + self.max_batch]
            inflight.append((group, self._launch(concat_audio, group)))
            if len(inflight) >= IN_FLIGHT:
                drain_one()
        while inflight:
            drain_one()
        return tuple(outs) if self.model_b is not None else outs[0]
