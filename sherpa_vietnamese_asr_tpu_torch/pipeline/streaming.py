# Live-mic streaming ASR: the VAD-triggered utterance state machine.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/streaming.py (no Qt,
# callback-based):
#   * VADTrigger: a ring buffer holding 0.3 s of context chunks, a
#     512-sample VAD step buffer, the Silero VAD (models/silero_vad.vad_step)
#     with its (h, c) state carried, trigger threshold 0.3;
#   * StreamingSession: the IDLE/RECORDING lifecycle. Speech starts an
#     utterance with the 0.3 s context prepended; partial decodes are
#     throttled to 1 Hz and skipped under backpressure (queue > 10 chunks);
#     an utterance ends on 0.6 s of silence, 12 s of speech or a pending
#     speaker change; finals get 300 ms of tail padding; a silence end
#     resets the VAD fully, the other ends keep its LSTM state.
#
# Decoding runs the offline path (pipeline/decoder.BatchedChunkDecoder at
# batch 1, utterances padded to 14 s: kernels 1, 2 or 4, and 3 on the card)
# on the accumulated utterance.

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.models import silero_vad
from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder

SAMPLE_RATE = 16000
SPEAKER_SEP = "__SPK_SEP__"


def _as_float(audio_chunk):
    """PCM16 bytes or float samples -> float32 numpy."""
    if isinstance(audio_chunk, (bytes, bytearray)):
        return np.frombuffer(audio_chunk, np.int16).astype(np.float32) / 32768.0
    return np.asarray(audio_chunk, np.float32)


class VADTrigger:
    """Ring-buffer VAD trigger with carried Silero state.

    vad: a models/silero_vad.SileroVad; None builds random weights
    (random_silero_vad(seed=0)) on `device`, the card by default.
    """

    def __init__(self, vad=None, sample_rate=SAMPLE_RATE, trigger_level=0.3,
                 device="cuda"):
        self.vad = vad if vad is not None else silero_vad.random_silero_vad(
            seed=0, device=device)
        self.sample_rate = sample_rate
        self.threshold = trigger_level
        self.window_size = 512
        self.context_duration = 0.3
        chunk_approx = int(0.05 * sample_rate)
        self.ring_buffer = collections.deque(
            maxlen=max(1, int(self.context_duration * sample_rate
                              / chunk_approx)))
        self.vad_buffer = np.array([], dtype=np.float32)
        self._reset_model_state()

    def _reset_model_state(self):
        dev = self.vad.device
        d = silero_vad.STATE_DIM
        self._state = (torch.zeros(d, device=dev), torch.zeros(d, device=dev))
        self._context = torch.zeros(silero_vad.CONTEXT, device=dev)

    def process(self, audio_chunk):
        """Returns (is_speech, max_prob) or (None, None) if < 512 samples
        buffered."""
        audio_chunk = _as_float(audio_chunk)
        self.ring_buffer.append(audio_chunk)
        self.vad_buffer = np.concatenate([self.vad_buffer, audio_chunk])
        if len(self.vad_buffer) < self.window_size:
            return None, None
        max_prob = 0.0
        while len(self.vad_buffer) >= self.window_size:
            chunk = torch.from_numpy(self.vad_buffer[: self.window_size]).to(self.vad.device)
            self.vad_buffer = self.vad_buffer[self.window_size:]
            prob, self._context, self._state = silero_vad.vad_step(
                self.vad, chunk, self._context, self._state)
            max_prob = max(max_prob, float(prob))
        return max_prob > self.threshold, max_prob

    def get_context(self):
        if not self.ring_buffer:
            return np.array([], dtype=np.float32)
        return np.concatenate(list(self.ring_buffer))

    def soft_reset(self):
        """Clear buffers but keep the LSTM warm (speaker didn't stop)."""
        self.ring_buffer.clear()
        self.vad_buffer = np.array([], dtype=np.float32)

    def reset(self):
        self.soft_reset()
        self._reset_model_state()


class StreamingSession:
    """Push audio chunks in; receive (text, is_final, timestamp) callbacks.

    Args:
        model: AsrModel for the utterance decodes.
        on_text: callable(text, is_final, timestamp_sec).
        vad: the VADTrigger's SileroVad; None gives random weights on the
            model's device.
        clock: the time source of the partial-decode throttle.
    """

    MAX_SILENCE_CHUNKS = int(0.6 / 0.05)  # 0.6 s at ~50 ms chunks
    MAX_SPEECH_DURATION = 12.0
    DECODE_INTERVAL = 1.0
    TAIL_PAD_SEC = 0.3

    def __init__(self, model, on_text, vad=None, trigger_level=0.3,
                 clock=time.time):
        self.model = model
        self.on_text = on_text
        self.vad = VADTrigger(vad, trigger_level=trigger_level, device=model.device)
        self.clock = clock
        self.state = "IDLE"
        self.utterance = np.array([], dtype=np.float32)
        self.silence_frames = 0
        self.current_speech_duration = 0.0
        self.last_partial_text = ""
        self.last_decode_time = 0.0
        self.total_samples = 0
        self.segment_start_samples = 0
        self.pending_speaker = None
        self._decoder = BatchedChunkDecoder(
            model, max_batch=1,
            chunk_pad_sec=(self.MAX_SPEECH_DURATION + 2.0))

    # -- external controls ---------------------------------------------------
    def insert_speaker(self, name):
        self.pending_speaker = name

    def _emit_speaker(self):
        name = self.pending_speaker
        self.pending_speaker = None
        self.on_text(f" {SPEAKER_SEP}{name}{SPEAKER_SEP}", True, 0.0)

    # -- decode helper ---------------------------------------------------------
    def _decode_utterance(self, audio):
        words = self._decoder.decode_spans(audio, [(0, len(audio))])[0]
        return " ".join(w["text"] for w in words).strip().lower()

    def _final_text(self):
        tail = np.zeros(int(self.TAIL_PAD_SEC * SAMPLE_RATE), np.float32)
        return self._decode_utterance(np.concatenate([self.utterance, tail]))

    # -- main entry -------------------------------------------------------------
    def push_chunk(self, audio_chunk, queue_depth=0):
        """Feed one ~50 ms chunk (float samples or PCM16 bytes). queue_depth
        enables the backpressure rule (skip the partial decode when > 10
        chunks are waiting)."""
        audio_chunk = _as_float(audio_chunk)
        self.total_samples += len(audio_chunk)

        is_speech, _prob = self.vad.process(audio_chunk)

        if self.pending_speaker and self.state == "IDLE":
            self._emit_speaker()

        if self.state == "RECORDING":
            self.utterance = np.concatenate([self.utterance, audio_chunk])
            self.current_speech_duration += len(audio_chunk) / SAMPLE_RATE

        if is_speech is None:
            return

        if self.state == "IDLE":
            if is_speech:
                self.state = "RECORDING"
                self.silence_frames = 0
                self.current_speech_duration = 0.0
                self.last_partial_text = ""
                self.last_decode_time = self.clock()
                self.segment_start_samples = self.total_samples
                self.utterance = self.vad.get_context().copy()
            return

        # RECORDING
        if is_speech:
            self.silence_frames = 0
        else:
            self.silence_frames += 1

        end_reason = None
        if self.silence_frames > self.MAX_SILENCE_CHUNKS:
            end_reason = "silence"
        if self.current_speech_duration > self.MAX_SPEECH_DURATION:
            end_reason = "max_duration"
        if self.pending_speaker:
            end_reason = "speaker_change"

        if end_reason:
            text = self._final_text()
            if text:
                self.on_text(text, True,
                             self.segment_start_samples / SAMPLE_RATE)
            if self.pending_speaker:
                self._emit_speaker()
            self.utterance = np.array([], dtype=np.float32)
            self.state = "IDLE"
            if end_reason == "silence":
                self.vad.reset()
            else:
                self.vad.soft_reset()
            return

        # Throttled partial decode with backpressure
        now = self.clock()
        if queue_depth <= 10 and now - self.last_decode_time \
                > self.DECODE_INTERVAL:
            text = self._decode_utterance(self.utterance)
            if text and text != self.last_partial_text:
                seg_start = self.segment_start_samples / SAMPLE_RATE
                elapsed = ((self.total_samples - self.segment_start_samples)
                           / SAMPLE_RATE)
                ts = seg_start + max(0.0, elapsed - self.DECODE_INTERVAL)
                self.on_text(text, False, max(ts, seg_start))
                self.last_partial_text = text
            self.last_decode_time = now

    def finalize(self):
        """Flush any active utterance (end of session)."""
        if self.state == "RECORDING" and len(self.utterance):
            text = self._final_text()
            if text:
                self.on_text(text, True,
                             self.segment_start_samples / SAMPLE_RATE)
        self.state = "IDLE"
        self.utterance = np.array([], dtype=np.float32)
