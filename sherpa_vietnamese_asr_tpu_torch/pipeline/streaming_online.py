# Online streaming recognizers: the sherpa-onnx OnlineRecognizer-style API
# with endpoint rules, the cache-carrying streaming recognizer and N live
# streams multiplexed into one fused step.
#
# Port of sherpa_vietnamese_asr_tpu/pipeline/streaming_online.py:
#   * OnlineRecognizer / OnlineStreamingSession re-decode the current
#     utterance window (at most max_window_sec) through the offline path
#     (pipeline/decoder.BatchedChunkDecoder at batch 1: kernels 1, 2 or 4,
#     and 3 on the card) and end an utterance by the endpoint rules —
#       rule1: >= 3.0 s trailing silence with nothing decoded,
#       rule2: >= 2.0 s trailing silence after something was decoded,
#       rule3: utterance length >= 20 s;
#   * fused_stream_step: fbank (kernel 1 on the card, one launch of N x 68
#     frames) -> the streaming Zipformer chunk (models/zipformer_streaming)
#     -> greedy RNN-T decode with a carried [2] context, the new state taken
#     only where the slot mask is set;
#   * CachedStreamingRecognizer: one stream, pipelined one chunk deep, with
#     an optional pump thread; MultiStreamRecognizer: a fixed array of
#     slots that join and leave without a rebuild.
# PyTorch runs eagerly, so the JAX package's jit and its executable cache
# (utils/aot_cache) have no counterpart here.

from __future__ import annotations

import functools
import queue
import threading

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.models.rnnt import decoder_forward, joiner_forward
from sherpa_vietnamese_asr_tpu_torch.models.zipformer_streaming import (
    StreamingConfig,
    init_streaming_state,
    map_state,
    streaming_step,
)
from sherpa_vietnamese_asr_tpu_torch.ops import fbank as fbank_ops
from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import BatchedChunkDecoder
from sherpa_vietnamese_asr_tpu_torch.utils.fbank_ref import ASR_FBANK

SAMPLE_RATE = 16000


class OnlineRecognizer:
    """Streaming recognizer with endpoint rules (sherpa-style API).

    Usage:
        rec = OnlineRecognizer(model)
        rec.accept_waveform(chunk)
        while rec.is_ready():
            rec.decode()
        text = rec.get_result()
        if rec.is_endpoint():
            rec.reset()  # -> finalizes the utterance
    """

    def __init__(self, model, chunk_sec=0.64, max_window_sec=24.0,
                 rule1_min_trailing_silence=3.0,
                 rule2_min_trailing_silence=2.0,
                 rule3_min_utterance_length=20.0,
                 decode_throttle_sec=0.32):
        self.model = model
        self.chunk_samples = int(chunk_sec * SAMPLE_RATE)
        self.max_window = int(max_window_sec * SAMPLE_RATE)
        self.rule1 = rule1_min_trailing_silence
        self.rule2 = rule2_min_trailing_silence
        self.rule3 = rule3_min_utterance_length
        self.throttle = int(decode_throttle_sec * SAMPLE_RATE)
        self._decoder = BatchedChunkDecoder(model, max_batch=1,
                                            chunk_pad_sec=max_window_sec)
        self.reset(full=True)

    def reset(self, full=False):
        """End the current utterance (keep the global sample clock)."""
        self.buffer = np.array([], dtype=np.float32)
        self._pending = 0
        self._last_words = []
        self._last_text = ""
        if full:
            self.total_samples = 0
        self.utterance_start = self.total_samples if not full else 0

    # -- sherpa-style API --------------------------------------------------
    def accept_waveform(self, audio):
        audio = np.asarray(audio, np.float32)
        self.buffer = np.concatenate([self.buffer, audio])
        if len(self.buffer) > self.max_window:
            dropped = len(self.buffer) - self.max_window
            self.buffer = self.buffer[-self.max_window:]
            self.utterance_start += dropped
        self.total_samples += len(audio)
        self._pending += len(audio)

    def is_ready(self):
        return self._pending >= max(self.chunk_samples, self.throttle) \
            and len(self.buffer) >= self.chunk_samples

    def decode(self):
        """Re-decode the current utterance window; updates the result."""
        self._pending = 0
        if len(self.buffer) < 400:
            return
        words = self._decoder.decode_spans(self.buffer,
                                           [(0, len(self.buffer))])[0]
        self._last_words = words
        self._last_text = " ".join(w["text"] for w in words).strip().lower()

    def get_result(self):
        return self._last_text

    def get_words(self):
        """Word dicts with utterance-relative timestamps."""
        return list(self._last_words)

    def utterance_length_sec(self):
        return len(self.buffer) / SAMPLE_RATE

    def trailing_silence_sec(self):
        """Seconds since the last emitted word's end (buffer-relative)."""
        if not self._last_words:
            return len(self.buffer) / SAMPLE_RATE
        last_end = self._last_words[-1].get("end", 0.0)
        return max(0.0, len(self.buffer) / SAMPLE_RATE - last_end)

    def is_endpoint(self):
        trailing = self.trailing_silence_sec()
        if not self._last_text and trailing >= self.rule1:
            return True
        if self._last_text and trailing >= self.rule2:
            return True
        if self.utterance_length_sec() >= self.rule3:
            return True
        return False


def greedy_chunk_decode(enc_out, ctx, decoder, joiner, cfg):
    """Greedy decode of N slots' chunk frames with carried contexts.

    enc_out: [N, T, E]; ctx: [N, 2] int64 (decoder context, 0-padded).
    Returns (tokens [N, T] int64, counts [N], new_ctx [N, 2]): at most one
    emission a frame (the modified-greedy rule of beam size 1), each row's
    emitted tokens moved to its front in frame order (a stable sort, as the
    JAX package's stable argsort), -1 after them.
    """
    toks = []
    for t in range(enc_out.shape[1]):
        logits = joiner_forward(joiner, enc_out[:, t], decoder_forward(decoder, ctx))
        tok = torch.argmax(logits, dim=-1)
        emit = tok != cfg.blank_id
        ctx = torch.where(emit[:, None], torch.stack([ctx[:, 1], tok], dim=1), ctx)
        toks.append(torch.where(emit, tok, -1))
    toks = torch.stack(toks, dim=1)
    is_emit = toks >= 0
    order = torch.sort((~is_emit).to(torch.int32), dim=1, stable=True).indices
    return torch.gather(toks, 1, order), is_emit.sum(dim=1), ctx


def fused_stream_step(model, scfg: StreamingConfig, state, ctx, wav, f0s, mask):
    """One streaming step of N slots: fbank -> streaming Zipformer chunk ->
    greedy decode, state and context advanced only where mask is set.

    wav: [N, win_samples] float32 on the model's device (each slot's window
    from its sample buffer); f0s: [N] first fbank frame of each slot's
    chunk in its window; mask: [N] bool. On the card the fbank is one launch
    of kernel 1 on [N * frames, 512]. Returns (new_state, new_ctx, tokens
    [N, T], counts [N], enc_out [N, T, E]).
    """
    with torch.no_grad():
        feats = fbank_ops.compute_fbank(wav, ASR_FBANK)         # [N, F, 80]
        n_f = 2 * scfg.chunk_frames
        idx = f0s[:, None] + torch.arange(n_f, device=wav.device)[None, :]
        chunks = torch.gather(feats, 1, idx[:, :, None].expand(-1, -1, feats.shape[2]))
        enc_out, new_state = streaming_step(model.encoder, state, chunks, scfg)

        def sel(new, old):
            return torch.where(mask.view((-1,) + (1,) * (new.dim() - 1)), new, old)

        new_state = map_state(sel, new_state, state)
        toks, counts, new_ctx = greedy_chunk_decode(enc_out, ctx, model.decoder,
                                                    model.joiner, model.rnnt_cfg)
        new_ctx = torch.where(mask[:, None], new_ctx, ctx)
    return new_state, new_ctx, toks, counts, enc_out


def window_samples(chunk_frames: int, f0: int) -> int:
    """Samples of a step's window: frames f0 .. f0 + 2 * chunk_frames - 1
    at snip_edges=False framing (frame f ends at sample 160 f + 280)."""
    return (f0 + 2 * chunk_frames - 1) * 160 + 280


def _pieces_text(model, tokens):
    id2tok = model.id2token
    pieces = [id2tok[t] if t < len(id2tok) else "" for t in tokens]
    return "".join(pieces).replace("▁", " ").strip().lower()


class CachedStreamingRecognizer:
    """Cache-carrying streaming recognizer: streaming Zipformer chunks plus
    greedy RNN-T decoding with a carried decoder context, one fused step a
    0.64 s chunk (fused_stream_step), the state on the model's device.

    The step is PIPELINED one chunk deep: decode() enqueues the current
    chunk's work on the device and returns the PREVIOUS chunk's tokens, so
    the host packages the next chunk while the device runs. Token values
    are those of the unpipelined step; only the return is one decode() call
    late; get_result()/tokens/reset() drain the in-flight step first.

    background=True moves the device interaction onto a pump thread:
    decode() only packages the chunk (numpy slicing) and hands it off,
    returning the tokens the pump has already materialized. The pump runs
    chunks strictly in order with the same carries, so the tokens are
    unchanged; an exception in it is raised on the caller's next call.
    """

    _FIXED_F0 = 3  # frame_cursor stays in [0, 3) after buffer trimming

    def __init__(self, model, chunk_frames=32, left_frames=128,
                 background=False):
        self.model = model
        self.device = model.device
        self.scfg = StreamingConfig(chunk_frames=chunk_frames,
                                    left_frames=left_frames)
        self.enc_state = init_streaming_state(model.zip_cfg, self.scfg, 1, self.device)
        self._step = functools.partial(fused_stream_step, model, self.scfg)
        self._win_samples = window_samples(chunk_frames, self._FIXED_F0)
        self._mask1 = torch.ones((1,), dtype=torch.bool, device=self.device)
        self.sample_buffer = np.array([], np.float32)
        self.frame_cursor = 0  # fbank frames consumed so far
        self.ctx = torch.zeros((1, 2), dtype=torch.int64, device=self.device)
        self._tokens = []
        self.total_samples = 0
        self._pending = None  # in-flight (toks, counts) device tensors
        self._bg = None
        if background:
            self._bg_queue = queue.Queue()
            self._bg_lock = threading.Lock()
            self._bg_new = []   # tokens materialized but not yet returned
            self._bg_exc = None
            self._bg = threading.Thread(target=self._bg_loop, daemon=True)
            self._bg.start()

    def _run_step(self, wav, f0):
        """Enqueue one chunk's step; returns its (toks, counts) on the device."""
        wav_t = torch.from_numpy(wav).to(self.device)
        f0_t = torch.tensor([f0], dtype=torch.int64, device=self.device)
        self.enc_state, self.ctx, toks, counts, _ = self._step(
            self.enc_state, self.ctx, wav_t, f0_t, self._mask1)
        return toks, counts

    @staticmethod
    def _materialize(toks, counts):
        return toks[0].cpu().tolist()[: int(counts[0])]

    def _bg_loop(self):
        """Pump thread: runs packaged chunks strictly in order. Owns
        enc_state/ctx while running (the caller touches them only after
        _bg_join, when the pump is idle)."""
        while True:
            item = self._bg_queue.get()
            if item is None:
                self._bg_queue.task_done()
                return
            try:
                if self._bg_exc is None:
                    new = self._materialize(*self._run_step(*item))
                    with self._bg_lock:
                        self._tokens.extend(new)
                        self._bg_new.extend(new)
            except BaseException as e:  # raised on the caller thread
                self._bg_exc = e
            finally:
                self._bg_queue.task_done()

    def _bg_join(self):
        """Block until the pump has drained every queued chunk; re-raise
        any pump-side failure on the caller thread."""
        if self._bg is None:
            return
        self._bg_queue.join()
        if self._bg_exc is not None:
            exc, self._bg_exc = self._bg_exc, None
            raise exc

    def close(self):
        """Stop the pump thread (background mode only); idempotent."""
        if self._bg is not None:
            self._bg_queue.put(None)
            self._bg.join()
            self._bg = None

    def accept_waveform(self, audio):
        audio = np.asarray(audio, np.float32)
        self.sample_buffer = np.concatenate([self.sample_buffer, audio])
        self.total_samples += len(audio)

    def _frames_available(self):
        # snip_edges=False framing: frame f covers samples
        # [160 f - 120, 160 f + 280); frame computable once we have
        # 160 f + 280 samples (reflection applies only at stream end).
        return max(0, (len(self.sample_buffer) - 280) // 160)

    def is_ready(self):
        return self._frames_available() - self.frame_cursor \
            >= 2 * self.scfg.chunk_frames

    def _drain(self):
        """Materialize the in-flight step's tokens into self._tokens."""
        if self._pending is None:
            return []
        toks, counts = self._pending
        self._pending = None
        new = self._materialize(toks, counts)
        self._tokens.extend(new)
        return new

    @property
    def tokens(self):
        """All emitted token ids (drains the in-flight step first)."""
        if self._bg is not None:
            self._bg_join()
            with self._bg_lock:
                return list(self._tokens)
        self._drain()
        return self._tokens

    def _package_chunk(self):
        """Slice the next chunk window out of the sample buffer and advance
        the frame cursor. Host numpy work only: safe on the caller thread
        in background mode."""
        n_frames = 2 * self.scfg.chunk_frames
        f0 = self.frame_cursor
        wav = np.zeros((1, self._win_samples), np.float32)
        buf = self.sample_buffer[: self._win_samples]
        wav[0, : len(buf)] = buf
        self.frame_cursor += n_frames
        # trim consumed samples, keeping the frame overlap margin
        keep_from = max(0, self.frame_cursor * 160 - 400)
        if keep_from:
            self.sample_buffer = self.sample_buffer[keep_from:]
            self.frame_cursor -= keep_from // 160
        return wav, f0

    def decode(self):
        """Consume one chunk of fbank frames; returns newly emitted token ids
        (from the PREVIOUS in-flight chunk; see the class docstring). In
        background mode the step runs on the pump thread and this returns
        whatever the pump has materialized since the last call."""
        wav, f0 = self._package_chunk()
        if self._bg is not None:
            if self._bg_exc is not None:
                self._bg_join()  # raises
            self._bg_queue.put((wav, f0))
            with self._bg_lock:
                new, self._bg_new = self._bg_new, []
            return new
        new = self._drain()
        self._pending = self._run_step(wav, f0)
        return new

    def get_result(self):
        if self._bg is not None:
            self._bg_join()
        else:
            self._drain()
        return self.peek_result()

    def peek_result(self):
        """Text from already-materialized tokens only: does NOT wait for
        the in-flight step (a partial can lag one chunk; get_result is
        complete)."""
        if self._bg is not None:
            with self._bg_lock:
                toks = list(self._tokens)
        else:
            toks = self._tokens
        return _pieces_text(self.model, toks)

    def reset(self):
        if self._bg is not None:
            self._bg_join()  # pump idle => safe to touch the carries
            with self._bg_lock:
                self._bg_new = []
        self.enc_state = init_streaming_state(self.model.zip_cfg, self.scfg, 1,
                                              self.device)
        self.ctx = torch.zeros((1, 2), dtype=torch.int64, device=self.device)
        self._tokens = []
        self._pending = None
        # Drop unconsumed buffered audio: reset starts a NEW utterance;
        # leftovers would otherwise leak into it.
        self.sample_buffer = np.array([], np.float32)
        self.frame_cursor = 0
        self.total_samples = 0


class OnlineStreamingSession:
    """Queue-driven session over OnlineRecognizer (the reference's online
    run loop, no Qt): partials on change, finals at endpoints,
    speaker-separator insertion between utterances."""

    SPEAKER_SEP = "__SPK_SEP__"

    def __init__(self, model, on_text, **recognizer_kwargs):
        self.rec = OnlineRecognizer(model, **recognizer_kwargs)
        self.on_text = on_text
        self.last_text = ""
        self.queued_speaker = None
        self.segment_start_samples = 0

    def insert_speaker(self, name):
        self.queued_speaker = name

    def push_chunk(self, audio_chunk):
        if isinstance(audio_chunk, (bytes, bytearray)):
            audio_chunk = (np.frombuffer(audio_chunk, np.int16)
                           .astype(np.float32) / 32768.0)
        self.rec.accept_waveform(audio_chunk)
        if not self.rec.is_ready():
            return
        self.rec.decode()
        text = self.rec.get_result()
        if text and text != self.last_text:
            ts = max(self.rec.total_samples / SAMPLE_RATE,
                     self.segment_start_samples / SAMPLE_RATE)
            self.on_text(text, False, ts)
            self.last_text = text
        if self.rec.is_endpoint():
            self._finalize()

    def _finalize(self):
        text = self.rec.get_result()
        if text:
            self.on_text(text, True,
                         self.segment_start_samples / SAMPLE_RATE)
        if self.queued_speaker:
            self.on_text(f" {self.SPEAKER_SEP}{self.queued_speaker}"
                         f"{self.SPEAKER_SEP}", True, 0.0)
            self.queued_speaker = None
        self.rec.reset()
        self.last_text = ""
        self.segment_start_samples = self.rec.total_samples

    def finalize(self):
        if self.rec.get_result() or len(self.rec.buffer):
            self.rec.decode()
            self._finalize()


class MultiStreamRecognizer:
    """N concurrent live streams multiplexed into ONE fused step.

    A fixed slot array: each step runs all N slots at one shape, and a
    validity mask selects which slots' states advance, so slots join and
    leave without a rebuild. The API is the JAX package's, which its web
    service's websocket endpoint drives: open_stream, accept_waveform,
    ready_slots, step, get_result, close_stream.
    """

    _FIXED_F0 = 3  # frame_cursor stays in [0, 3) after buffer trimming

    def __init__(self, model, n_streams=8, chunk_frames=32, left_frames=128):
        self.model = model
        self.device = model.device
        self.n = n_streams
        self.scfg = StreamingConfig(chunk_frames=chunk_frames,
                                    left_frames=left_frames)
        self.enc_state = init_streaming_state(model.zip_cfg, self.scfg,
                                              n_streams, self.device)
        self._chunk_samples = window_samples(chunk_frames, self._FIXED_F0)
        self._step = functools.partial(fused_stream_step, model, self.scfg)
        self.active = [False] * n_streams
        self.buffers = [np.array([], np.float32) for _ in range(n_streams)]
        self.cursors = [0] * n_streams
        self.ctx = torch.zeros((n_streams, 2), dtype=torch.int64, device=self.device)
        self.tokens = [[] for _ in range(n_streams)]

    def open_stream(self):
        """Returns a slot id, or None if all slots are busy. The slot's
        state and context start from zero."""
        for s in range(self.n):
            if not self.active[s]:
                self.active[s] = True
                self.buffers[s] = np.array([], np.float32)
                self.cursors[s] = 0
                self.tokens[s] = []
                slot = torch.tensor([s], device=self.device)
                self.ctx = self.ctx.index_fill(0, slot, 0)
                self.enc_state = map_state(lambda a: a.index_fill(0, slot, 0.0),
                                           self.enc_state)
                return s
        return None

    def close_stream(self, slot):
        text = self.get_result(slot)
        self.active[slot] = False
        return text

    def accept_waveform(self, slot, audio):
        self.buffers[slot] = np.concatenate(
            [self.buffers[slot], np.asarray(audio, np.float32)])

    def ready_slots(self):
        n_f = 2 * self.scfg.chunk_frames
        out = []
        for s in range(self.n):
            if not self.active[s]:
                continue
            avail = max(0, (len(self.buffers[s]) - 280) // 160)
            if avail - self.cursors[s] >= n_f:
                out.append(s)
        return out

    def step(self):
        """Advance every ready slot by one chunk (ONE fused step).
        Returns {slot: [new token ids]}."""
        ready = self.ready_slots()
        if not ready:
            return {}
        n_f = 2 * self.scfg.chunk_frames
        wav = np.zeros((self.n, self._chunk_samples), np.float32)
        f0s = np.zeros((self.n,), np.int64)
        for s in ready:
            buf = self.buffers[s][: self._chunk_samples]
            wav[s, : len(buf)] = buf
            f0s[s] = self.cursors[s]
            self.cursors[s] += n_f
            keep_from = max(0, self.cursors[s] * 160 - 400)
            if keep_from:
                self.buffers[s] = self.buffers[s][keep_from:]
                self.cursors[s] -= keep_from // 160
        mask = np.zeros((self.n,), bool)
        mask[ready] = True
        dev = self.device
        self.enc_state, self.ctx, toks, counts, _ = self._step(
            self.enc_state, self.ctx, torch.from_numpy(wav).to(dev),
            torch.from_numpy(f0s).to(dev), torch.from_numpy(mask).to(dev))
        toks, counts = toks.cpu().numpy(), counts.cpu().numpy()
        out = {}
        for s in ready:
            new = [int(t) for t in toks[s][: int(counts[s])]]
            self.tokens[s].extend(new)
            out[s] = new
        return out

    def get_result(self, slot):
        return _pieces_text(self.model, self.tokens[slot])
