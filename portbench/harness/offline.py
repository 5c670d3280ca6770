"""Offline cells: requests through TranscriberPipeline.run() (the entry
`transcribe` and the server's queue call) from one closed-loop client.

Each request passes the mix's "options" (none by default) to the
pipeline, as the web service passes a job's settings, and takes the
pipeline's default VAD path, as `transcribe` and the queue do: the
pipeline builds Silero on the card from assets.load_silero() on every
request, and the benchmark's load_silero returns the benchmark's weights
(a checkpoint would also be hashed there; that is the one per-request cost
left out). The stage models the options turn on (diarization, punctuation,
quality) load the benchmark's weights in the same way, through their
assets.load_* functions. The benchmark wraps, from its own files, the
calls into the program's layers: the VAD's
silero_vad_probs_streamed, the decoder's fbank_batch and beam search,
BatchedChunkDecoder.decode_spans and _launch. The wrappers keep what
sampled requests produced for the correctness check; with --trace 1 they
also count launches, record launch shapes and open the host spans the
profiler names idle gaps by.

The kind "offline" of a traffic file: `run` is one run of a cell,
`control` the control's checks on the requests a run would compare.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from portbench.harness import audio as audio_mod
from portbench.harness import check_offline, profiling, stages, stats, traffic, weights


class Recorder:
    """What the wrappers saw. `capture` is the index of the request whose
    outputs are being kept (None: none); `counting` turns on launch counts
    and shapes (the traced slice)."""

    def __init__(self):
        self.capture = None
        self.captured = {}
        self.counting = False
        self.reset_counts()
        self.rows = []  # (real rows, batch) of every decode launch
        self.silero = None  # (state, config) load_silero returns
        self.plugins = []  # the kinds of the cell's stage models (harness/stages)
        self.loaded = {}  # {assets loader name: (state, config)} of the stage models

    def reset_counts(self):
        self.launches = {"beam": [], "attention": [], "layer": [], "fbank": 0, "frames": []}

    def kept(self):
        return self.captured.setdefault(self.capture, {"batches": [], "feats": [], "embeds": []})


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def wrappers(rec: Recorder, spans: bool):
    """Install the benchmark's wrappers around the program's layer calls."""
    from sherpa_vietnamese_asr_tpu_torch.models import assets, silero_vad, zipformer
    from sherpa_vietnamese_asr_tpu_torch.pipeline import decoder, transcriber
    from sherpa_vietnamese_asr_tpu_torch.pipeline import vad as vad_mod

    span = profiling.span if spans else (lambda name: contextlib.nullcontext())
    orig = {"fbank": decoder.fbank_batch, "beam": decoder.beam_search_batch_cuda,
            "spans": decoder.BatchedChunkDecoder.decode_spans,
            "launch": decoder.BatchedChunkDecoder._launch, "decode": decoder.decode_feats,
            "attn": zipformer.attention_weights, "layer": zipformer.encoder_layer,
            "vad": vad_mod.get_vad_segments, "load": transcriber.load_audio,
            "merge": transcriber.merge_chunks_with_overlap,
            "suspect": transcriber.suspect_detect, "probs": silero_vad.silero_vad_probs_streamed}

    def load_silero(verify=True):
        return rec.silero

    def stage_loader(name):
        return lambda verify=True: rec.loaded[name]

    def vad_probs(*a, **kw):
        probs = orig["probs"](*a, **kw)
        if rec.capture is not None:
            rec.kept()["probs"] = probs.cpu().numpy()
        return probs

    def fbank_batch(audio):
        out = orig["fbank"](audio)
        if rec.counting:
            rec.launches["fbank"] += 1
        if rec.capture is not None:
            rec.kept()["feats"].append(out)
        return out

    def beam(enc_out, enc_lens, dec, joi, cfg, beam_size=8, hw_tables=None):
        res = orig["beam"](enc_out, enc_lens, dec, joi, cfg, beam_size=beam_size,
                           hw_tables=hw_tables)
        if rec.counting:
            rec.launches["beam"].append((enc_out.shape, enc_lens, beam_size))
        if rec.capture is not None:
            rec.kept()["batches"].append((enc_out, enc_lens, res))
        return res

    def decode_feats(feats, n_frames, model):
        if rec.counting:
            rec.launches["frames"].append(n_frames)
        return orig["decode"](feats, n_frames, model)

    def decode_spans(self, concat_audio, spans_, *a, **kw):
        if rec.capture is not None:
            rec.kept().update(concat=concat_audio, spans=list(spans_), max_batch=self.max_batch)
        with span("transcription"):
            return orig["spans"](self, concat_audio, spans_, *a, **kw)

    def launch(self, concat_audio, group):
        rec.rows.append((len(group), self.max_batch))
        return orig["launch"](self, concat_audio, group)

    def attention_weights(q, k, pq, *a, **kw):
        if rec.counting and q.is_cuda:
            rec.launches["attention"].append(tuple(q.shape))
        return orig["attn"](q, k, pq, *a, **kw)

    def encoder_layer(layer, x, rev_pos, lens):
        if rec.counting and x.is_cuda:
            rec.launches["layer"].append((tuple(x.shape), layer.heads, layer.ff2.in_proj.out_features,
                                          layer.conv1.dw_weight.shape[-1]))
        return orig["layer"](layer, x, rev_pos, lens)

    def get_vad_segments(*a, **kw):
        with span("vad"):
            return orig["vad"](*a, **kw)

    def load_audio(*a, **kw):
        with span("load_audio"):
            return orig["load"](*a, **kw)

    def merge(*a, **kw):
        with span("merge_suspect"):
            return orig["merge"](*a, **kw)

    def suspect(*a, **kw):
        with span("merge_suspect"):
            return orig["suspect"](*a, **kw)

    with contextlib.ExitStack() as stack:
        for obj, name, fn in ((assets, "load_silero", load_silero),
                              (silero_vad, "silero_vad_probs_streamed", vad_probs),
                              (decoder, "fbank_batch", fbank_batch),
                              (decoder, "beam_search_batch_cuda", beam),
                              (decoder, "decode_feats", decode_feats),
                              (decoder.BatchedChunkDecoder, "decode_spans", decode_spans),
                              (decoder.BatchedChunkDecoder, "_launch", launch),
                              (zipformer, "attention_weights", attention_weights),
                              (zipformer, "encoder_layer", encoder_layer),
                              (vad_mod, "get_vad_segments", get_vad_segments),
                              (transcriber, "load_audio", load_audio),
                              (transcriber, "merge_chunks_with_overlap", merge),
                              (transcriber, "suspect_detect", suspect)):
            stack.enter_context(patched(obj, name, fn))
        for kind in rec.plugins:
            stack.enter_context(patched(assets, kind.LOADER, stage_loader(kind.LOADER)))
            for obj, name, fn in kind.captures(rec):
                stack.enter_context(patched(obj, name, fn))
        yield


class OfflineCell:
    """A configuration under an offline mix."""

    def __init__(self, cfg, mix, seed, device, log=print):
        self.cfg, self.mix, self.seed, self.device, self.log = cfg, mix, seed, device, log
        self.options = dict(mix.get("options", {}))
        self.stages = stages.active(cfg, self.options)  # [(name, entry)]
        self.rec = Recorder()
        self.rec.plugins = [stages.plugin(entry["kind"]) for _, entry in self.stages]
        self.stage_states = {}

    def setup(self, workdir):
        """Weights, the pool written as WAV files, the VAD's state as a
        checkpoint would give it."""
        self.model, self.weights = weights.asr_model(self.cfg, self.seed, self.device)
        vad, self.vad_weights = weights.silero(self.cfg, self.seed, self.device)
        self.rec.silero = ({k: v.cpu().numpy() for k, v in vad.state_dict().items()}, vad.cfg)
        del vad
        for (name, entry), kind in zip(self.stages, self.rec.plugins):
            self.stage_states[name] = weights.stage(entry, self.seed, self.device)
            self.rec.loaded[kind.LOADER] = self.stage_states[name]
        rec = self.rec

        def keep_embed(module, inputs, output):
            if rec.capture is not None:
                rec.kept()["embeds"].append(output)

        self.model.encoder.encoder_embed.register_forward_hook(keep_embed)
        self.pool = []
        for i, (dur, samples) in enumerate(traffic.offline_pool(self.mix, self.seed)):
            path = os.path.join(workdir, f"r{i:03d}.wav")
            audio_mod.write_wav(path, samples)
            self.pool.append((path, dur))
        # Sampled for the check: the pool's longest file and others drawn
        # from the seed, all within the first pass over the pool.
        n = min(self.mix["check_requests"], len(self.pool))
        longest = int(np.argmax([d for _, d in self.pool]))
        others = [int(i) for i in traffic.rng(self.seed, 4).permutation(len(self.pool)) if i != longest]
        self.sample = sorted([longest] + others[: n - 1])

    def stage_refs(self):
        """[(entry, state)] of the cell's stage models, for the check."""
        return [(entry, self.stage_states[name][0]) for name, entry in self.stages]

    def request(self, index):
        """One request of the closed loop: (wall s, audio s, result)."""
        from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

        path, dur = self.pool[index % len(self.pool)]
        # A sampled request is kept once: the first time it runs.
        self.rec.capture = index if index in self.sample and index not in self.rec.captured else None
        try:
            t0 = time.perf_counter()
            res = TranscriberPipeline(path, self.model, dict(self.options)).run()
            wall = time.perf_counter() - t0
        finally:
            self.rec.capture = None
        if res is None or not res.get("segments"):
            raise RuntimeError(f"request {index}: no result")
        return wall, dur, res

    def warm(self):
        """One request of the pool's shortest file: every shape the cell's
        requests use (the decode batch is fixed at 8 x 33 s, VAD blocks at
        1,875 windows; the diarizer's superblocks at 64 windows, ViBERT's
        minibatches at 32 rows of a power-of-two length)."""
        from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import TranscriberPipeline

        shortest = int(np.argmin([d for _, d in self.pool]))
        TranscriberPipeline(self.pool[shortest][0], self.model, dict(self.options)).run()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.rec.rows.clear()

    def window(self, seconds):
        """Requests until `seconds` have passed; the window runs from the
        first request's start to the last one's end. Returns the records."""
        records, failed, i = [], 0, 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            try:
                wall, dur, res = self.request(i)
                records.append({"index": i, "wall_s": wall, "audio_s": dur, "timing": res["timing"],
                                "words": sum(len(s.get("raw_words", [])) for s in res["segments"])})
            except Exception as e:  # a failed request counts, and the run goes on
                self.log(f"request {i} failed: {type(e).__name__}: {e}")
                failed += 1
            i += 1
        t_end = time.perf_counter()
        for j in self.sample:  # sampled requests the window did not reach
            if j >= i:
                self.request(j)
        return records, failed, i, t_end - t_start

    def traced_slice(self, first, count):
        """`count` more requests under the profiler with launch counts on."""
        rec = self.rec
        state = {"next": first}

        def fn():
            rec.reset_counts()
            rec.counting = True
            try:
                for _ in range(count):
                    self.request(state["next"])
                    state["next"] += 1
            finally:
                rec.counting = False
            counts = {"beam_kernel": len(rec.launches["beam"]),
                      "logmel_kernel": rec.launches["fbank"]}
            if rec.launches["attention"]:
                counts["attn_kernel"] = len(rec.launches["attention"])
            if rec.launches["layer"]:
                counts["attn_bf16_kernel"] = len(rec.launches["layer"])
            return counts

        window, _ = profiling.profile(fn, log=self.log)
        return window, {k: list(v) if isinstance(v, list) else v for k, v in rec.launches.items()}


def run(cfg, mix, seed, seconds, trace, device, log):
    cell = OfflineCell(cfg, mix, seed, device, log=log)
    t = {"cfg": cfg, "trace": trace}
    with tempfile.TemporaryDirectory(prefix="portbench-") as work, \
            wrappers(cell.rec, spans=trace):
        cell.setup(work)
        cell.warm()
        t["setup_done"] = time.perf_counter()
        with stats.GcClock() as gc_clock, stats.HostClock() as host_clock:
            records, failed, attempted, window = cell.window(seconds)
        t.update(requests=records, window_s=window)
        rows = cell.rec.rows
        walls = sorted(r["wall_s"] for r in records)
        if walls:
            by_file = {}
            for r in records:
                by_file.setdefault(r["audio_s"], []).append(r["wall_s"])
            log(f"window: {len(walls)} requests in {window:.3f} s, wall min {walls[0]:.4f} median "
                f"{walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s; {gc_clock}; "
                f"{len(rows)} decode launches, {sum(r for r, _ in rows)} real rows, "
                f"{sum(r['words'] for r in records)} words; order "
                + " ".join(str(int(r['audio_s'])) for r in records[:len(cell.pool)]))
            log(f"host: {host_clock}; median wall by file: " + " ".join(
                f"{int(d)} s {sorted(w)[len(w) // 2]:.4f} ({len(w)})" for d, w in sorted(by_file.items())))
        if device.type == "cuda":
            torch.cuda.synchronize()
            t["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
        if trace:
            t["profile"], t["launches"] = cell.traced_slice(attempted, mix["trace_requests"])
            keys = sorted({k for r in records for k in r["timing"]})
            log("mean request timing (s): " + " ".join(
                f"{k} {sum(r['timing'][k] for r in records) / max(1, len(records)):.4f}" for k in keys)
                + f"; wall {sum(r['wall_s'] for r in records) / max(1, len(records)):.4f}"
                + f"; words {sum(r['words'] for r in records) / max(1, len(records)):.1f}")
        got = {i: check_offline.program_outputs(cell.rec.captured[i]) for i in cell.sample}
        paths = {i: cell.pool[i][0] for i in cell.sample}
        del cell.model
        cell.rec.captured.clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = check_offline.judge_all(cfg, cell.weights, cell.vad_weights,
                                         [(paths[i], got[i]) for i in cell.sample], device,
                                         cell.stage_refs())
        log(f"check: {len(cell.sample)} requests against the reference in "
            f"{time.perf_counter() - t_check:.3f} s")
    return t, checks, attempted, failed


def control(cfg, mix, seed, seconds, device):
    """The checks of the control on the sampled requests of an offline cell
    (`seconds` unused: the sample lies in the first pass over the pool).
    A stage model that follows the program from its own inputs (ViBERT, on
    the program's subword ids) reads them from the program's run of the same
    request."""
    oc = OfflineCell(cfg, mix, seed, device)
    with tempfile.TemporaryDirectory(prefix="portbench-") as work, wrappers(oc.rec, spans=False):
        oc.setup(work)
        if oc.stages:
            for i in oc.sample:
                oc.request(i)
        program = dict(oc.rec.captured)
        del oc.model
        requests = [(oc.pool[i][0], check_offline.control_outputs(
            cfg, oc.weights, oc.vad_weights, oc.pool[i][0], device, cfg["control"], oc.stage_refs(),
            program.get(i))) for i in oc.sample]
        return check_offline.judge_all(cfg, oc.weights, oc.vad_weights, requests, device, oc.stage_refs())
