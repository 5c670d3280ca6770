# Data parallelism over a list of devices: each batch split into one equal
# piece per device, one model replica per device, no collective.
#
# Port of sherpa_vietnamese_asr_tpu/parallel/sharding.py. The reference has
# no distributed compute (its only parallelism is a 2-thread CPU worker
# pool over chunks), and the JAX package shards the padded batch over a
# mesh's "data" axis with replicated parameters. Here a mesh is a plain
# list of torch devices; the stages (pipeline/decoder, diarization_pure,
# quality, gec) pad their batch to a multiple of it, upload and launch
# every device's piece before reading any result back, and concatenate the
# pieces in device order. CUDA work is launched under its device's guard,
# since the kernels' C entry points launch on the current device. A device
# may appear more than once (two replicas on one card share one copy of
# the weights); default_mesh() is None unless the host has several cards,
# so a one-card host runs the single-device path.

from __future__ import annotations

import contextlib
import copy
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices of a one-axis data-parallel mesh, in piece order."""
    devices: tuple
    axis_name: str = "data"

    @property
    def size(self) -> int:
        return len(self.devices)


def as_device(device) -> torch.device:
    """`device` as a torch.device with an index on CUDA (the current device
    for a bare "cuda", which raises without one), comparable to a
    tensor's .device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """A mesh over `devices` (names or torch.devices), every CUDA device
    when None."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device is available; pass "
                               "the devices, e.g. make_mesh(['cpu'])")
    devices = tuple(as_device(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: empty device list")
    return Mesh(devices, axis_name)


def default_mesh() -> Mesh | None:
    """A mesh over every CUDA device when the host has more than one, else
    None (one card, or the CPU): stages then run unsplit."""
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        return make_mesh()
    return None


def resolve(mesh) -> Mesh | None:
    """A stage's `mesh` argument: "auto" is default_mesh()."""
    return default_mesh() if isinstance(mesh, str) and mesh == "auto" else mesh


def round_up(n: int, mesh: Mesh | None) -> int:
    """n rounded up to a multiple of the mesh size."""
    return n if mesh is None else -(-n // mesh.size) * mesh.size


def device_scope(device):
    """The current-device guard of a CUDA device; nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _copies(obj, mesh: Mesh | None, device_of, move):
    """One object per mesh device: `obj` itself where it already sits, one
    moved copy per other distinct device (shared by its repeats); [obj]
    without a mesh."""
    if mesh is None:
        return [obj]
    by_device = {device_of(obj): obj}
    out = []
    for dev in mesh.devices:
        if dev not in by_device:
            by_device[dev] = move(obj, dev)
        out.append(by_device[dev])
    return out


def replicate(obj, mesh: Mesh | None) -> list:
    """One copy of a module or tensor per mesh device."""
    if isinstance(obj, torch.Tensor):
        return _copies(obj, mesh, lambda t: t.device, lambda t, d: t.to(d))
    return _copies(obj, mesh, lambda m: next(m.parameters()).device,
                   lambda m, d: copy.deepcopy(m).to(d))


def shard_model(model, mesh: Mesh | None) -> list:
    """One AsrModel per mesh device (the encoder, decoder, joiner and
    hotword tables moved together)."""
    def move(m, dev):
        return dataclasses.replace(
            m, encoder=copy.deepcopy(m.encoder), decoder=copy.deepcopy(m.decoder),
            joiner=copy.deepcopy(m.joiner)).to(dev)
    return _copies(model, mesh, lambda m: m.device, move)


def shard_batch(arr, mesh: Mesh | None, device=None):
    """Pad the leading axis with zero rows up to a multiple of the mesh and
    upload one equal piece to each device; without a mesh, the whole array
    to `device`.

    Returns (pieces, n): callers slice the merged outputs back to n. The
    zero rows run like any other and are dropped, so every device sees one
    shape."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    if mesh is None:
        return [torch.from_numpy(arr).to(device)], n
    m = round_up(n, mesh)
    if m != n:
        arr = np.concatenate([arr, np.zeros((m - n,) + arr.shape[1:], arr.dtype)])
    step = m // mesh.size
    pieces = []
    for i, dev in enumerate(mesh.devices):
        piece = torch.from_numpy(np.ascontiguousarray(arr[i * step: (i + 1) * step]))
        pieces.append(piece.to(dev))
    return pieces, n


def gather(pieces, n=None) -> np.ndarray:
    """Host copies of the per-device pieces, concatenated in device order
    and cut to n rows."""
    out = np.concatenate([p.cpu().numpy() for p in pieces], axis=0)
    return out if n is None else out[:n]


def decode_batch_sharded(model, audio, lens, mesh: Mesh):
    """Decode a [B, L] chunk batch data-parallel over the mesh: each device
    runs fbank, the encoder and the beam search on its piece.

    Returns (BeamResult of host numpy arrays, enc_lens) for the B real
    rows."""
    from sherpa_vietnamese_asr_tpu_torch.ops.beam_search import BeamResult
    from sherpa_vietnamese_asr_tpu_torch.pipeline.decoder import decode_feats, fbank_batch

    replicas = shard_model(model, mesh)
    audio_pieces, n = shard_batch(np.asarray(audio, np.float32), mesh)
    frame_pieces, _ = shard_batch((np.asarray(lens, np.int32) + 80) // 160, mesh)
    launched = []
    with torch.no_grad():
        for rep, a, f in zip(replicas, audio_pieces, frame_pieces):
            with device_scope(a.device):
                launched.append(decode_feats(fbank_batch(a), f, rep))
    result = BeamResult(**{k.name: gather([getattr(r, k.name) for r, _ in launched], n)
                           for k in dataclasses.fields(BeamResult)})
    return result, gather([e for _, e in launched], n)


def vad_probs_sharded(vad, audio_windows, mesh: Mesh):
    """Data-parallel VAD front end: window features of [N, 576] windows
    split over the mesh, then the sequential LSTM over all of them on the
    first device. Returns [N] probabilities there."""
    from sherpa_vietnamese_asr_tpu_torch.models.silero_vad import lstm_scan, window_features

    replicas = replicate(vad, mesh)
    pieces, n = shard_batch(np.asarray(audio_windows, np.float32), mesh)
    first = mesh.devices[0]
    with torch.no_grad():
        feats = []
        for rep, w in zip(replicas, pieces):
            with device_scope(w.device):
                feats.append(window_features(rep, w))
        probs, _ = lstm_scan(replicas[0], torch.cat([f.to(first) for f in feats])[:n])
    return probs
