# Stand-in checkpoints for rehearsing `cli verify-assets` (models/verify_assets.py).
#
# No checkpoint is in the repository, so the rehearsal runs on files this
# package writes from its own modules, under each asset's MANIFEST directory
# and file names, with the MANIFEST re-pinned to the written files' own
# SHA-256 for the run. The ASR asset is the executable export
# (models/onnx_export_rnnt: the encoder graph at static batch 1 and t_in
# frames, the decoder and joiner graphs) and DNSMOS the executable
# build_dnsmos_graph, which load_dnsmos reads back. Every other file holds
# initializers only, because its loader reads only the upstream names
# (the JAX builders' PyanNet, ResNet34 and ViBERT graphs carry graph names
# and folded constants), or no graph builder exists (CAM++, Conv-TasNet,
# Silero): verify-assets reports those exec rows as "weight-only export"
# skips. Used by chip_smoke.py phase 13 at full width and by
# tests/test_torch_verify_assets.py at tiny widths.

from __future__ import annotations

import os

import numpy as np

from sherpa_vietnamese_asr_tpu_torch.models import assets


def random_plda(dim: int = 256, lda_dim: int = 128, seed: int = 0) -> dict:
    """A PLDA in the raw npz layout (mean1, mean2, lda, mu, tr, psi) that
    pipeline/diarization_pure.load_plda prepares, from `seed`."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"mean1": rng.standard_normal(dim).astype(f32) * 0.1,
            "mean2": rng.standard_normal(lda_dim).astype(f32) * 0.1,
            "lda": (rng.standard_normal((dim, lda_dim)) / np.sqrt(dim)).astype(f32),
            "mu": rng.standard_normal(lda_dim).astype(f32) * 0.1,
            "tr": (np.eye(lda_dim) + 0.1 * rng.standard_normal((lda_dim, lda_dim))).astype(f32),
            "psi": rng.uniform(0.5, 2.0, lda_dim).astype(f32)}


def _write_asr(model, d, names, t_in, executable):
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_export_rnnt import asr_graphs, write_tokens

    graphs = asr_graphs(model, t_in if executable else None)
    for name in names:
        role = name.split("-", 1)[0]
        if role in graphs:
            with open(os.path.join(d, name), "wb") as f:
                f.write(graphs[role])
    write_tokens(os.path.join(d, "tokens.txt"), model.id2token)
    with open(os.path.join(d, "bpe.model"), "wb") as f:
        f.write(b"synthetic")  # read by hotword tokenization only


def write_assets(root: str, models: dict, t_in: int = 96) -> dict:
    """Write each asset of `models` under root/<MANIFEST local_dir>/ with
    its MANIFEST file names. Keys and values:
      zipformer-30m / zipformer-68m: an AsrModel, written executable at t_in;
      zipformer-30m-streaming: an AsrModel (initializers only);
      vibert-capu: (ViBert, vocab list);
      segmentation and embedding-split: a PyanNet and a ResNetSpeaker
        (both or neither);
      plda: a random_plda() dict;
      campp, silero-vad, convtasnet, dnsmos: a Campp, SileroVad, ConvTasNet,
        Dnsmos.
    Returns a copy of assets.MANIFEST with every written asset pinned to the
    written files' SHA-256."""
    from sherpa_vietnamese_asr_tpu_torch.models import onnx_export_aux as aux
    from sherpa_vietnamese_asr_tpu_torch.models import onnx_export_diar as diar

    def local(key):
        d = os.path.join(root, assets.MANIFEST[key]["local_dir"])
        os.makedirs(d, exist_ok=True)
        return d

    def write(key, files):
        d = local(key)
        for name, data in files.items():
            os.makedirs(os.path.dirname(os.path.join(d, name)), exist_ok=True)
            with open(os.path.join(d, name), "wb") as f:
                f.write(data)

    for key in ("zipformer-30m", "zipformer-68m", "zipformer-30m-streaming"):
        if key in models:
            _write_asr(models[key], local(key), assets.MANIFEST[key]["files"], t_in,
                       executable=key != "zipformer-30m-streaming")
    if "vibert-capu" in models:
        model, vocab = models["vibert-capu"]
        d = local("vibert-capu")
        aux.export_vibert_files(model, vocab, d)
        write("vibert-capu", {
            "vocabulary/labels.txt": "".join(f"LABEL_{i}\n" for i in range(model.cfg.n_labels)).encode(),
            "vocabulary/d_tags.txt": "".join(f"DTAG_{i}\n" for i in range(model.cfg.n_d_tags)).encode()})
    if "segmentation" in models or "embedding-split" in models:
        diar.export_diarization_files(models["segmentation"], models["embedding-split"],
                                      local("segmentation"))
    if "plda" in models:
        np.savez(os.path.join(local("plda"), "plda_prepared.npz"), **models["plda"])
    if "campp" in models:
        diar.export_campp_file(models["campp"], local("campp"))
    if "silero-vad" in models:
        aux.export_silero_file(models["silero-vad"], local("silero-vad"))
    if "convtasnet" in models:
        diar.export_convtasnet_file(models["convtasnet"], local("convtasnet"))
    if "dnsmos" in models:
        write("dnsmos", {"sig_bak_ovr.onnx": aux.build_dnsmos_graph(models["dnsmos"], 1)})

    manifest = dict(assets.MANIFEST)
    for key in models:
        spec = assets.MANIFEST[key]
        d = os.path.join(root, spec["local_dir"])
        manifest[key] = {**spec, "files": {
            name: assets.sha256_file(os.path.join(d, name)) for name in spec["files"]}}
    return manifest
