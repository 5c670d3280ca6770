# Real-asset rehearsal: one command that proves the pinned checkpoints work.
#
# Port of sherpa_vietnamese_asr_tpu/models/verify_assets.py on this
# package's modules: the same checks, in the same order, with the same
# statuses, gates and report layout. No checkpoint is in the repository, so
# the rehearsal runs on files this package writes itself (chip_smoke.py
# phase 13, tests/test_torch_verify_assets.py); on a machine with the real
# assets `cli verify-assets` gives the full parity report unattended. Per
# asset:
#
#   1. hash      — SHA256 against the pinned MANIFEST (models/assets.py).
#   2. import    — the ONNX importer maps every tensor (no silent random
#                  fills; ImportReport lists anything unmapped).
#   3. forward   — the imported model runs on deterministic sample inputs
#                  on `device` and returns finite values of the right shape.
#   4. exec      — the REAL graph is executed by the numpy ONNX graph
#                  executor (models/onnx_exec.py) on the same inputs and the
#                  forward must match within gates (max_abs, rel_l2).
#                  Skipped for weight-only exports (no nodes).
#   5. tokens    — ASR only: beam-search tokens on the graph-executor
#                  encoder output equal tokens on the model's encoder output.
#
# Every forward runs on the card unless the caller names the CPU: there the
# ASR encoder launches the attention kernel (csrc/attention_weights.cu) and
# tokens.decode the beam kernel (csrc/beam_search.cu). Without a card the
# default raises before any check. A verifier that raises (a kernel that does
# not build or launch included) becomes a failed "verifier" row and a failed
# asset, never a pass. Checks degrade to explicit "skipped:" statuses rather
# than passing silently.

from __future__ import annotations

import os

import numpy as np
import torch

from sherpa_vietnamese_asr_tpu_torch.models import assets

MAX_ABS = 5e-3
REL_L2 = 1e-3


def _check(name, ok, detail=""):
    return {"check": name, "ok": bool(ok), "detail": str(detail)}


def _skip(name, why):
    return {"check": name, "ok": None, "detail": f"skipped: {why}"}


def _cmp(name, got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return _check(name, False, f"shape {got.shape} vs {ref.shape}")
    max_abs = float(np.abs(got - ref).max()) if got.size else 0.0
    denom = float(np.linalg.norm(ref)) or 1.0
    rel = float(np.linalg.norm(got - ref)) / denom
    ok = max_abs <= MAX_ABS and rel <= REL_L2
    return _check(name, ok, f"max_abs={max_abs:.2e} rel_l2={rel:.2e}")


def _finite(name, arr, shape=None):
    arr = np.asarray(arr)
    if shape is not None and tuple(arr.shape) != tuple(shape):
        return _check(name, False, f"shape {arr.shape}, want {shape}")
    return _check(name, bool(np.isfinite(arr).all()),
                  f"shape {arr.shape}, |mean|={float(np.abs(arr).mean()):.3g}")


def _np(t):
    return t.detach().float().cpu().numpy()


def _exec_graph(path, feed_arrays):
    """Run a real export through the numpy graph executor. Returns
    (outputs list, None) or (None, reason-to-skip)."""
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_exec import run_onnx
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import read_onnx

    graph = read_onnx(path)
    if not graph["nodes"]:
        return None, "weight-only export (no executable graph)"
    feed_names = [n for n in graph["inputs"]
                  if n not in graph["initializers"]]
    if len(feed_names) != len(feed_arrays):
        return None, (f"graph has {len(feed_names)} feeds "
                      f"({feed_names[:6]}…), sample provides "
                      f"{len(feed_arrays)}")
    try:
        outs = run_onnx(graph, dict(zip(feed_names, feed_arrays)))
    except Exception as e:  # surface as a failed check, not a crash
        return None, f"EXEC-ERROR {type(e).__name__}: {e}"
    return outs, None


def _exec_checks(label, path, feeds, model_outs):
    """exec cross-check rows for one graph (first len(model_outs) outputs)."""
    outs, why = _exec_graph(path, feeds)
    if outs is None:
        if why.startswith("EXEC-ERROR"):
            return [_check(f"{label}.exec", False, why)], None
        return [_skip(f"{label}.exec", why)], None
    rows = [_cmp(f"{label}.exec[{i}]", model_outs[i], outs[i])
            for i in range(min(len(model_outs), len(outs)))]
    return rows, outs


def _hash_checks(key):
    spec = assets.MANIFEST[key]
    root = os.path.join(assets.models_dir(), spec["local_dir"])
    rows = []
    present = True
    for fname, sha in spec["files"].items():
        path = os.path.join(root, fname)
        if not os.path.exists(path):
            rows.append(_check(f"hash.{fname}", False, "missing"))
            present = False
        elif sha is None:
            rows.append(_skip(f"hash.{fname}", "no pin (locally produced)"))
        else:
            got = assets.sha256_file(path)
            rows.append(_check(f"hash.{fname}", got == sha,
                               "ok" if got == sha else f"got {got[:16]}…"))
    return rows, present


# ---------------------------------------------------------------------------
# Per-asset verifiers (key, device -> list of check rows)
# ---------------------------------------------------------------------------

def _verify_asr(key, dev):
    from sherpa_vietnamese_asr_tpu_torch.models import registry
    from sherpa_vietnamese_asr_tpu_torch.models.onnx_import import read_onnx
    from sherpa_vietnamese_asr_tpu_torch.ops.beam_search_cuda import (
        beam_search_batch_cuda,
    )

    model_dir = assets.asr_model_dir(key)
    rows = []
    try:
        m = registry.load_asr_model(model_dir, compute_dtype="float32",
                                    device=dev)
        # Strict-parity forwards: f32 pos scores too, so exec cross-checks
        # compare exact math, not bf16 rounding of the serving default.
        m = registry.with_pos_dtype(m, "float32")
        rows.append(_check("import", True,
                           f"vocab={m.rnnt_cfg.vocab_size}"))
    except Exception as e:
        return rows + [_check("import", False, f"{type(e).__name__}: {e}")]

    rng = np.random.default_rng(0)
    t = 96
    x = rng.standard_normal((2, t, 80)).astype(np.float32) * 0.5
    lens = np.asarray([t, t * 2 // 3], np.int32)
    enc_t, enc_lens = m.encoder(torch.from_numpy(x).to(dev),
                                torch.from_numpy(lens).to(dev))
    enc = _np(enc_t)
    rows.append(_finite("forward.encoder", enc))
    ctx = np.asarray([[3, 7], [1, 2]], np.int32)
    with torch.no_grad():
        dec_t = m.decoder(torch.from_numpy(ctx).long().to(dev))
        logit = _np(m.joiner(enc_t[:, 0], dec_t))
    dec = _np(dec_t)
    rows.append(_finite("forward.decoder", dec,
                        (2, m.rnnt_cfg.decoder_dim)))
    rows.append(_finite("forward.joiner", logit,
                        (2, m.rnnt_cfg.vocab_size)))

    paths = assets.asset_paths(key, verify=False)
    enc_path = next(p for f, p in paths.items()
                    if f.startswith("encoder") and f.endswith(".onnx"))
    dec_path = next(p for f, p in paths.items()
                    if f.startswith("decoder") and f.endswith(".onnx"))
    joi_path = next(p for f, p in paths.items()
                    if f.startswith("joiner") and f.endswith(".onnx"))

    # Real sherpa exports take (x, x_lens); the executable exports of
    # models/onnx_export_rnnt are static-shape batch-1 taking only x. Adapt
    # the feed set to the graph's arity so both rehearse.
    enc_graph = read_onnx(enc_path)
    n_feeds = len([n for n in enc_graph["inputs"]
                   if n not in enc_graph["initializers"]])
    if n_feeds == 1:
        r, enc_outs = _exec_checks("encoder", enc_path, [x[:1]], [enc[:1]])
    else:
        r, enc_outs = _exec_checks("encoder", enc_path,
                                   [x, lens.astype(np.int64)], [enc])
    rows += r
    r, _ = _exec_checks("decoder", dec_path, [ctx.astype(np.int64)], [dec])
    rows += r
    r, _ = _exec_checks("joiner", joi_path, [enc[:, 0], dec], [logit])
    rows += r

    if enc_outs is not None:
        nb = np.asarray(enc_outs[0]).shape[0]
        el = enc_lens[:nb]
        res_model = beam_search_batch_cuda(
            enc_t[:nb].contiguous(), el, m.decoder, m.joiner, m.rnnt_cfg,
            beam_size=4)
        res_ref = beam_search_batch_cuda(
            torch.from_numpy(np.asarray(enc_outs[0], np.float32)).to(dev), el,
            m.decoder, m.joiner, m.rnnt_cfg, beam_size=4)
        same = torch.equal(res_model.tokens.cpu(), res_ref.tokens.cpu())
        rows.append(_check("tokens.decode", same,
                           "model-encoder vs graph-executor-encoder beam "
                           "tokens" + ("" if same else " DIFFER")))
    else:
        rows.append(_skip("tokens.decode", "encoder exec unavailable"))
    return rows


def _verify_streaming(key, dev):
    from sherpa_vietnamese_asr_tpu_torch.models import registry
    from sherpa_vietnamese_asr_tpu_torch.models.zipformer_streaming import (
        StreamingConfig,
        init_streaming_state,
        streaming_step,
    )

    model_dir = assets.asr_model_dir(key)
    rows = []
    try:
        m = registry.load_asr_model(model_dir, compute_dtype="float32",
                                    device=dev)
        rows.append(_check("import", True,
                           f"vocab={m.rnnt_cfg.vocab_size}"))
    except Exception as e:
        return rows + [_check("import", False, f"{type(e).__name__}: {e}")]
    scfg = StreamingConfig()
    state = init_streaming_state(m.zip_cfg, scfg, batch=1, device=dev)
    rng = np.random.default_rng(0)
    chunk = rng.standard_normal(
        (1, 2 * scfg.chunk_frames, 80)).astype(np.float32) * 0.5
    out, _ = streaming_step(m.encoder, state, torch.from_numpy(chunk).to(dev),
                            scfg)
    rows.append(_finite("forward.streaming_step", _np(out)))
    rows.append(_skip("exec", "stateful streaming graph exec not wired; "
                              "offline twin covers tensor parity"))
    return rows


def _verify_vibert(key, dev):
    from sherpa_vietnamese_asr_tpu_torch.models.convert import vibert_from_numpy

    rows = []
    loaded = assets.load_vibert_asset(verify=False)
    if loaded is None:
        return [_check("import", False, "files missing")]
    state, cfg = loaded
    model = vibert_from_numpy(state, cfg, device=dev)
    rows.append(_check("import", True, f"hidden={cfg.hidden}"))
    rng = np.random.default_rng(0)
    ids = rng.integers(5, min(cfg.vocab_size, 400), (1, 24)).astype(np.int32)
    mask = np.ones((1, 24), np.int32)
    types = np.zeros((1, 24), np.int32)
    offs = np.zeros((1, 24), np.int32)
    with torch.no_grad():
        logits, d_tags = (_np(o) for o in model.vibert_forward(
            *(torch.from_numpy(a).long().to(dev) for a in (ids, mask, types, offs))))
    rows.append(_finite("forward.labels", logits))
    rows.append(_finite("forward.d_tags", d_tags))
    paths = assets.asset_paths(key, verify=False)
    r, _ = _exec_checks(
        "model", paths["vibert-capu.onnx"],
        [ids.astype(np.int64), mask.astype(np.int64),
         types.astype(np.int64)],
        [logits, d_tags])
    return rows + r


def _verify_segmentation(key, dev):
    from sherpa_vietnamese_asr_tpu_torch.models.convert import pyannet_from_numpy

    rows = []
    loaded = assets.load_segmentation(verify=False)
    if loaded is None:
        return [_check("import", False, "files missing")]
    state, cfg = loaded
    model = pyannet_from_numpy(state, cfg, device=dev)
    rows.append(_check("import", True, ""))
    rng = np.random.default_rng(0)
    wav = rng.standard_normal((1, 1, 32000)).astype(np.float32) * 0.1
    with torch.no_grad():
        out = _np(model(torch.from_numpy(wav[:, 0]).to(dev)))
    rows.append(_finite("forward", out))
    paths = assets.asset_paths(key, verify=False)
    r, _ = _exec_checks("model", paths["segmentation-community-1.onnx"],
                        [wav], [out])
    return rows + r


def _verify_embedding_split(key, dev):
    from sherpa_vietnamese_asr_tpu_torch.models.convert import resnet_from_numpy
    from sherpa_vietnamese_asr_tpu_torch.ops.stats_pool import masked_stats_pool

    rows = []
    loaded = assets.load_embedding_split(verify=False)
    if loaded is None:
        return [_check("import", False, "files missing")]
    state, cfg = loaded
    model = resnet_from_numpy(state, cfg, device=dev)
    rows.append(_check("import", True, ""))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((1, 200, 80)).astype(np.float32)
    with torch.no_grad():
        frame_feat = model.resnet_frame_features(torch.from_numpy(feats).to(dev))
        weights = torch.ones((1, 1, frame_feat.shape[-1]), device=dev)  # [B, S=1, T']
        emb = _np(model.project_embedding(masked_stats_pool(frame_feat, weights)))
    rows.append(_finite("forward", emb))
    paths = assets.asset_paths(key, verify=False)
    r, _ = _exec_checks("encoder", paths["embedding_encoder.onnx"],
                        [feats], [_np(frame_feat)])
    return rows + r


def _verify_plda(key, dev):
    from sherpa_vietnamese_asr_tpu_torch.pipeline.diarization_pure import load_plda

    paths = assets.asset_paths(key, verify=False)
    if paths is None:
        return [_check("import", False, "files missing")]
    try:
        pd = load_plda(paths["plda_prepared.npz"])
    except Exception as e:
        return [_check("import", False, f"{type(e).__name__}: {e}")]
    rows = [_check("import", True, f"keys={sorted(pd)}")]
    for k in ("mean1", "mean2", "lda", "plda_mu", "plda_tr", "plda_psi"):
        rows.append(_finite(f"forward.{k}", pd[k]))
    return rows


def _verify_campp(key, dev):
    from sherpa_vietnamese_asr_tpu_torch.models.convert import campp_from_numpy

    rows = []
    loaded = assets.load_campp_asset(verify=False)
    if loaded is None:
        return [_check("import", False, "files missing")]
    state, cfg = loaded
    model = campp_from_numpy(state, cfg, device=dev)
    rows.append(_check("import", True, ""))
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((1, 150, 80)).astype(np.float32)
    emb = _np(model(torch.from_numpy(feats).to(dev)))
    rows.append(_finite("forward", emb))
    paths = assets.asset_paths(key, verify=False)
    r, _ = _exec_checks("model", paths["campplus_cn_en_common_200k.onnx"],
                        [feats], [emb])
    return rows + r


def _verify_silero(key, dev):
    from sherpa_vietnamese_asr_tpu_torch.models.convert import silero_from_numpy
    from sherpa_vietnamese_asr_tpu_torch.models.silero_vad import silero_vad_probs

    rows = []
    loaded = assets.load_silero(verify=False)
    if loaded is None:
        return [_check("import", False, "files missing")]
    state, cfg = loaded
    vad = silero_from_numpy(state, cfg, device=dev)
    rows.append(_check("import", True, ""))
    rng = np.random.default_rng(0)
    audio = rng.standard_normal(16000).astype(np.float32) * 0.1
    probs = _np(silero_vad_probs(vad, torch.from_numpy(audio).to(dev)))
    rows.append(_finite("forward", probs))
    ok_range = bool((probs >= 0).all() and (probs <= 1).all())
    rows.append(_check("forward.range", ok_range, "probs in [0,1]"))
    rows.append(_skip("exec", "stateful If/LSTM streaming graph exec not "
                              "wired; importer oracle-tested vs torch"))
    return rows


def _verify_convtasnet(key, dev):
    from sherpa_vietnamese_asr_tpu_torch.models.convert import convtasnet_from_numpy

    rows = []
    loaded = assets.load_convtasnet_asset(verify=False)
    if loaded is None:
        return [_check("import", False, "files missing")]
    state, cfg = loaded
    model = convtasnet_from_numpy(state, cfg, device=dev)
    rows.append(_check("import", True, ""))
    rng = np.random.default_rng(0)
    mix = rng.standard_normal((1, 8000)).astype(np.float32) * 0.1
    sep = _np(model(torch.from_numpy(mix).to(dev)))
    rows.append(_finite("forward", sep))
    paths = assets.asset_paths(key, verify=False)
    r, _ = _exec_checks("model", paths["convtasnet_16k.onnx"], [mix], [sep])
    return rows + r


def _verify_dnsmos(key, dev):
    from sherpa_vietnamese_asr_tpu_torch.models.convert import dnsmos_from_numpy

    rows = []
    loaded = assets.load_dnsmos_asset(verify=False)
    if loaded is None:
        return [_check("import", False, "files missing")]
    state, cfg = loaded
    model = dnsmos_from_numpy(state, cfg, device=dev)
    rows.append(_check("import", True, ""))
    rng = np.random.default_rng(0)
    audio = rng.standard_normal(int(16000 * 9.01)).astype(np.float32) * 0.1
    with torch.no_grad():
        out = _np(model(torch.from_numpy(audio[None]).to(dev)))
    rows.append(_finite("forward", out))
    paths = assets.asset_paths(key, verify=False)
    r, _ = _exec_checks("model", paths["sig_bak_ovr.onnx"],
                        [audio[None]], [out])
    return rows + r


_VERIFIERS = {
    "zipformer-30m": _verify_asr,
    "zipformer-68m": _verify_asr,
    "zipformer-30m-streaming": _verify_streaming,
    "vibert-capu": _verify_vibert,
    "segmentation": _verify_segmentation,
    "embedding-split": _verify_embedding_split,
    "plda": _verify_plda,
    "campp": _verify_campp,
    "silero-vad": _verify_silero,
    "convtasnet": _verify_convtasnet,
    "dnsmos": _verify_dnsmos,
}


def _device(device):
    """The device every forward runs on: the card unless the caller names
    the CPU; raises when a CUDA device is asked for and none is present."""
    from sherpa_vietnamese_asr_tpu_torch.models.registry import model_device

    return model_device("cuda" if device is None else device)


def verify_asset(key, device=None):
    """Full check list for one MANIFEST asset, its forwards on `device`
    (the card by default). Returns {status, checks}; status in
    verified|partial|failed|absent."""
    dev = _device(device)
    rows, present = _hash_checks(key)
    if not present:
        return {"status": "absent", "checks": rows}
    try:
        rows += _VERIFIERS[key](key, dev)
    except Exception as e:  # verifier crash = failed asset, not failed run
        rows.append(_check("verifier", False, f"{type(e).__name__}: {e}"))
    failed = [r for r in rows if r["ok"] is False]
    skipped = [r for r in rows if r["ok"] is None]
    status = ("failed" if failed else
              "partial" if skipped else "verified")
    return {"status": status, "checks": rows}


def verify_assets(keys=None, device=None):
    """Verify all (or selected) assets on `device` (the card by default).
    Returns {assets: {key: report}, ok: bool} — ok means nothing present
    FAILED (absent assets don't fail the run; they're reported)."""
    dev = _device(device)
    keys = list(keys) if keys else list(assets.MANIFEST)
    out = {}
    for key in keys:
        out[key] = verify_asset(key, dev)
    ok = all(r["status"] != "failed" for r in out.values())
    return {"assets": out, "ok": ok}


def format_report(report):
    lines = []
    for key, r in report["assets"].items():
        lines.append(f"{key}: {r['status'].upper()}")
        for c in r["checks"]:
            mark = {True: "ok  ", False: "FAIL", None: "skip"}[c["ok"]]
            lines.append(f"  [{mark}] {c['check']}: {c['detail']}")
    lines.append("overall: " + ("OK" if report["ok"] else "FAILED"))
    return "\n".join(lines)
