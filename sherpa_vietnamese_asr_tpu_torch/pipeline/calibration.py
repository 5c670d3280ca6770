# Decode batch sizing: max_batch "auto" (0, None or a negative value).
#
# Port of three functions of sherpa_vietnamese_asr_tpu/pipeline/
# calibration.py: resolve_max_batch (an explicit value wins, then the
# calibration report's recommendation, then the heuristic), auto_batch_size
# (the memory-tiered heuristic of every stage) and hbm_budget_mb, rewritten
# over torch.cuda.mem_get_info: the card's free memory, None on the CPU, so
# that "auto" resolves to the default there as the JAX package does on its
# CPU backend. The device calibration and the batch autotune of that module
# are not ported yet.

from __future__ import annotations

import json

import torch


def hbm_budget_mb(device=None):
    """Free memory of the card in MB (torch.cuda.mem_get_info), or None on
    a CPU device or a host without CUDA."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free / (1024 * 1024))


def auto_batch_size(stage, default, budget_mb=None, device=None):
    """Memory-tiered heuristic batch size of a stage, from the free memory
    of `device` unless `budget_mb` is given; `default` where there is no
    card."""
    if budget_mb is None:
        budget_mb = hbm_budget_mb(device)
    if budget_mb is None:
        return int(default)
    stage_key = (stage or "").lower()
    if "embedding" in stage_key:
        for floor, batch in ((10000, 32), (6000, 24), (3000, 16)):
            if budget_mb >= floor:
                return batch
        return 8
    if "punct" in stage_key or "vibert" in stage_key:
        for floor, batch in ((6000, 32), (2500, 16)):
            if budget_mb >= floor:
                return batch
        return 8
    if "campp" in stage_key or "speaker" in stage_key:
        for floor, batch in ((10000, 128), (7000, 96), (3500, 64)):
            if budget_mb >= floor:
                return batch
        return 32
    if budget_mb >= 7000:
        return max(default, 64)
    if budget_mb >= 3500:
        return max(default, 32)
    return min(default, 16)


def resolve_max_batch(config, report_path=None, device=None):
    """The decode batch size: an explicit max_batch > 0 wins (an absent key
    keeps 8); 0, None or a negative value ("auto") takes
    recommended.max_batch from the calibration report
    (config["calibration_report"], else calibration_report.json), else the
    heuristic over `device`'s free memory."""
    explicit = int((config or {}).get("max_batch", 8) or 0)
    if explicit > 0:
        return explicit
    path = report_path or (config or {}).get("calibration_report") \
        or "calibration_report.json"
    try:
        with open(path, encoding="utf-8") as f:
            report = json.load(f)
        rec = ((report.get("recommended") or {}).get("max_batch"))
        if rec:
            return int(rec)
    except (OSError, ValueError):
        pass
    return auto_batch_size("decode", 8, device=device)
