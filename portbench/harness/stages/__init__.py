"""Stage models of the pipeline (diarization, punctuation, quality): one
module here a kind, found by the `kind` a configuration's "stages" entry
names. A configuration lists each stage with its published widths, its
source, the generator offset its weights are drawn from (seed +
seed_offset) and `when`: the pipeline options that turn it on (each option
one of the listed values). A cell draws and checks a stage only when its
mix's options turn it on.

A kind's module gives:
  LOADER                 the models/assets function the program loads the
                         stage's checkpoint with; the benchmark's weights
                         stand in for it;
  CHECKS                 the names of the numbers it compares;
  program_module(widths) the program's module at those widths;
  fill(module, generator, device)  the benchmark's values for every
                         entry of its state that the common draw leaves
                         (band edges, norm statistics);
  captures(rec)          [(object, attribute, wrapper)]: the wrappers that
                         keep, in rec.kept(), what the timed path produced
                         for the sampled requests;
  judge(widths, w, got, ctx, device, P)  {check: number} of one request:
                         `w` the weights by name on the device, `got` the
                         request's captures, ctx {"audio": the audio the
                         stage models see, "speech": the speech-only
                         audio}, P the reference's precision;
  control(widths, w, got, ctx, device, P)  the captures the reference
                         itself gives in precision P (the control), in the
                         form judge reads.
"""

from __future__ import annotations

import importlib


def plugin(kind):
    return importlib.import_module(f"portbench.harness.stages.{kind}")


def active(cfg, options):
    """[(name, entry)] of the configuration's stages that `options` turn on."""
    return [(name, entry) for name, entry in cfg.get("stages", {}).items()
            if all(options.get(k) in values for k, values in entry["when"].items())]


def to_device(state, device):
    """The stage's weights by name as float32 tensors on `device`."""
    import numpy as np
    import torch

    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in state.items()
            if np.issubdtype(np.asarray(v).dtype, np.floating)}


def quantized(audio):
    """The audio as the diarizer uploads it: rounded to 16-bit integers
    (clipped), over 32768."""
    import numpy as np

    return (np.clip(np.rint(np.asarray(audio, np.float32) * 32768.0), -32768, 32767)
            / np.float32(32768.0)).astype(np.float32)
