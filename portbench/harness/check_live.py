"""The comparison that decides `correct` in a live cell.

For every stream and every step of the window that processed it, the
reference replays the stream's windows by the slot rule, computes their
fbank, runs the streaming encoder step with its own carried state, and
reads the served tokens:

  stream_enc_rel_err  worst chunk's ||program - reference|| / ||reference||
                      of the encoder frames the step produced;
  greedy_gap          widest gap by which a served symbol's logit lies below
                      the reference's best, over the alignment of the
                      chunk's served tokens to its frames that makes it
                      least (blank where no token), the context the tokens
                      served before it.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import fbank as ref_fbank
from portbench.reference import rnnt, streaming
from portbench.reference.host import StreamWindows
from portbench.reference.precision import Precision

NAMES = ("stream_enc_rel_err", "greedy_gap")


def program_outputs(steps_seen, n_streams):
    """[stream][chunk] encoder frames [16, E] of the captured steps."""
    out = [[] for _ in range(n_streams)]
    for enc, mask in steps_seen:
        for s in torch.nonzero(mask).flatten().tolist():
            out[s].append(enc[s])
    return out


def reference_frames(P, cfg, weights, streams, chunks, device):
    """[stream][chunk] reference encoder frames, all streams stepped together
    for max(chunks) steps."""
    n = len(streams)
    wins = [StreamWindows() for _ in range(n)]
    state = streaming.zero_state(cfg, n, device)
    out = [[] for _ in range(n)]
    for c in range(max(chunks, default=0)):
        feats = []
        for s, (_, samples) in enumerate(streams):
            win, f0 = wins[s].take(samples)
            f = ref_fbank.fbank(P, torch.from_numpy(win).to(device))
            feats.append(f[f0: f0 + 2 * streaming.CHUNK])
        enc, state = streaming.step(P, weights, cfg, state, torch.stack(feats))
        for s in range(n):
            if c < chunks[s]:
                out[s].append(enc[s])
    return out


def judge(cfg, weights, streams, enc_got, served, device):
    """{name: number}: enc_got [stream][chunk] frames, served
    [stream][chunk] token lists."""
    P = Precision("fp32")
    nums = dict.fromkeys(NAMES, 0.0)
    chunks = [len(x) for x in served]
    if [len(x) for x in enc_got] != chunks:
        return dict.fromkeys(NAMES, math.inf)
    ref = reference_frames(P, cfg, weights, streams, chunks, device)
    for s in range(len(streams)):
        hist = [0, 0]
        for c in range(chunks[s]):
            r, g = ref[s][c], enc_got[s][c].float()
            nums["stream_enc_rel_err"] = max(
                nums["stream_enc_rel_err"], float(torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r)))
            toks = served[s][c]
            if any(not 0 <= t < cfg["vocab_size"] for t in toks):
                nums["greedy_gap"] = math.inf
                continue
            nums["greedy_gap"] = max(nums["greedy_gap"], rnnt.greedy_gap(P, weights, r, hist[-2:], toks))
            hist += toks
    return nums


def control_outputs(cfg, weights, streams, chunks, device, mode):
    """The reference in `mode` put in the program's place: its encoder
    frames and its own greedy tokens (at most one a frame), per stream and
    chunk."""
    P = Precision(mode)
    enc = reference_frames(P, cfg, weights, streams, chunks, device)
    served = []
    for s in range(len(streams)):
        ctx, toks_s = [0, 0], []
        for c in range(chunks[s]):
            out = []
            with P.active():
                for t in range(enc[s][c].shape[0]):
                    dec = rnnt.decoder(P, weights, torch.tensor(ctx[-2:], device=device))
                    tok = int(torch.argmax(rnnt.joiner(P, weights, enc[s][c][t], dec)))
                    if tok != rnnt.BLANK:
                        out.append(tok)
                        ctx.append(tok)
            toks_s.append(out)
        served.append(toks_s)
    return enc, served
