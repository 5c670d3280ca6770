# Wrapper of the CUDA beam-search kernel (csrc/beam_search.cu).
#
# Port of sherpa_vietnamese_asr_tpu/ops/beam_search_pallas.py, hotword branch
# included. beam_search_batch_cuda is the kernel's wrapper: for CPU tensors it
# runs the plain twin ops/beam_search.beam_search_batch; for CUDA tensors it
# launches the kernel, which runs every frame and the backward walk over its
# records in one launch (a cluster of CLUSTER blocks per chunk), or raises.

from __future__ import annotations

import torch

from sherpa_vietnamese_asr_tpu_torch.models.rnnt import Decoder, Joiner, RnntConfig
from sherpa_vietnamese_asr_tpu_torch.ops import cuda_lib
from sherpa_vietnamese_asr_tpu_torch.ops.beam_search import (
    BeamResult,
    HotwordTables,
    beam_search_batch,
    metric_constants,
)

# Kernel launches of beam_search_batch_cuda() on CUDA tensors, without and
# with hotword tables.
launches = 0
hotword_launches = 0

MAX_BEAM = 8
CLUSTER = 8  # blocks per chunk, each owning a 1/8 slice of the vocab
_SCRATCH = 8 * 64 * (MAX_BEAM + 1)  # the kernel's partial-sum floats
_SMEM_LIMIT = 227 * 1024 - 4 * 1024  # less the kernel's static shared memory


def _kernel_smem_bytes(t, e, d, j, v) -> int:
    """Dynamic shared memory of one block: its [beam, ceil(V/8)] logit
    slice, the [J, beam] hidden layer, the [D, beam] decoder rows, partial
    sums, the encoder frame, and the [2, beam, T] uint16 token histories
    that only the cluster's leader uses."""
    w = -(-v // CLUSTER)
    return (MAX_BEAM * (w + j + d) + _SCRATCH + e) * 4 + 2 * MAX_BEAM * t * 2


def _hotword_args(hw, dev, v):
    """(next_state, delta, node_score) pointers and S; (0, 0, 0), 0 without."""
    if hw is None:
        return [0, 0, 0], 0
    s = hw.next_state.shape[0]
    if s < 1 or hw.next_state.shape != (s, v) or hw.delta.shape != (s, v) \
            or hw.node_score.shape != (s,):
        raise ValueError(f"hotword tables must be [S, {v}], [S, {v}], [S]")
    if s * v >= 2 ** 31:
        raise ValueError(f"hotword tables too large for int32 indexing: "
                         f"S={s} x V={v} >= 2^31")
    for x, dt in ((hw.next_state, torch.int32), (hw.delta, torch.float32),
                  (hw.node_score, torch.float32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"hotword tables must be contiguous (int32, "
                             f"float32, float32) on {dev}; AsrModel.to() "
                             f"moves them")
    return [hw.next_state.data_ptr(), hw.delta.data_ptr(),
            hw.node_score.data_ptr()], s


def _beam_search_cuda(enc_out, enc_lens, decoder, joiner, cfg, beam_size, hw,
                      entry=None):
    """Launch svt_beam_search, or `entry`, another build of the same C entry
    point (an A/B against an earlier kernel), which counts no launch."""
    global launches, hotword_launches
    dev = enc_out.device
    b, t, e = enc_out.shape
    v, d, j = cfg.vocab_size, cfg.decoder_dim, cfg.joiner_dim
    conv_w = decoder.conv_weight.detach()
    ipg, k = conv_w.shape[1], conv_w.shape[2]
    if not 1 <= beam_size <= MAX_BEAM:
        raise ValueError(f"beam kernel takes beam_size 1..{MAX_BEAM}, got {beam_size}")
    if not 2 <= v <= 65536 or k > 4 or k != cfg.context_size:
        raise ValueError("beam kernel: vocab must be 2..65536 and context_size <= 4")
    if enc_out.dtype != torch.float32 or e != cfg.encoder_out_dim:
        raise ValueError(f"enc_out must be float32 [B, T, {cfg.encoder_out_dim}]")
    if enc_lens.shape != (b,):
        raise ValueError("enc_lens must be [B]")
    hw_ptrs, s_hw = _hotword_args(hw, dev, v)
    smem = _kernel_smem_bytes(t, e, d, j, v)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"beam kernel state ({smem} B) exceeds shared memory "
                         f"at T={t}, V={v}")
    f32, i32 = torch.float32, torch.int32
    # Weights in the kernel's layout, already contiguous float32; the
    # joiner's transposed copies are cached on the module.
    weights = [decoder.embedding.detach(), conv_w, *joiner.kernel_layout()]
    for w in weights:
        if w.device != dev or w.dtype != f32 or not w.is_contiguous():
            raise ValueError(f"beam kernel: weights must be contiguous float32 "
                             f"on {dev}")
    args = [enc_out.contiguous(), enc_lens.to(device=dev, dtype=i32).contiguous(),
            *weights]
    recs = [torch.empty((b, t, beam_size), dtype=i32, device=dev),
            torch.empty((b, t, beam_size), dtype=i32, device=dev),
            torch.empty((b, t, beam_size), dtype=f32, device=dev),
            torch.empty((b, t, beam_size, 4), dtype=f32, device=dev)]
    res = BeamResult(
        tokens=torch.empty((b, t), dtype=i32, device=dev),
        frames=torch.empty((b, t), dtype=i32, device=dev),
        tok_logp=torch.empty((b, t), dtype=f32, device=dev),
        entropy=torch.empty((b, t, 4), dtype=f32, device=dev),
        num_tokens=torch.empty((b,), dtype=i32, device=dev),
        total_logp=torch.empty((b,), dtype=f32, device=dev))
    if b == 0:
        return res
    if t == 0:
        for x in (res.tokens, res.frames, res.tok_logp, res.entropy,
                  res.num_tokens, res.total_logp):
            x.zero_()
        return res
    _, max_entropy, tsallis_max = metric_constants(v)
    outs = [res.tokens, res.frames, res.tok_logp, res.entropy,
            res.num_tokens, res.total_logp]
    fn = entry or cuda_lib.library().svt_beam_search
    status = fn(
        *[x.data_ptr() for x in args], *hw_ptrs,
        *[x.data_ptr() for x in recs + outs],
        b, t, e, d, ipg, k, j, v, beam_size, cfg.blank_id, cfg.unk_id, s_hw,
        float(tsallis_max), float(max_entropy), cuda_lib.stream(dev))
    cuda_lib.check(status, "svt_beam_search")
    if entry is None:
        if hw is None:
            launches += 1
        else:
            hotword_launches += 1
    return res


def beam_search_batch_cuda(enc_out, enc_lens, decoder: Decoder,
                           joiner: Joiner, cfg: RnntConfig,
                           beam_size: int = 8,
                           hw_tables: HotwordTables | None = None) -> BeamResult:
    """Modified beam search with the shapes and semantics of
    ops/beam_search.beam_search_batch.

    enc_out: [N, T, E] float32; enc_lens: [N]. CPU tensors run the plain
    twin; CUDA tensors launch the kernel (beam_size 1..8; hotword tables on
    the same device, any S with S * V < 2^31).
    """
    if enc_out.device.type == "cpu":
        return beam_search_batch(enc_out, enc_lens, decoder, joiner, cfg,
                                 beam_size=beam_size, hw_tables=hw_tables)
    if enc_out.device.type != "cuda":
        raise ValueError(f"beam search: unsupported device {enc_out.device}")
    with torch.no_grad():
        return _beam_search_cuda(enc_out, enc_lens, decoder, joiner, cfg,
                                 beam_size, hw_tables)
