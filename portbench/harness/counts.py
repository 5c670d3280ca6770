"""Operations, bytes and peaks: the yardstick of the roofline and mfu
metrics, frozen from the shapes of each launch.

A kernel's bound is the larger of its bytes (each input read once, each
output written once) at the memory rate and its operations at the peak of
their type. Peaks are NVIDIA's published dense rates of one H100 SXM at its
700 W limit.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12   # outside the tensor cores
PEAK_TF32 = 495e12  # tensor cores
PEAK_BF16 = 989e12  # tensor cores
F32, B16, I32 = 4, 2, 4


def bound_s(nbytes, *work):
    """Seconds: max(bytes / PEAK_BYTES, sum of operations / their peak);
    work is (operations, peak) pairs, flattened."""
    by_ops = sum(f / p for f, p in zip(work[::2], work[1::2]))
    return max(nbytes / PEAK_BYTES, by_ops)


def beam_frame_ops(beam, e, d, ipg, k, j, v):
    """Operations of one chunk-frame of modified beam search: the decoder's
    grouped conv over the beam, the encoder frame's joiner projection, the
    beam's decoder projection and output layer (2 a multiply-add), and 10 a
    logit for log-softmax, metrics and top-k."""
    return (2 * beam * d * ipg * k + 2 * e * j + 2 * beam * d * j
            + 2 * beam * j * v + 10 * beam * v)


def beam_bound_s(b, t, valid_frames, beam, e=256, d=512, ipg=4, k=2, j=512, v=2000):
    """One beam-kernel launch over [b, t, e] encoder frames of which
    valid_frames (sum over chunks of min(len, t)) are live: inputs and
    float32 weights read once, the [b, t, beam] records and the outputs
    written once, the operations at the float32 rate."""
    read = F32 * (b * t * e + v * d + d * ipg * k + e * j + j + d * j + j + j * v + v) + I32 * b
    written = b * t * beam * 28 + b * t * 28 + b * 8
    return bound_s(read + written, valid_frames * beam_frame_ops(beam, e, d, ipg, k, j, v), PEAK_FP32)


def attention_bound_s(b, t, h, qd=32, pd=4, pos_dim=48):
    """One attention-weights launch: q, k, pq, the position projection, the
    position table and lens read once, the [b, h, t, t] bf16 weights written
    once; the content product (2 qd a weight) at the TF32 tensor-core rate
    three times over (3xTF32 keeps float32 accuracy), the position band
    (2 pd a weight) and 4 more a weight for the softmax, with the table's
    projection, at the float32 rate."""
    weights = b * h * t * t
    read = F32 * (2 * b * t * h * qd + b * t * h * pd + pos_dim * h * pd
                  + (2 * t - 1) * pos_dim) + I32 * b
    rest = weights * (2 * pd + 4) + 2 * (2 * t - 1) * pos_dim * h * pd
    return bound_s(read + B16 * weights, 3 * 2 * qd * weights, PEAK_TF32, rest, PEAK_FP32)


def layer_linears(d, h, qd, pd, vd, ff):
    """(d_in, d_out) of a Zipformer2 layer's 20 linears (ff the stack's
    feed-forward width: ff1 3/4 of it, ff3 5/4)."""
    hna = 3 * d // 4
    ff1, ff3 = (ff * 3) // 4, (ff * 5) // 4
    return [(d, h * (2 * qd + pd)), (d, 3 * hna), (hna, d),
            (d, h * vd), (h * vd, d), (d, h * vd), (h * vd, d),
            (d, ff1), (ff1, d), (d, ff), (ff, d), (d, ff3), (ff3, d),
            (d, 2 * d), (d, d), (d, 2 * d), (d, d)]


def layer_ops(b, t, d, h, ff, kernel, qd=32, pd=4, vd=12):
    """Operations of one layer over b sequences of t frames: its linears,
    two depthwise convs, the scores and position band (2 (qd + pd) a
    weight, 4 more for the softmax), the nonlinear attend and the two
    self-attention attends."""
    hna = 3 * d // 4
    ops = sum(2 * b * t * i * o for i, o in layer_linears(d, h, qd, pd, vd, ff))
    ops += 2 * (2 * b * t * kernel * d)
    ops += b * h * t * t * (2 * (qd + pd) + 4) + 2 * b * t * t * hna
    ops += 2 * (2 * b * h * t * t * vd)
    return ops


def layer_bound_s(b, t_pad, d, h, ff, kernel, qd=32, pd=4, vd=12):
    """One whole-layer (kernel 4) launch over the padded rows: x read and
    the output written once in float32, every bf16 weight and bias, the
    depthwise kernels, the float32 norm and bypass vectors, the bf16
    position rows and lens read once; the operations at the bf16
    tensor-core rate."""
    lin = layer_linears(d, h, qd, pd, vd, ff)
    operands = B16 * sum(i * o + o for i, o in lin) + 2 * B16 * (kernel * d + d)
    operands += F32 * (d + 1 + d + d)
    poslin = B16 * h * (2 * t_pad - 1 + 128) * pd
    nbytes = 2 * F32 * b * t_pad * d + operands + poslin + I32 * b
    return bound_s(nbytes, layer_ops(b, t_pad, d, h, ff, kernel, qd, pd, vd), PEAK_BF16)


def embed_ops(t_fbank, d0, c=(8, 32, 128), f=80):
    """Operations of the Conv2dSubsampling + ConvNeXt embed on t_fbank
    frames."""
    t1, f1 = t_fbank - 2, f
    t2, f2 = (t1 - 3) // 2 + 1, (f1 - 3) // 2 + 1
    t3, f3 = t2 - 2, (f2 - 3) // 2 + 1
    ops = 2 * 9 * c[0] * t1 * f1 + 2 * 9 * c[0] * c[1] * t2 * f2 + 2 * 9 * c[1] * c[2] * t3 * f3
    ops += 2 * 49 * c[2] * t3 * f3 + 2 * 2 * (c[2] * 3 * c[2]) * t3 * f3
    ops += 2 * t3 * c[2] * f3 * d0
    return ops


def encoder_ops(cfg, t_fbank):
    """Operations of the offline encoder on one utterance of t_fbank valid
    frames, every stack at its own rate."""
    t = max(0, (t_fbank - 7) // 2)
    ops = embed_ops(t_fbank, cfg["encoder_dim"][0])
    for i, n in enumerate(cfg["num_encoder_layers"]):
        ds = cfg["downsampling_factor"][i]
        ops += n * layer_ops(1, -(-t // ds), cfg["encoder_dim"][i], cfg["num_heads"][i],
                             cfg["ffn_dim"][i], cfg["cnn_module_kernel"][i],
                             cfg["query_head_dim"], cfg["pos_head_dim"], cfg["value_head_dim"])
    return ops


def decode_floor_s(cfg, rows, beam):
    """Least time the chip needs for the decode of `rows`, each (valid
    fbank frames, valid encoder frames): the encoder at the peak of the
    configuration's encoder precision, the beam search at the float32
    rate."""
    enc_peak = PEAK_BF16 if cfg["compute_dtype"] == "bfloat16" else PEAK_FP32
    e = max(cfg["encoder_dim"])
    per_frame = beam_frame_ops(beam, e, cfg["decoder_dim"], 4, cfg["context_size"],
                               cfg["joiner_dim"], cfg["vocab_size"])
    enc = sum(encoder_ops(cfg, t_f) for t_f, _ in rows)
    frames = sum(t_e for _, t_e in rows)
    return enc / enc_peak + frames * per_frame / PEAK_FP32
