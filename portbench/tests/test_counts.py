"""The frozen operation and byte counts against the bounds recorded for the
port's kernels (NVIDIA H100 peaks at 700 W)."""

import pytest

from portbench.harness import counts

ZIPFORMER_30M = dict(num_encoder_layers=[2, 2, 3, 4, 3, 2], downsampling_factor=[1, 2, 4, 8, 4, 2],
                     encoder_dim=[192, 256, 256, 256, 256, 256], ffn_dim=[512, 768, 768, 768, 768, 768],
                     num_heads=[4, 4, 4, 8, 4, 4], cnn_module_kernel=[31, 31, 15, 15, 15, 31],
                     query_head_dim=32, pos_head_dim=4, value_head_dim=12)


@pytest.mark.parametrize("name, got, recorded_ms", [
    # B 8, T 823, V 2000, beam 8 over 3,560 valid chunk-frames: operations
    ("beam", lambda: counts.beam_bound_s(8, 823, 3560, 8), 1.119),
    # Zipformer-30M stack 0 (T 1646, H 4): bytes of the bf16 weights
    ("attention", lambda: counts.attention_bound_s(8, 1646, 4), 0.0562),
    # Zipformer-30M stack 0 (T_pad 1664, D 192): operations at the bf16 rate
    ("layer", lambda: counts.layer_bound_s(8, 1664, 192, 4, 512, 31), 0.0451),
    # Zipformer-68M stacks 2 / 3 (D 384 / 512, T_pad 512 / 256)
    ("layer68_2", lambda: counts.layer_bound_s(8, 512, 384, 4, 1024, 15), 0.0344),
    ("layer68_3", lambda: counts.layer_bound_s(8, 256, 512, 8, 1536, 15), 0.0323),
])
def test_bounds_match_the_recorded_ones(name, got, recorded_ms):
    assert got() * 1e3 == pytest.approx(recorded_ms, abs=5e-5 if recorded_ms < 0.1 else 5e-4)


def test_beam_frame_is_21_mflop():
    assert counts.beam_frame_ops(8, 256, 512, 4, 2, 512, 2000) == 21_065_984


def test_encoder_ops_per_audio_second():
    # 30 s of audio: 3000 fbank frames; about 1.5 GFLOP an audio second
    assert counts.encoder_ops(ZIPFORMER_30M, 3000) / 30 == pytest.approx(1.506e9, rel=1e-3)


def test_decode_floor_adds_encoder_and_search():
    cfg = dict(ZIPFORMER_30M, compute_dtype="float32", decoder_dim=512, context_size=2,
               joiner_dim=512, vocab_size=2000)
    floor = counts.decode_floor_s(cfg, [(3000, 748)], 8)
    want = counts.encoder_ops(cfg, 3000) / counts.PEAK_FP32 + 748 * 21_065_984 / counts.PEAK_FP32
    assert floor == pytest.approx(want)
    bf16 = counts.decode_floor_s(dict(cfg, compute_dtype="bfloat16"), [(3000, 748)], 8)
    assert bf16 < floor
