# The bf16 tier's choice of the whole-layer kernel (kernel 4) per stack,
# decided from the shapes by the kernel's own tile plan:
#   * Zipformer-30M: every stack takes it on CUDA (t_ds of a 33 s chunk);
#   * Zipformer-68M: every stack takes it too; stacks 2, 3 and 4 (d 384 /
#     512 / 384) have nonlin attends of 288 / 384 / 288 columns, which the
#     kernel runs in two column tiles;
#   * "wide", a synthetic model at d 576 on every stack, has a nonlin attend
#     of 432 columns, past the kernel's two tiles (NONLIN_MAX_N 384): no
#     stack takes it, and those run the plain bf16 layer with the attention
#     kernel;
#   * a stack the gate sends to the kernel has a tile plan for every product.
# Pure Python: no card, no kernel build.
import dataclasses

import pytest

from sherpa_vietnamese_asr_tpu_torch.models import zipformer as tz
from sherpa_vietnamese_asr_tpu_torch.ops import encoder_layer as el

T_DS = (1646, 823, 412, 206, 412, 823)  # a 33 s chunk's frames per stack
CONFIGS = {"30m": tz.ZIPFORMER_30M, "68m": tz.ZIPFORMER_68M,
           "wide": dataclasses.replace(tz.ZIPFORMER_68M, encoder_dim=(576,) * 6,
                                       ffn_dim=(1536,) * 6)}
TAKES = {"30m": (True,) * 6, "68m": (True,) * 6, "wide": (False,) * 6}


@pytest.mark.parametrize("name", ["30m", "68m", "wide"])
@pytest.mark.parametrize("stack", range(6))
def test_gate_follows_the_tile_plan(name, stack):
    cfg = CONFIGS[name]
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    takes = tz.use_layer_kernel(bf16, stack, T_DS[stack], "cuda")
    assert takes == TAKES[name][stack]
    products = tz.stack_products(bf16, stack, T_DS[stack])
    errors = [el.plan_error(p) for p in products]
    if takes:
        assert errors == [None] * 20
        for p in products:
            el.tile_plan(p)
    else:
        assert [e for e in errors if e] == [
            f"attend nonlin_attend of width {3 * cfg.encoder_dim[stack] // 4} "
            f"(at most {el.NONLIN_MAX_N}, even) over {-(-T_DS[stack] // 128) * 128} rows"]
        with pytest.raises(ValueError, match="nonlin_attend"):
            el.tile_plan(products[4])
    # never on the CPU or in float32; "never"/"always" force
    assert not tz.use_layer_kernel(bf16, stack, T_DS[stack], "cpu")
    assert not tz.use_layer_kernel(cfg, stack, T_DS[stack], "cuda")
    assert tz.use_layer_kernel(dataclasses.replace(bf16, layer_kernel="always"),
                               stack, T_DS[stack], "cuda")
