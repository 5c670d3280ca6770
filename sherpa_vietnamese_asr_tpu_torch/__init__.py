# sherpa_vietnamese_asr_tpu_torch — the PyTorch/CUDA port of
# sherpa_vietnamese_asr_tpu (the JAX package, which stays the reference).
#
# It imports torch and never jax. On CUDA tensors its hand-written kernels
# (csrc/*.cu) are built at first use; on CPU tensors every op runs its plain
# PyTorch twin.

__version__ = "0.1.0"

from sherpa_vietnamese_asr_tpu_torch.models.registry import (  # noqa: F401
    MODEL_30M,
    MODEL_68M,
    AsrModel,
    random_asr_model,
)
from sherpa_vietnamese_asr_tpu_torch.pipeline.transcriber import (  # noqa: F401
    TranscriberPipeline,
)
from sherpa_vietnamese_asr_tpu_torch.utils.audio_io import load_audio  # noqa: F401
