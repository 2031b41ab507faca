"""Import the ported architecture configs to populate the registry.

Every decoder-only family of the JAX package is here; qwen2-vl-2b (vlm)
and whisper-base (audio) come with their front ends."""
from repro_torch.configs import (qwen3_32b, h2o_danube3_4b,  # noqa: F401
                                 minicpm3_4b, qwen15_110b, xlstm_350m,
                                 arctic_480b, mixtral_8x22b,
                                 recurrentgemma_2b)

ASSIGNED = [
    "qwen3-32b", "h2o-danube-3-4b", "minicpm3-4b", "qwen1.5-110b",
    "xlstm-350m", "arctic-480b", "mixtral-8x22b", "recurrentgemma-2b",
]
