"""Import every architecture config to populate the registry: all ten of
the JAX package's, the vlm (qwen2-vl-2b) and audio (whisper-base) families
with the stub front ends of their JAX configs (the caller passes patch or
frame embeddings)."""
from repro_torch.configs import (qwen2_vl_2b, qwen3_32b,  # noqa: F401
                                 h2o_danube3_4b, minicpm3_4b, qwen15_110b,
                                 xlstm_350m, arctic_480b, mixtral_8x22b,
                                 whisper_base, recurrentgemma_2b)

ASSIGNED = [
    "qwen2-vl-2b", "qwen3-32b", "h2o-danube-3-4b", "minicpm3-4b",
    "qwen1.5-110b", "xlstm-350m", "arctic-480b", "mixtral-8x22b",
    "whisper-base", "recurrentgemma-2b",
]
