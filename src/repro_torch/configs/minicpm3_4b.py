"""minicpm3-4b [dense] -- MLA attention (hf:openbmb/MiniCPM3-4B).
Decode runs absorbed (latent-space) attention; cache = kv_lora_rank +
rope_dim per token."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=6400,
    vocab=73448, head_dim=64,
    mla=True, kv_lora_rank=256, q_lora_rank=768, rope_dim=32,
))

SMOKE = register(CONFIG.replace(
    name="minicpm3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512, head_dim=16,
    kv_lora_rank=24, q_lora_rank=32, rope_dim=8,
    param_dtype="float32", compute_dtype="float32", remat="none"))
