"""qwen3-32b [dense] -- qk_norm, GQA (hf:Qwen/Qwen3-8B family scaling)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6,
    grad_accum=2,
))

SMOKE = register(CONFIG.replace(
    name="qwen3-32b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=512, head_dim=16, param_dtype="float32",
    compute_dtype="float32", remat="none"))
