"""qwen1.5-110b [dense] -- QKV bias (hf:Qwen/Qwen1.5 family).
bf16 optimizer state: 110B params must fit 16 GB/chip x 256 (DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
    vocab=152064, head_dim=128, qkv_bias=True,
    opt_dtype="bfloat16", grad_accum=4,
))

SMOKE = register(CONFIG.replace(
    name="qwen1.5-110b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
    param_dtype="float32", compute_dtype="float32", opt_dtype="float32",
    remat="none"))
