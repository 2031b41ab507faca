"""mixtral-8x22b [moe] -- 8 experts top-2, SWA (arXiv:2401.04088).
8 experts don't shard over tp=16, so experts stay local and d_ff is
tensor-parallel; SWA rolling window makes long_500k eligible."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, head_dim=128, pattern=("moe",),
    n_experts=8, top_k=2, attn_kind="swa", window=4096,
    subquadratic=True, opt_dtype="bfloat16", grad_accum=2,
))

SMOKE = register(CONFIG.replace(
    name="mixtral-8x22b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab=512, head_dim=16, n_experts=4,
    window=16, capacity_factor=2.0, param_dtype="float32", compute_dtype="float32",
    opt_dtype="float32", remat="none"))
