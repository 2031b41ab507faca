"""arctic-480b [moe] -- 128 experts top-2 + dense residual FFN
(hf:Snowflake/snowflake-arctic-base).  Expert-parallel over the TP axis
(128 % 16 == 0 -> 8 experts/chip); bf16 optimizer state (DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, head_dim=128, pattern=("moe",),
    n_experts=128, top_k=2, moe_dense_ff=4864,
    opt_dtype="bfloat16", grad_accum=2,
))

SMOKE = register(CONFIG.replace(
    name="arctic-480b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=96, vocab=512, head_dim=16, n_experts=8,
    moe_dense_ff=96, capacity_factor=4.0, param_dtype="float32", compute_dtype="float32",
    opt_dtype="float32", remat="none"))
