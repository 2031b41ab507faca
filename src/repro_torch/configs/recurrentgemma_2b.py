"""recurrentgemma-2b [hybrid] -- RG-LRU + local attention, pattern
(lru, lru, attn) (arXiv:2402.19427 Griffin).  26 = 8 periods + 2 tail
recurrent layers; local window 2048; MQA (kv=1); long_500k eligible."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, pattern=("rglru", "rglru", "attn"),
    window=2048, lru_dim=2560, conv_width=4,
    subquadratic=True,
))

SMOKE = register(CONFIG.replace(
    name="recurrentgemma-2b-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab=512, head_dim=16, window=16, lru_dim=64,
    param_dtype="float32", compute_dtype="float32", remat="none"))
