"""h2o-danube-3-4b [dense] -- llama+mistral mix, sliding-window attention
(arXiv:2401.16818).  SWA makes it long_500k-eligible (rolling KV window)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab=32000, head_dim=120, attn_kind="swa", window=4096,
    subquadratic=True,
))

SMOKE = register(CONFIG.replace(
    name="h2o-danube-3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, head_dim=16, window=16,
    param_dtype="float32", compute_dtype="float32", remat="none"))
