"""xlstm-350m [ssm] -- alternating sLSTM + mLSTM blocks (arXiv:2405.04517).
Constant-size recurrent state: long_500k eligible."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=256, pattern=("mlstm", "slstm"),
    subquadratic=True,
))

SMOKE = register(CONFIG.replace(
    name="xlstm-350m-smoke", n_layers=2, d_model=48, n_heads=2, n_kv_heads=2,
    head_dim=24, vocab=512, param_dtype="float32",
    compute_dtype="float32", remat="none"))
