"""qwen2-vl-2b [vlm] -- M-RoPE, dynamic resolution (arXiv:2409.12191).
Vision frontend is a stub: the caller passes precomputed patch embeddings
(B, S, d_model) as ``batch["embeds"]``; the transformer backbone below is
exact."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, head_dim=128,
    mrope=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
))

SMOKE = register(CONFIG.replace(
    name="qwen2-vl-2b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, head_dim=16,
    mrope_sections=(2, 3, 3), param_dtype="float32",
    compute_dtype="float32", remat="none"))
