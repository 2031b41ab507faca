"""whisper-base [audio] -- enc-dec, conv frontend stub (arXiv:2212.04356).
The caller passes precomputed frame embeddings (B, 1500, d_model) as
``batch["embeds"]``; the decoder's serve steps attend to its own cache and
to the fixed 1500-frame cross-attention cache."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, head_dim=64, pattern=("dec",),
    norm="layernorm", enc_seq=1500,
))

SMOKE = register(CONFIG.replace(
    name="whisper-base-smoke", n_layers=2, enc_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, head_dim=16, enc_seq=16,
    param_dtype="float32", compute_dtype="float32", remat="none"))
