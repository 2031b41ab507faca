"""Model configuration schema + registry (a copy of ``repro.configs.base``:
the port imports nothing of the JAX package).

Every config of the JAX package registers here; see
``repro_torch.configs.all``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

BlockStack = Tuple[Tuple[str, ...], int]     # (period of block kinds, count)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | vlm | moe | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # --- attention flavor
    attn_kind: str = "full"      # full | swa
    window: int = 4096           # SWA / local-attention window
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False          # M-RoPE (qwen2-vl): 3-section rotary
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # --- MLA (minicpm3)
    mla: bool = False
    kv_lora_rank: int = 256
    q_lora_rank: int = 768
    rope_dim: int = 32           # decoupled rope head dim for MLA
    # --- MoE
    n_experts: int = 0
    top_k: int = 2
    moe_dense_ff: int = 0        # arctic: parallel dense-FFN residual width
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- block pattern for ssm / hybrid / enc-dec families
    pattern: Tuple[str, ...] = ("attn",)
    enc_layers: int = 0          # whisper encoder depth
    enc_seq: int = 1500          # audio frames after conv stub
    # --- recurrent dims
    lru_dim: int = 0             # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4
    # --- norm / embedding
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- numerics & memory policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"   # bf16 for >=100B models (fits 16GB/chip)
    remat: str = "full"          # full | dots | none
    grad_accum: int = 1          # unrolled microbatches for train_* shapes
    # --- serving
    subquadratic: bool = False   # eligible for long_500k
    notes: str = ""

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def stacks(self, n_layers: Optional[int] = None) -> List[BlockStack]:
        """Decompose the layer stack into homogeneous scan-able stacks:
        list of (period, count).  A period is a tuple of block kinds applied
        in order; count is the scan length."""
        l = self.n_layers if n_layers is None else n_layers
        p = len(self.pattern)
        out: List[BlockStack] = []
        if l // p > 0:
            out.append((self.pattern, l // p))
        if l % p:
            out.append((tuple(self.pattern[: l % p]), 1))
        return out

    def with_layers(self, n_layers: int, enc_layers: Optional[int] = None):
        kw = {"n_layers": n_layers}
        if self.is_encdec:
            kw["enc_layers"] = enc_layers if enc_layers is not None else n_layers
        return dataclasses.replace(self, **kw)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM pool (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs.all  # noqa: F401  (populate registry)
    return _REGISTRY[name]


def list_configs() -> List[str]:
    import repro_torch.configs.all  # noqa: F401
    return sorted(_REGISTRY)

