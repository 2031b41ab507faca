"""Model configurations (copies of the JAX package's)."""
from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      list_configs, register)
