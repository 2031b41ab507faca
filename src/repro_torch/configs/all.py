"""Import the ported architecture configs to populate the registry.

Only the dense attention families whose serving path the port runs are
here; the other families of the JAX package come with their slices."""
from repro_torch.configs import qwen3_32b, h2o_danube3_4b  # noqa: F401

ASSIGNED = ["qwen3-32b", "h2o-danube-3-4b"]
