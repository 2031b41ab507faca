"""Parity of repro_torch's flash_prefill with repro's, on the CPU.

The JAX side runs ``flash_prefill_pallas`` in interpret mode through its
ops wrapper, as tests/test_seqmix_reference.py runs it, and the model's
``attention_dense``; the port's op takes its plain version on CPU tensors.
Tolerances are test_seqmix_reference.py's: f32 3e-5, bf16 4e-2.  In bf16
the kernels keep the softmax weights p in f32 for the PV product;
``attention_dense`` casts p to bf16 first, so it is compared in f32 only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.flash_prefill.ops import (  # noqa: E402
    flash_prefill as jax_flash_prefill)
from repro.models.layers import attention_dense  # noqa: E402
from repro.models.sharding import CPU_CTX  # noqa: E402
from repro_torch.kernels.flash_prefill.kernel import flash_prefill_cuda  # noqa: E402
from repro_torch.kernels.flash_prefill.ops import flash_prefill  # noqa: E402
from repro_torch.models.layers import attention_prefill  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 3e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 4e-2)}


def _inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32))


@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_prefill_matches_pallas(window, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    q, k, v = _inputs(2, 256, 4, 2, 128, 7)
    got = flash_prefill(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                        window=window)
    assert got.dtype == tdt
    want = jax_flash_prefill(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             window=window, use_pallas=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("window", [0, 24])
def test_prefill_attention_matches_attention_dense(window):
    """The port's prefill attention == the JAX model's attention_dense at
    S = 64 (f32), causal and windowed."""
    b, s, h, kv, d = 2, 64, 4, 2, 16
    q, k, v = _inputs(b, s, h, kv, d, 8)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None], (b, s))
    want = attention_dense(CPU_CTX, *(jnp.asarray(a) for a in (q, k, v)),
                           pos, pos, window or None, q_chunk=16)
    got = attention_prefill(*(torch.from_numpy(a) for a in (q, k, v)),
                            window or None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_prefill_rejects_other_positions():
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("qwen3-32b-smoke")
    params = M.init_params(cfg, device="cpu")
    tok = torch.zeros((1, 8), dtype=torch.int32)
    cache = M.init_cache(cfg, 1, 8, device="cpu")
    M.prefill(params, {"tokens": tok, "positions": torch.arange(8)[None]},
              cache, cfg)
    with pytest.raises(NotImplementedError, match="default positions"):
        M.prefill(params, {"tokens": tok,
                           "positions": torch.arange(8)[None] + 1},
                  cache, cfg)


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 1, 8, 0))
    before = flash_prefill_cuda.launches
    flash_prefill(q, k, v)
    assert flash_prefill_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        flash_prefill_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_prefill_cuda(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("d", (0, 4, 12, 264))
def test_head_dims_the_kernels_refuse(d):
    from repro_torch.kernels.gqa_decode.kernel import check_head_dim
    with pytest.raises(ValueError, match="multiple of 8"):
        check_head_dim(d, "test")
