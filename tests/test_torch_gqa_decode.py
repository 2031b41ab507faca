"""Parity of repro_torch's gqa_decode with repro's, on the CPU.

The JAX side runs ``gqa_decode_pallas`` in interpret mode, as
tests/test_kernels.py runs it, and ``gqa_decode_ref``; the port's op takes
its plain version on CPU tensors.  Tolerances are test_kernels.py's: f32
2e-5, bf16 3e-2 (bf16 inputs, f32 accumulation in both)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.gqa_decode.kernel import gqa_decode_pallas  # noqa: E402
from repro.kernels.gqa_decode.ref import gqa_decode_ref as jax_ref  # noqa: E402
from repro_torch.kernels.gqa_decode.kernel import gqa_decode_cuda  # noqa: E402
from repro_torch.kernels.gqa_decode.ops import gqa_decode  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(b, h, kv, d, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.integers(1, s + 1, b).astype(np.int32))


def _port(q, k, v, ln, tdt):
    out = gqa_decode(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                     torch.from_numpy(ln))
    assert out.dtype == tdt
    return out.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,h,kv,d,s", [(2, 8, 2, 128, 512),
                                        (1, 4, 4, 128, 256),
                                        (4, 16, 8, 128, 1024)])
def test_gqa_decode_matches_pallas_and_ref(b, h, kv, d, s, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    q, k, v, ln = _inputs(b, h, kv, d, s, b * s)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(ln)]
    got = _port(q, k, v, ln, tdt)
    for want in (gqa_decode_pallas(*jargs, st=min(256, s)), jax_ref(*jargs)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=atol, rtol=0)


def test_gqa_decode_masks_empty_tail():
    b, h, kv, d, s = 1, 4, 2, 128, 512
    q = np.ones((b, h, d), np.float32)
    k = np.ones((b, s, kv, d), np.float32)
    v = np.concatenate([np.ones((b, 10, kv, d)),
                        np.full((b, s - 10, kv, d), 100.0)], 1).astype(
                            np.float32)
    got = _port(q, k, v, np.array([10], np.int32), torch.float32)
    np.testing.assert_allclose(got, 1.0, atol=1e-5)
    want = gqa_decode_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.array([10], jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("d", (16, 120))
def test_gqa_decode_ragged_cache_matches_ref(d):
    """S = 48 (no multiple of the Pallas tile, so against the ref alone)
    and head dims that are no power of two."""
    q, k, v, ln = _inputs(3, 8, 2, d, 48, d)
    got = _port(q, k, v, ln, torch.float32)
    want = jax_ref(*(jnp.asarray(a) for a in (q, k, v, ln)))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=0)


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    q, k, v, ln = _inputs(2, 4, 2, 16, 8, 0)
    args = [torch.from_numpy(a) for a in (q, k, v, ln)]
    before = gqa_decode_cuda.launches
    gqa_decode(*args)
    assert gqa_decode_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        gqa_decode_cuda(*args)
