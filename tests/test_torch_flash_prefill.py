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


def _qwen3_smoke():
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = get_config("qwen3-32b-smoke")
    return M, cfg, M.init_params(cfg, device="cpu")


def test_prefill_takes_given_positions():
    """Given positions of the prompt's shape (B, S) go to the positions
    mask, shifted ones included; (B, S) arange(S) gives the default
    prefill's logits exactly."""
    M, cfg, params = _qwen3_smoke()
    tok = torch.zeros((1, 8), dtype=torch.int32)
    _, want = M.prefill(params, {"tokens": tok},
                        M.init_cache(cfg, 1, 8, device="cpu"), cfg)
    cache = M.init_cache(cfg, 1, 8, device="cpu")
    _, got = M.prefill(params, {"tokens": tok,
                                "positions": torch.arange(8)[None]},
                       cache, cfg)
    assert torch.equal(got, want)
    _, shifted = M.prefill(params, {"tokens": tok,
                                    "positions": torch.arange(8)[None] + 1},
                           cache, cfg)
    assert bool(torch.isfinite(shifted).all())


def test_prefill_rejects_other_positions():
    """Positions of any shape but the prompt's (B, S) raise ValueError."""
    M, cfg, params = _qwen3_smoke()
    tok = torch.zeros((1, 8), dtype=torch.int32)
    cache = M.init_cache(cfg, 1, 8, device="cpu")
    for bad in (torch.arange(8), torch.arange(7)[None],
                torch.arange(8)[None, None].expand(3, 1, 8)):
        with pytest.raises(ValueError, match="positions of shape"):
            M.prefill(params, {"tokens": tok, "positions": bad}, cache, cfg)


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


# ---------------------------------------------------------------------------
# the positions operand: the plain version against attention_dense (f32)
# ---------------------------------------------------------------------------

def _temporal(b, text0, image, text1):
    """M-RoPE's temporal row of ``text0`` text tokens, an image of
    ``image`` patches sharing one position, then ``text1`` text tokens
    from past the image's greatest position (its grid side)."""
    side = int(round(image ** 0.5))
    row = np.concatenate([np.arange(text0), np.full(image, text0),
                          text0 + side + np.arange(text1)])
    return np.broadcast_to(row, (b, row.size)).astype(np.int32)


def _positions_case(case, b, sq, sk, rng):
    if case == "mrope_image":
        qp = _temporal(b, 12, 16, sq - 28)
        return qp, qp
    if case == "random":
        return (rng.integers(0, 20, (b, sq)).astype(np.int32),
                rng.integers(0, 20, (b, sk)).astype(np.int32))
    return np.zeros((b, sq), np.int32), np.zeros((b, sk), np.int32)


@pytest.mark.parametrize("case,sq,sk,g,window", [
    ("mrope_image", 64, 64, 1, 0),     # repeated temporal positions
    ("mrope_image", 64, 64, 6, 0),
    ("mrope_image", 64, 64, 6, 9),     # a window over repeated positions
    ("random", 40, 56, 1, 4),          # rows with no live key, Sq != Sk
    ("random", 40, 56, 6, 0),
    ("zeros", 24, 40, 1, 0),           # cross-attention: every pair live
    ("zeros", 24, 40, 6, 0)])
def test_flash_prefill_positions_match_attention_dense(case, sq, sk, g,
                                                       window):
    """flash_prefill's positions operand (the plain version, which the CPU
    op takes) == the JAX model's attention_dense at the same positions,
    f32 within 2e-5; all-zero positions == attention_dense's
    causal=False."""
    b, kv, d = 2, 2, 16
    rng = np.random.default_rng(sq + sk + g + window)
    q = rng.standard_normal((b, sq, kv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    qp, kp = _positions_case(case, b, sq, sk, rng)
    got = flash_prefill(*(torch.from_numpy(a) for a in (q, k, v)),
                        window=window, q_pos=torch.from_numpy(qp),
                        k_pos=torch.from_numpy(kp))
    want = attention_dense(CPU_CTX, *(jnp.asarray(a) for a in (q, k, v)),
                           jnp.asarray(qp), jnp.asarray(kp), window or None,
                           q_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    if case == "zeros":
        dense = attention_dense(CPU_CTX, *(jnp.asarray(a) for a in (q, k, v)),
                                jnp.asarray(qp), jnp.asarray(kp), None,
                                causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(dense), atol=2e-5,
                                   rtol=0)


def test_prefill_attention_positions_pad_narrow_values():
    """attention_prefill with positions and values narrower than the
    queries (MLA) == attention_dense, f32."""
    b, s, h, d, dv = 2, 32, 4, 24, 16
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    pos = _temporal(b, 4, 16, 12)
    want = attention_dense(CPU_CTX, *(jnp.asarray(a) for a in (q, k, v)),
                           jnp.asarray(pos), jnp.asarray(pos), None)
    tp = torch.from_numpy(pos)
    got = attention_prefill(*(torch.from_numpy(a) for a in (q, k, v)), None,
                            tp, tp)
    assert got.shape == (b, s, h, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_positions_come_in_pairs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 1, 8, 0))
    pos = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="both q_pos and k_pos"):
        flash_prefill(q, k, v, q_pos=pos)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_prefill_cuda(q, k, v, q_pos=pos, k_pos=pos)
