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
from repro_torch.kernels.gqa_decode.kernel import (  # noqa: E402
    CHUNK_TILE, MAX_CHUNKS, gqa_decode_cuda, split_plan)
from repro_torch.kernels.gqa_decode.ops import gqa_decode  # noqa: E402
from repro_torch.kernels.gqa_decode.ref import gqa_decode_ref  # noqa: E402

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


# -- edges that the card's kernel is held to (tests/test_torch_cuda.py) -----

def _edge_lengths(s):
    """One row per edge: no live slot, one, all but one, all, past S."""
    return np.array([0, 1, s - 1, s, s + 5], np.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("s", (64, 65))
@pytest.mark.parametrize("g", (1, 8))
@pytest.mark.parametrize("d", (8, 120, 256))
def test_gqa_decode_edges_match_jax(d, g, s, dtype):
    """The plain version against the JAX package at lengths 0, 1, S - 1, S
    and S + 5: against gqa_decode_pallas (interpret mode) where S is a
    multiple of its tile, else against its gqa_decode_ref alone."""
    jdt, tdt, atol = DTYPES[dtype]
    kv = 2
    q, k, v, _ = _inputs(5, kv * g, kv, d, s, d + g + s)
    ln = _edge_lengths(s)
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(ln)]
    got = _port(q, k, v, ln, tdt)
    assert np.isfinite(got).all()
    wants = [jax_ref(*jargs)]
    if s % min(256, s) == 0:
        wants.append(gqa_decode_pallas(*jargs, st=min(256, s)))
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=atol, rtol=0)
    # length 0 attends uniformly over all S slots, as in the reference
    vf = torch.from_numpy(v).to(tdt).float()
    np.testing.assert_allclose(
        got[0], vf[0].mean(0).repeat_interleave(g, 0).numpy(),
        atol=atol, rtol=0)


# -- the kernel's split plan -------------------------------------------------

SMS = 132          # an H100 SXM's SM count


@pytest.mark.parametrize("b", (1, 8))
@pytest.mark.parametrize("kv", (1, 8))
@pytest.mark.parametrize("s", (1, 7, 63, 64, 65, 300, 544, 4096))
def test_split_plan_tiles_the_cache_once(s, kv, b):
    """Chunks of whole tiles, at most one cluster of them, cover [0, S)
    once: each slot in exactly one chunk and no chunk past S."""
    chunk_len, chunks = split_plan(b, kv, s, SMS)
    assert chunk_len % CHUNK_TILE == 0 and chunk_len > 0
    assert 1 <= chunks <= MAX_CHUNKS
    owner = np.full(s, -1)
    for c in range(chunks):
        lo, hi = c * chunk_len, min((c + 1) * chunk_len, s)
        assert lo < hi, f"chunk {c} is empty"
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = c
    assert (owner >= 0).all()
    # aim: two blocks per SM, unless the tiles or the cluster size run out
    # first; chunks of equal whole tiles, the shortest that meet the aim
    tiles = -(-s // CHUNK_TILE)
    aim = min(MAX_CHUNKS, tiles, -(-2 * SMS // (b * kv)))
    per = chunk_len // CHUNK_TILE
    assert chunks <= aim and (per - 1) * aim < tiles


def test_split_plan_fills_the_card_at_the_serving_shape():
    """qwen3-32b's decode (B 8, KV 8, S 544): at least two blocks per SM."""
    chunk_len, chunks = split_plan(8, 8, 544, SMS)
    assert 8 * 8 * chunks >= 2 * SMS
    assert (chunk_len, chunks) == (128, 5)


def _merged_chunks(q, k, v, length, chunk_len, chunks):
    """The kernel's arithmetic in float64: each chunk's partial (m, l, acc)
    over the live slots it holds (masked logits -1e30, running max from
    -1e30, empty chunks (m -1e30, l 0)), merged as m* = max m_i, l = sum
    l_i e^(m_i - m*), acc = sum acc_i e^(m_i - m*); out = acc / max(l,
    1e-30)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qf = q.double().reshape(b, kv, g, d)
    logits = torch.einsum("bngd,bsnd->bngs", qf, k.double()) / d ** 0.5
    out = torch.empty(b, kv, g, d, dtype=torch.float64)
    for r in range(b):
        ln = int(length[r])
        end = s if ln <= 0 else min(ln, s)
        parts = []
        for c in range(chunks):
            lo, hi = c * chunk_len, min((c + 1) * chunk_len, end)
            m = torch.full((kv, g), -1e30, dtype=torch.float64)
            if lo >= hi:
                parts.append((m, torch.zeros(kv, g),
                              torch.zeros(kv, g, d, dtype=torch.float64)))
                continue
            x = logits[r, :, :, lo:hi] if ln > 0 else torch.full(
                (kv, g, hi - lo), -1e30, dtype=torch.float64)
            m = torch.maximum(m, x.max(-1).values)
            p = torch.exp(x - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum(
                "ngs,snd->ngd", p, v[r, lo:hi].double())))
        mx = torch.stack([m for m, _, _ in parts]).max(0).values
        lsum = sum(l_ * torch.exp(m - mx) for m, l_, _ in parts)
        acc = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
        out[r] = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(b, h, d)


@pytest.mark.parametrize("b,kv,s", [(5, 2, 1), (5, 2, 65), (5, 2, 300),
                                    (5, 1, 1000), (8, 8, 544)])
def test_split_plan_chunks_merge_to_the_plain_version(b, kv, s):
    """The plan's chunks, each reduced to a partial and merged by the
    kernel's rule, give the plain version's output, at lengths that leave
    chunks empty and at length 0 (every chunk all masked)."""
    q, k, v, _ = _inputs(b, 2 * kv, kv, 16, s, s)
    rng = np.random.default_rng(s)
    ln = np.concatenate([_edge_lengths(s), rng.integers(1, s + 1, b - 5)])
    args = [torch.from_numpy(a) for a in (q, k, v, ln.astype(np.int32))]
    got = _merged_chunks(*args, *split_plan(b, kv, s, SMS))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), gqa_decode_ref(*args),
                               atol=2e-5, rtol=0)
