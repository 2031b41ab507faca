"""Parity of repro_torch's recurrent mixers with repro's ``seqmix``: mLSTM
(chunkwise), sLSTM (serial) and RG-LRU (log-depth scan against JAX's
``associative_scan``), each over a prompt and then three decode steps from
the prompt's final state, in f32.

The weights are the JAX ``init_params(PRNGKey(0))`` of xlstm-350m-smoke
and recurrentgemma-2b-smoke (the first block of each kind), converted by
``params_from_jax``; the inputs are numpy-seeded.  S = 12 is one chunk,
S = 512 two of mLSTM's 256-token chunks.

Tolerance: outputs and the state leaves (``c``, ``n``, ``h``, ``conv``)
atol 1e-4 and rtol 1e-4, because the mLSTM input gate reaches e^8 and its
states and outputs grow with it.  At S = 512 the two packages' mLSTM
outputs (up to 14 in magnitude) differ by up to 3.7e-4, and they lie
2.1e-4 (JAX) and 1.7e-4 (the port) from a float64 step-by-step
recurrence: f32 rounding of the chunkwise form, not a fault of either.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import seqmix as JSM  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.models.sharding import CPU_CTX  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import seqmix as SM  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ATOL = 1e-4
RTOL = 1e-4
CPU = torch.device("cpu")
KINDS = {"mlstm": "xlstm-350m-smoke", "slstm": "xlstm-350m-smoke",
         "rglru": "recurrentgemma-2b-smoke"}


@functools.cache
def _params(kind):
    """(JAX cfg, JAX mixer params, the port's cfg, the port's params)."""
    arch = KINDS[kind]
    jcfg = jax_get_config(arch)
    stack = jax.jit(jax_init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))["stack_0"]
    name = [k for k in stack if k.endswith(kind)][0]
    jp = jax.tree.map(lambda a: a[0], stack[name])["mix"]
    return jcfg, jp, get_config(arch), params_from_jax(
        jax.tree.map(np.asarray, jp), CPU)


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _states(got, want, what):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == torch.float32, key
        _close(got[key], want[key], f"{what} state {key}")


@pytest.mark.parametrize("s", (12, 512))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_seq_and_decode_match_jax(kind, s):
    jcfg, jp, cfg, p = _params(kind)
    x = np.random.default_rng(s).standard_normal(
        (2, s + 3, cfg.d_model)).astype(np.float32)
    seq = {"mlstm": (JSM.mlstm_seq, SM.mlstm_seq, JSM.mlstm_decode,
                     SM.mlstm_decode),
           "slstm": (JSM.slstm_seq, SM.slstm_seq, JSM.slstm_decode,
                     SM.slstm_decode),
           "rglru": (JSM.rglru_seq, SM.rglru_seq, JSM.rglru_decode,
                     SM.rglru_decode)}[kind]
    jseq = jax.jit(functools.partial(seq[0], cfg=jcfg, ctx=CPU_CTX,
                                     return_state=True))
    jdec = jax.jit(functools.partial(seq[2], cfg=jcfg))
    jout, jstate = jseq(jp, jnp.asarray(x[:, :s]))
    tout, tstate = seq[1](p, torch.from_numpy(x[:, :s]), cfg)
    _close(tout, jout, f"{kind} S={s} output")
    _states(tstate, jstate, f"{kind} S={s}")
    for t in range(s, s + 3):
        jout, jstate = jdec(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        tout, tstate = seq[3](p, torch.from_numpy(x[:, t:t + 1]), tstate,
                              cfg)
        _close(tout, jout, f"{kind} decode at {t}")
        _states(tstate, jstate, f"{kind} decode at {t}")


def test_mlstm_refuses_a_ragged_chunk_where_jax_asserts():
    """S = 300 is not a multiple of the chunk 256: JAX fails its assert,
    the port raises ValueError (there is no ragged-chunk path)."""
    jcfg, jp, cfg, p = _params("mlstm")
    x = np.zeros((1, 300, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        JSM.mlstm_seq(jp, jnp.asarray(x), jcfg, CPU_CTX)
    with pytest.raises(ValueError, match="chunk"):
        SM.mlstm_seq(p, torch.from_numpy(x), cfg)


def test_caches_are_f32_at_any_compute_dtype():
    """The recurrent caches stay f32 under a bf16 config, as in JAX."""
    for kind, make in (("mlstm", SM.mlstm_cache), ("slstm", SM.slstm_cache),
                       ("rglru", SM.rglru_cache)):
        cfg = get_config(KINDS[kind]).replace(compute_dtype="bfloat16")
        jmake = getattr(JSM, f"{kind}_cache")
        want = jmake(jax_get_config(KINDS[kind]), 3)
        got = make(cfg, 3, CPU)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == torch.float32
            assert tuple(got[key].shape) == want[key].shape


def test_linear_scan_matches_the_serial_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + b_t step by step, at
    lengths that are and are not powers of two."""
    rng = np.random.default_rng(0)
    for s in (1, 2, 5, 64, 100):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, s, 3)).astype(
            np.float32))
        b = torch.from_numpy(rng.standard_normal((2, s, 3)).astype(
            np.float32))
        h = torch.zeros(2, 3)
        want = []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(SM.linear_scan(a, b), torch.stack(want, 1),
                                   atol=1e-5, rtol=1e-5)
