"""Parity of repro_torch's recovery scan with repro's Pallas kernel.

The JAX side runs ``scan_pallas`` in interpret mode, as tests/test_kernels.py
runs it; the port's wrapper runs its plain version on CPU tensors."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels.recovery_scan.kernel import scan_pallas  # noqa: E402
from repro.kernels.recovery_scan.ref import scan_ref as j_scan_ref  # noqa
from repro_torch.kernels.recovery_scan import ops  # noqa: E402
from repro_torch.kernels.recovery_scan.kernel import scan_cuda  # noqa: E402
from repro_torch.kernels.recovery_scan.ref import scan_ref  # noqa: E402


@pytest.mark.parametrize("n,nt", [(1024, 128), (8192, 1024), (65536, 8192)])
def test_scan_matches_scan_pallas(n, nt):
    rng = np.random.default_rng(n)
    stages = rng.integers(0, 5, n).astype(np.int32)
    m_j, h_j = scan_pallas(jnp.asarray(stages), nt=nt)
    t = torch.from_numpy(stages)
    for use_kernels in (True, False):
        m, h = ops.recovery_scan(t, use_kernels=use_kernels)
        assert m.dtype == torch.bool and h.dtype == torch.int32
        np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
        np.testing.assert_array_equal(h.numpy(), np.asarray(h_j))


@pytest.mark.parametrize("n", (1, 7, 1003))
def test_scan_ragged_n_matches_reference(n):
    """Any N: the JAX wrapper falls back to its reference off the N % 8
    tiling; the port takes every N through the same path."""
    rng = np.random.default_rng(n)
    stages = rng.integers(0, 5, n).astype(np.int32)
    m_j, h_j = j_scan_ref(jnp.asarray(stages))
    m, h = ops.recovery_scan(torch.from_numpy(stages))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_j))


def test_scan_wrapper_on_cpu_runs_plain_and_counts_nothing():
    stages = torch.tensor([0, 3, 3, 4, 1, 2, 3], dtype=torch.int32)
    before = scan_cuda.launches
    m, h = scan_cuda(stages)
    assert scan_cuda.launches == before
    m_p, h_p = scan_ref(stages)
    assert torch.equal(m, m_p) and torch.equal(h, h_p)
    assert h.tolist() == [1, 1, 1, 3, 1]
