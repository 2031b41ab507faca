"""The CUDA kernels on the card against their plain versions.

These need an NVIDIA GPU and nvcc; elsewhere they skip.  They import no
JAX, so they run where only the port is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DurableMap, SetSpec  # noqa: E402
from repro_torch.kernels.hash_probe.kernel import probe_cuda  # noqa: E402
from repro_torch.kernels.hash_probe.ops import (bucket_of,  # noqa: E402
                                                build_buckets)
from repro_torch.kernels.hash_probe.ref import probe_ref  # noqa: E402
from repro_torch.kernels.recovery_scan.kernel import scan_cuda  # noqa: E402
from repro_torch.kernels.recovery_scan.ref import scan_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", (1, 3, 4, 1000, 4096 + 3, 1 << 20))
@pytest.mark.parametrize("offset", (0, 1))
def test_scan_kernel_matches_plain(cuda, n, offset):
    """Any N, aligned or not (a view one element in takes the scalar
    path)."""
    rng = np.random.default_rng(n)
    base = torch.from_numpy(rng.integers(0, 5, n + offset).astype(np.int32))
    stages = base.to(cuda)[offset:]
    before = scan_cuda.launches
    mask, hist = scan_cuda(stages)
    assert scan_cuda.launches == before + 1
    mask_p, hist_p = scan_ref(stages)
    torch.cuda.synchronize()
    assert torch.equal(mask, mask_p) and torch.equal(hist, hist_p)


@pytest.mark.parametrize("nb,w,b", [(64, 8, 8), (256, 8, 128),
                                    (512, 16, 256), (1024, 8, 64),
                                    (128, 3, 100), (1 << 16, 8, 4096)])
def test_probe_kernel_matches_plain(cuda, nb, w, b):
    rng = np.random.default_rng(nb + b)
    n = nb * w // 2
    keys = torch.from_numpy(
        rng.choice(10 ** 7, n, replace=False).astype(np.int32)).to(cuda)
    cur = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)).to(cuda)
    bk, bi, _ = build_buckets(keys, cur, nb=nb, w=w)
    q = torch.cat([keys[: b // 2], torch.from_numpy(
        rng.integers(2 * 10 ** 7, 3 * 10 ** 7, b - b // 2).astype(
            np.int32)).to(cuda)])
    qb = bucket_of(q, nb)
    before = probe_cuda.launches
    got = probe_cuda(bk, bi, qb, q)
    assert probe_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, probe_ref(bk, bi, qb, q))


def test_map_on_the_card_uses_both_kernels(cuda):
    scan_cuda.launches = probe_cuda.launches = 0
    m = DurableMap(SetSpec(capacity=1 << 12, backend="bucket"), device=cuda)
    keys = np.arange(0, 2000, 3, dtype=np.int32)
    assert m.insert(keys).all()
    m.crash_and_recover()
    got = m.contains(np.arange(2000, dtype=np.int32)).cpu().numpy()
    np.testing.assert_array_equal(np.flatnonzero(got), keys)
    assert scan_cuda.launches == 1 and probe_cuda.launches == 2
