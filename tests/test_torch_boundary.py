"""The port's package boundary: no JAX, no repro, the GPU by default."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import DurableMap, SetSpec  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.kernels.hash_probe.kernel import probe_cuda  # noqa: E402
from repro_torch.kernels.hash_probe.ref import probe_ref  # noqa: E402
from repro_torch.kernels.recovery_scan.kernel import scan_cuda  # noqa: E402
from repro_torch.kernels.recovery_scan.ref import scan_ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_engine_imports_with_jax_and_repro_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch.core.engine\n"
            "import repro_torch.core, repro_torch.obs\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = SetSpec(capacity=16, backend="bucket")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DurableMap(spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TE.make_state(spec)
    DurableMap(spec, device="cpu")              # asked for: fine


def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    rng = np.random.default_rng(0)
    stages = torch.from_numpy(rng.integers(0, 5, 100).astype(np.int32))
    bkeys = torch.from_numpy(rng.integers(0, 9, (8, 4)).astype(np.int32))
    bids = torch.from_numpy(rng.integers(-1, 30, (8, 4)).astype(np.int32))
    qb = torch.from_numpy(rng.integers(0, 8, 16).astype(np.int32))
    qk = torch.from_numpy(rng.integers(0, 9, 16).astype(np.int32))
    scan_cuda.launches = probe_cuda.launches = 0
    for got, want in zip(scan_cuda(stages), scan_ref(stages)):
        assert torch.equal(got, want)
    assert torch.equal(probe_cuda(bkeys, bids, qb, qk),
                       probe_ref(bkeys, bids, qb, qk))
    m = DurableMap(SetSpec(capacity=16, backend="bucket"), device="cpu")
    m.insert([1, 2, 3])
    m.crash_and_recover()
    assert m.contains([1, 4]).tolist() == [True, False]
    assert scan_cuda.launches == 0 and probe_cuda.launches == 0


def test_wrappers_refuse_mixed_devices():
    t = torch.zeros((4, 4), dtype=torch.int32)
    q = torch.zeros((4,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        probe_cuda(t, t, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        scan_cuda(q)
