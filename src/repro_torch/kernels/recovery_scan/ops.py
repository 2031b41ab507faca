"""Recovery classification: the CUDA kernel or its plain version."""
from __future__ import annotations

from repro_torch.kernels.recovery_scan.kernel import scan_cuda
from repro_torch.kernels.recovery_scan.ref import scan_ref


def recovery_scan(persisted, *, use_kernels=True):
    """(member mask, stage histogram) of the persisted stages.

    ``scan_cuda`` launches the kernel on a CUDA tensor and runs the plain
    version on a CPU tensor.  The TPU wrapper's tiling gate (N % 8, tiles of
    65536 down to 8) does not apply: the CUDA kernel masks its own tail and
    takes any N."""
    if use_kernels:
        return scan_cuda(persisted)
    return scan_ref(persisted)
