"""Plain PyTorch version of the recovery validity scan."""
import torch

N_STAGES = 5


def scan_ref(persisted: torch.Tensor):
    """persisted i32[N] -> (member_mask bool[N], stage_histogram i32[5]).

    member == persisted stage VALID(3): the recovery classification rule of
    Sections 3.5 / 4.6 (valid & unmarked / validStart==validEnd!=deleted)."""
    member = persisted == 3
    hist = torch.zeros((N_STAGES,), dtype=torch.int32,
                       device=persisted.device).scatter_add_(
        0, persisted.clamp(0, 4).to(torch.int64),
        torch.ones_like(persisted))
    return member, hist
