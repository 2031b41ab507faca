"""Plain PyTorch version of the bucketized hash-probe lookup."""
import torch


def probe_ref(bucket_keys: torch.Tensor, bucket_ids: torch.Tensor,
              q_bucket: torch.Tensor, q_keys: torch.Tensor) -> torch.Tensor:
    """Direct-gather reference.

    bucket_keys i32[NB, W], bucket_ids i32[NB, W] (-1 == empty way),
    q_bucket i32[B] (bucket index per query), q_keys i32[B].
    Returns node id per query or -1.
    """
    rows_k = bucket_keys[q_bucket]          # (B, W)
    rows_i = bucket_ids[q_bucket]           # (B, W)
    match = (rows_i >= 0) & (rows_k == q_keys[:, None])
    found = torch.where(match, rows_i, torch.full_like(rows_i, -1))
    return found.amax(dim=1)
