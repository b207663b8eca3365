"""Plain PyTorch versions of the aggregation ops: the numerics oracles.

Port of ``dragonfly2_tpu/ops/aggregate.py``.  These are the semantics
the segment-sum kernel (``ops/segment.py``, K3) must match; the tests
hold the kernel's plain version and the JAX package's ops to them.
"""

from __future__ import annotations

import torch


def masked_mean_aggregate(
    h: torch.Tensor, indices: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Padded-table neighbor mean: [N, D], [N, K], [N, K] → [N, D]."""
    nbr = h[indices.long()]                             # [N, K, D]
    m = mask[..., None].to(h.dtype)                     # [N, K, 1]
    denom = torch.clamp(m.sum(dim=1), min=1.0)
    return (nbr * m).sum(dim=1) / denom


def segment_sum(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Edge→node scatter-add: [E, D], [E] → [num_segments, D]."""
    out = torch.zeros(
        (num_segments,) + tuple(values.shape[1:]), dtype=values.dtype,
        device=values.device,
    )
    return out.index_add_(0, segment_ids.long(), values)


def segment_mean(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    total = segment_sum(values, segment_ids, num_segments)
    counts = segment_sum(
        torch.ones((values.shape[0],), dtype=values.dtype, device=values.device),
        segment_ids, num_segments,
    )
    return total / torch.clamp(counts[:, None], min=1.0)
