"""Scatter-free neighbor gather: the VJP is a gather over the transpose graph.

Port of ``dragonfly2_tpu/ops/transpose_gather.py``.  The backward of
``h[idx]`` ([N, D] table, [N, K] indices) is a scatter-add of the
[N, K, D] cotangent into the table.  But the scatter IS a gather over
the *transpose* graph: for each node ``m``,

    grad_h[m] = sum over { flat edge positions e : idx.flat[e] == m } ct.flat[e]

and that edge set is static (the graph changes far slower than the
weights).  So a host-side transpose table lists each node's out-edge
positions padded to ``K_out`` slots, and the backward becomes one
[N, K_out, D] gather + masked sum.  Over-degree nodes beyond ``K_out``
spill to a small COO tail added with one ``index_add`` so the gradient
stays exact.

Padding slots of the *forward* table (mask 0) are excluded from the
transpose table: their cotangents are identically zero (the models'
masks cut the gradient upstream), so dropping them is exact — and it
keeps node 0 (the conventional pad target) from collecting every pad
slot as a fake out-edge.

In the JAX package this is an XLA custom VJP, not a Pallas kernel; here
it is a ``torch.autograd.Function`` of plain PyTorch operations.  It
plugs into ``GNNConfig(gather_fn=...)`` beside ``ops.segment``'s
``make_neighbor_gather`` (K3 backward).  No model selects it and the
``ops`` package does not export it: on the card it lost to the index
gather at GraphSAGE's shapes (PERF.md), and it stays as the reference's
op that the parity tests and ``chip_smoke.py``'s gather comparison hold.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _build


class TransposeTable(NamedTuple):
    """Static transpose adjacency: for each node, its out-edge positions.

    tidx  [N, K_out] int32 — flat positions into the [N*K] edge stream
    tmask [N, K_out] f32   — 1.0 real, 0.0 padding
    over_pos [M] int32     — spilled flat positions (over-degree tail)
    over_dst [M] int32     — node each spilled position belongs to
    """

    tidx: torch.Tensor
    tmask: torch.Tensor
    over_pos: torch.Tensor
    over_dst: torch.Tensor


def build_transpose_table(
    indices: np.ndarray,
    mask: np.ndarray,
    num_nodes: Optional[int] = None,
    *,
    cap: Optional[int] = None,
    spill_percentile: float = 99.5,
) -> TransposeTable:
    """Host prep, vectorized (no Python loop over nodes); CPU tensors.

    ``cap`` fixes K_out; by default it is the ``spill_percentile`` of the
    out-degree distribution rounded up to a multiple of 8, so the dense
    gather covers ~everything and the COO tail stays tiny.
    """
    indices = np.asarray(indices)
    mask = np.asarray(mask)
    n = num_nodes or indices.shape[0]
    flat_src = indices.reshape(-1).astype(np.int64)
    real = mask.reshape(-1) > 0
    pos = np.nonzero(real)[0]
    srcs = flat_src[real]

    order = np.argsort(srcs, kind="stable")
    pos_s, srcs_s = pos[order], srcs[order]
    counts = np.bincount(srcs_s, minlength=n)
    if cap is None:
        k_out = int(np.percentile(counts, spill_percentile)) if len(counts) else 1
        k_out = max(8, ((max(k_out, 1) + 7) // 8) * 8)
    else:
        k_out = cap
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(len(srcs_s), dtype=np.int64) - starts[srcs_s]

    keep = rank < k_out
    tidx = np.zeros((n, k_out), dtype=np.int64)
    tmask = np.zeros((n, k_out), dtype=np.float32)
    tidx[srcs_s[keep], rank[keep]] = pos_s[keep]
    tmask[srcs_s[keep], rank[keep]] = 1.0
    return TransposeTable(
        tidx=torch.from_numpy(tidx.astype(np.int32)),
        tmask=torch.from_numpy(tmask),
        over_pos=torch.from_numpy(pos_s[~keep].astype(np.int32)),
        over_dst=torch.from_numpy(srcs_s[~keep].astype(np.int32)),
    )


class _TransposeGatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table: torch.Tensor, gather: "TransposeGather") -> torch.Tensor:
        ctx.gather = gather
        ctx.dtype = table.dtype
        n, k = gather.shape
        return table.index_select(0, gather.flat_indices).reshape(n, k, table.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        gather = ctx.gather
        n_out, k_out = gather.tidx.shape
        flat = g.reshape(-1, g.shape[-1])                                  # [N*K, D]
        rows = flat.index_select(0, gather.tidx.reshape(-1)).reshape(n_out, k_out, -1)
        grad = (rows * gather.tmask[..., None].to(rows.dtype)).sum(dim=1)  # [N, D]
        if gather.has_spill:
            extra = flat.index_select(0, gather.over_pos)                  # [M, D]
            grad = grad.index_add(0, gather.over_dst, extra)
        return grad.to(ctx.dtype), None


class TransposeGather:
    """gather(table [N, D]) → [N, K, D] over a fixed [N, K] neighbor table,
    whose backward is a gather over the transpose table plus the spilled
    tail; the arrays live on ``device``."""

    def __init__(
        self,
        indices: np.ndarray,
        mask: np.ndarray,
        num_nodes: Optional[int] = None,
        *,
        cap: Optional[int] = None,
        device="cuda",
    ) -> None:
        dev = _build.resolve_device(device)
        indices = np.asarray(indices)
        if indices.ndim != 2:
            raise ValueError(f"indices must be [N, K], got {indices.shape}")
        self.shape = tuple(indices.shape)
        self.num_nodes = int(num_nodes or indices.shape[0])
        flat = indices.reshape(-1).astype(np.int64)
        if flat.size and (flat.min() < 0 or flat.max() >= self.num_nodes):
            raise ValueError(f"neighbor ids outside [0, {self.num_nodes})")
        tt = build_transpose_table(indices, mask, self.num_nodes, cap=cap)
        self.flat_indices = torch.from_numpy(flat).to(dev)
        self.tidx = tt.tidx.long().to(dev)
        self.tmask = tt.tmask.to(dev)
        self.over_pos = tt.over_pos.long().to(dev)
        self.over_dst = tt.over_dst.long().to(dev)
        self.has_spill = int(tt.over_pos.shape[0]) > 0

    @property
    def device(self) -> torch.device:
        return self.flat_indices.device

    def __call__(self, table: torch.Tensor) -> torch.Tensor:
        if table.dim() != 2 or table.shape[0] != self.num_nodes:
            raise ValueError(
                f"gather table must be [{self.num_nodes}, D], got {tuple(table.shape)}"
            )
        if table.device != self.device:
            raise ValueError(
                f"table on {table.device}, transpose gather built for {self.device}"
            )
        return _TransposeGatherFn.apply(table, self)


def make_transpose_gather(
    indices: np.ndarray,
    mask: np.ndarray,
    num_nodes: Optional[int] = None,
    *,
    cap: Optional[int] = None,
    device="cuda",
) -> TransposeGather:
    """→ ``gather(table [N, D]) → [N, K, D]`` with a scatter-free backward.

    Build once per graph snapshot from the HOST-side neighbor table (the
    same [N, K] ``indices``/``mask`` as the NeighborTable handed to the
    model; numpy or CPU tensors); the callable keeps the transpose arrays
    on ``device`` and plugs into ``GNNConfig(gather_fn=...)``.
    """
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return TransposeGather(indices, mask, num_nodes, cap=cap, device=device)
