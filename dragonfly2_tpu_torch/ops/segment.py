"""Segment sum by destination on the card (K3), and the neighbor gather
whose backward it is.

Port of ``dragonfly2_tpu/ops/pallas_segment.py``.  The host prep is the
JAX package's: ``bucket_edges_by_block`` sorts the edge stream by
destination node block and pads each block's run.  Within a run the
edges are sorted by destination, so each segment's edges are one
contiguous range of the bucketed stream; ``kernel_chunks`` lists the
stream's real edges in that order and cuts them into chunks of whole
segments, one warp's work in the CUDA kernel (``csrc/segment_sum.cu``),
splitting any segment longer than ``max_run`` edges into runs whose
partial sums a second pass adds up.  The GAT's neighbor table sends
every padded slot to node 0 (``build_neighbor_table`` writes index 0
there), so node 0's segment is ~10 % of all edges at the trainer's
shape; split, it does not serialize the kernel.

- ``segment_sum`` — the counterpart of ``segment_sum_pallas``: values
  [E, D] by host-side ``segment_ids`` → [num_segments, D] f32.
- ``make_neighbor_gather`` — gather(table [N, D]) → [N, K, D], a plain
  index gather forward and K3 (``exact=False``) backward, with the
  bucket arrays built once and kept on the device.

CUDA tensors launch K3 or raise; CPU tensors take ``_segment_sum_plain``
over the same bucketed layout.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import _build

# Launches per kernel: the wrapper adds one where it launches its kernel,
# and nowhere else.
LAUNCHES: Dict[str, int] = {"segment_sum": 0}
_launch_mu = threading.Lock()

# Most edges one warp of the kernel walks as one chunk of whole segments.
CHUNK_EDGES = 256
# A segment longer than this is cut into runs of MAX_RUN edges whose
# partial rows a second pass adds.
MAX_RUN = 256
# Most segments one chunk writes: bounds a warp's work on empty segments.
CHUNK_SEGMENTS = 256
# The combine pass's 32-column tile and the grid's y limit bound the row
# width.
_MAX_D = 65535 * 32


def reset_launch_counts() -> None:
    with _launch_mu:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def bucket_edges_by_block(
    segment_ids: np.ndarray,
    num_segments: int,
    *,
    node_block: int = 128,
    edge_block: int = 128,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host prep: bucket the edge stream by destination node block.

    Returns (perm, dst_local, weight, block_node, is_first):
    - perm      [E_pad] — edge index into the original stream (0 for pads)
    - dst_local [E_pad] — destination offset within its node block
    - weight    [E_pad] — 1.0 real edge / 0.0 padding
    - block_node[n_edge_blocks] — node-block index each edge block writes
    - is_first  [n_edge_blocks] — 1 on the first edge block of a node block
    """
    segment_ids = np.asarray(segment_ids)
    order = np.argsort(segment_ids, kind="stable")
    n_node_blocks = (num_segments + node_block - 1) // node_block
    sorted_ids = segment_ids[order]
    # Edge run boundaries per node block.
    bounds = np.searchsorted(
        sorted_ids, np.arange(n_node_blocks + 1) * node_block
    )
    perm_parts, dstl_parts, w_parts = [], [], []
    block_node, is_first = [], []
    for j in range(n_node_blocks):
        lo, hi = bounds[j], bounds[j + 1]
        run = order[lo:hi]
        n = len(run)
        # A node block with no edges still needs one all-padding block so
        # its (is_first) visit zero-initializes the output tile.
        n_pad = max(((n + edge_block - 1) // edge_block) * edge_block, edge_block)
        pad = n_pad - n
        perm_parts.append(np.concatenate([run, np.zeros(pad, dtype=run.dtype)]))
        dstl = segment_ids[run] - j * node_block
        dstl_parts.append(
            np.concatenate([dstl, np.zeros(pad, dtype=dstl.dtype)])
        )
        w_parts.append(
            np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        )
        n_blocks_j = n_pad // edge_block
        block_node.extend([j] * n_blocks_j)
        is_first.extend([1] + [0] * (n_blocks_j - 1))
    return (
        np.concatenate(perm_parts).astype(np.int32),
        np.concatenate(dstl_parts).astype(np.int32),
        np.concatenate(w_parts),
        np.asarray(block_node, np.int32),
        np.asarray(is_first, np.int32),
    )


def kernel_chunks(
    dstl: np.ndarray,
    w: np.ndarray,
    block_node: np.ndarray,
    num_segments: int,
    *,
    node_block: int,
    edge_block: int,
    max_run: int = MAX_RUN,
) -> Dict[str, np.ndarray]:
    """The kernel's walk and chunks over a bucketed stream (int32 arrays).

    The walk is the stream's real edges (weight 1) in bucketed order:
    ``edge_pos`` their bucketed positions and ``edge_seg`` their
    segments, non-decreasing.  The bucketing's pads (weight 0) add
    nothing and are left out, so the kernel needs no weights.

    A chunk is one warp's work: the walk's range ``chunk_lo`` ..
    ``chunk_hi`` and the consecutive segments ``chunk_seg_lo`` ..
    ``chunk_seg_hi`` it writes, empty ones included — at most
    ``CHUNK_EDGES`` edges and ``CHUNK_SEGMENTS`` segments, whole
    segments only.  A segment of more than ``max_run`` edges is cut into
    runs of ``max_run``, one chunk each, whose ``chunk_slot`` is the
    partial row it writes (-1 for every other chunk); ``long_seg`` lists
    those segments and ``long_first`` [n_long + 1] their partial-row
    ranges.  Every segment lies in exactly one chunk or in its runs."""
    if num_segments < 1:
        raise ValueError(f"num_segments must be >= 1, got {num_segments}")
    if max_run > CHUNK_EDGES:
        raise ValueError("a run of a long segment must fit in one chunk")
    if not np.all((w == 0) | (w == 1)):
        raise ValueError("the bucketed stream's weights must be its 0/1 padding mask")
    real = np.nonzero(w > 0)[0]
    seg = block_node[real // edge_block].astype(np.int64) * node_block + dstl[real]
    inside = seg < num_segments      # the tail of the last node block
    real, seg = real[inside], seg[inside]
    # bucket_edges_by_block sorts each node block's run by destination:
    # one segment's edges are consecutive in the walk.
    if np.any(np.diff(seg) < 0):
        raise ValueError("bucketed stream is not sorted by destination within its runs")
    counts = np.bincount(seg, minlength=num_segments)
    off = np.concatenate([[0], np.cumsum(counts)])    # segment s: off[s] .. off[s + 1]
    long = counts > max_run
    # The first long segment at or after s (num_segments: none).
    next_long = np.minimum.accumulate(
        np.where(long, np.arange(num_segments), num_segments)[::-1]
    )[::-1]
    lo, hi, seg_lo, seg_hi, slot = [], [], [], [], []
    long_seg, long_first = [], [0]
    s = 0
    while s < num_segments:
        if long[s]:
            starts = np.arange(off[s], off[s + 1], max_run)
            lo.extend(starts)
            hi.extend(np.minimum(starts + max_run, off[s + 1]))
            seg_lo.extend([s] * len(starts))
            seg_hi.extend([s + 1] * len(starts))
            slot.extend(range(long_first[-1], long_first[-1] + len(starts)))
            long_seg.append(s)
            long_first.append(long_first[-1] + len(starts))
            s += 1
            continue
        # The most whole segments from s whose edges fit in the chunk.
        t = int(np.searchsorted(off, off[s] + CHUNK_EDGES, side="right")) - 1
        t = max(min(t, s + CHUNK_SEGMENTS, int(next_long[s])), s + 1)
        lo.append(off[s])
        hi.append(off[t])
        seg_lo.append(s)
        seg_hi.append(t)
        slot.append(-1)
        s = t
    out = {
        "edge_pos": real, "edge_seg": seg, "chunk_lo": lo, "chunk_hi": hi,
        "chunk_seg_lo": seg_lo, "chunk_seg_hi": seg_hi, "chunk_slot": slot,
        "long_seg": long_seg, "long_first": long_first,
    }
    return {k: np.asarray(v, np.int64).astype(np.int32) for k, v in out.items()}


@dataclass
class SegmentPlan:
    """A bucketed stream of ``n_edges`` edges on one device: the JAX
    layout (``perm``, ``dstl``, ``w``, ``block_node``) for the plain
    version and the kernel's walk and chunks (``kernel_chunks``, plus
    ``edge_row`` = ``perm[edge_pos]``, each walked edge's row in the
    original edge order)."""

    n_edges: int
    num_segments: int
    node_block: int
    edge_block: int
    perm: torch.Tensor
    dstl: torch.Tensor
    w: torch.Tensor
    block_node: torch.Tensor
    chunks: Dict[str, torch.Tensor]
    n_partials: int

    @property
    def device(self) -> torch.device:
        return self.perm.device

    @property
    def e_pad(self) -> int:
        return int(self.perm.shape[0])


def build_plan(
    segment_ids: np.ndarray,
    num_segments: int,
    *,
    node_block: int = 256,
    edge_block: int = 512,
    max_run: int = MAX_RUN,
    device="cuda",
) -> SegmentPlan:
    """Bucket ``segment_ids`` (host-side), plan the kernel's chunks and
    put the arrays on ``device``."""
    dev = _build.resolve_device(device)
    segment_ids = np.asarray(segment_ids)
    perm, dstl, w, block_node, _ = bucket_edges_by_block(
        segment_ids, num_segments, node_block=node_block, edge_block=edge_block
    )
    chunks = kernel_chunks(
        dstl, w, block_node, num_segments, node_block=node_block,
        edge_block=edge_block, max_run=max_run,
    )
    chunks["edge_row"] = perm[chunks["edge_pos"]]

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return SegmentPlan(
        n_edges=int(len(segment_ids)), num_segments=int(num_segments),
        node_block=node_block, edge_block=edge_block, perm=put(perm),
        dstl=put(dstl), w=put(w), block_node=put(block_node),
        chunks={k: put(v) for k, v in chunks.items()},
        n_partials=int(chunks["long_first"][-1]),
    )


def _segment_sum_plain(
    values: torch.Tensor, plan: SegmentPlan, *, exact: bool, presorted: bool
) -> torch.Tensor:
    """K3's plain PyTorch version over the same bucketed layout: values
    rounded to bf16 when ``exact`` is False (as the TPU kernel's bf16
    operands), weighted, summed by destination in float64 and rounded
    once to float32 — the f32 sum the kernel approximates, without its
    order."""
    vals = values if presorted else values.index_select(0, plan.perm)
    vals = vals.float() if exact else vals.to(torch.bfloat16).float()
    vals = vals.double() * plan.w.double()[:, None]
    dst = (
        plan.block_node.long().repeat_interleave(plan.edge_block) * plan.node_block
        + plan.dstl.long()
    )
    n_node_blocks = (plan.num_segments + plan.node_block - 1) // plan.node_block
    out = torch.zeros(
        (n_node_blocks * plan.node_block, vals.shape[1]), dtype=torch.float64,
        device=vals.device,
    )
    out.index_add_(0, dst, vals)
    return out[: plan.num_segments].float()


def segment_sum_bucketed(
    values: torch.Tensor,
    plan: SegmentPlan,
    *,
    exact: bool,
    presorted: bool = False,
) -> torch.Tensor:
    """[num_segments, D] f32 segment sums of ``values`` over ``plan``.

    ``values`` is [E, D] in the original edge order (read through
    ``plan.perm``) or, with ``presorted``, [E_pad, D] in the bucketed
    layout.  f32 or bf16, contiguous, on the plan's device.  CUDA tensors
    launch K3 (``csrc/segment_sum.cu``), which replaces
    ``dragonfly2_tpu/ops/pallas_segment.py:98`` ``_segment_kernel``; CPU
    tensors take ``_segment_sum_plain``."""
    if values.dim() != 2:
        raise ValueError(f"values must be [E, D], got {tuple(values.shape)}")
    if values.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"K3 takes float32 or bfloat16 values, got {values.dtype}")
    if values.device != plan.device:
        raise ValueError(f"values on {values.device}, segment plan on {plan.device}")
    if presorted and values.shape[0] != plan.e_pad:
        raise ValueError(
            f"presorted values must be in the bucketed layout "
            f"(len {plan.e_pad}, interior pads included); got "
            f"{values.shape[0]} rows — apply vals[perm] from "
            f"bucket_edges_by_block with the same block sizes"
        )
    if not presorted and values.shape[0] != plan.n_edges:
        # The kernel reads values[perm[e]]: every row perm names must exist.
        raise ValueError(f"{values.shape[0]} value rows, segment plan of {plan.n_edges} edges")
    if values.device.type == "cpu":
        return _segment_sum_plain(values, plan, exact=exact, presorted=presorted)
    if values.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {values.device}")
    if not values.is_contiguous():
        raise ValueError("K3 takes contiguous values")
    d = values.shape[1]
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"K3 takes 1 <= D <= {_MAX_D}, got {d}")
    ch = plan.chunks
    n_long = int(ch["long_seg"].shape[0])
    out = torch.empty((plan.num_segments, d), dtype=torch.float32, device=values.device)
    partial: Optional[torch.Tensor] = None
    if n_long:
        partial = torch.empty((plan.n_partials, d), dtype=torch.float32, device=values.device)
    lib = _build.load()
    code = lib.df_segment_sum(
        values.data_ptr(), int(values.dtype == torch.bfloat16), int(not exact),
        ch["edge_pos" if presorted else "edge_row"].data_ptr(), ch["edge_seg"].data_ptr(),
        *(ch[k].data_ptr() for k in (
            "chunk_lo", "chunk_hi", "chunk_seg_lo", "chunk_seg_hi", "chunk_slot")),
        int(ch["chunk_lo"].shape[0]), ch["long_seg"].data_ptr(),
        ch["long_first"].data_ptr(), n_long,
        None if partial is None else partial.data_ptr(), out.data_ptr(), d,
        _build.stream_handle(values.device),
    )
    _build.check(lib, "segment_sum", code)
    with _launch_mu:
        LAUNCHES["segment_sum"] += 1
    return out


def segment_sum(
    values: torch.Tensor,
    segment_ids: np.ndarray,
    num_segments: int,
    *,
    node_block: int = 256,
    edge_block: int = 512,
    exact: bool = True,
    presorted: bool = False,
) -> torch.Tensor:
    """Segment-sum [E, D] by dst id → [num_segments, D] f32.

    ``segment_ids`` is host-side (numpy): bucketing runs once per call
    (``make_neighbor_gather`` keeps its plan across steps).
    ``exact=False`` rounds the values to bf16 before the f32 sum.
    ``presorted=True`` means values are ALREADY in the BUCKETED layout —
    ``vals[perm]`` for the perm from ``bucket_edges_by_block`` with the
    SAME block sizes, interior per-block padding included.  A merely
    destination-sorted stream is NOT this layout; the length check
    rejects it."""
    segment_ids = np.asarray(segment_ids)
    plan = build_plan(
        segment_ids, num_segments, node_block=node_block,
        edge_block=edge_block, device=values.device,
    )
    if not presorted and values.shape[0] == 0:
        # Zero edges: every bucketed slot is padding (weight 0), but the
        # pad perm indexes row 0, which does not exist.  The kernel still
        # runs, over an all-padding stream, and writes every row zero.
        values = torch.zeros(
            (plan.e_pad,) + tuple(values.shape[1:]), dtype=values.dtype,
            device=values.device,
        )
        presorted = True
    return segment_sum_bucketed(values, plan, exact=exact, presorted=presorted)


class _NeighborGatherFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table: torch.Tensor, gather: "NeighborGather") -> torch.Tensor:
        ctx.gather = gather
        ctx.dtype = table.dtype
        n, k = gather.shape
        return table.index_select(0, gather.flat_indices).reshape(n, k, table.shape[1])

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        flat = g.reshape(-1, g.shape[-1]).contiguous()
        grad = segment_sum_bucketed(flat, ctx.gather.plan, exact=False)
        return grad.to(ctx.dtype), None


class NeighborGather:
    """gather(table [N, D]) → [N, K, D] over a fixed [N, K] neighbor
    table, whose backward scatter-add is K3.  Padded slots (index 0 with
    mask 0) send their cotangent rows to node 0 exactly as an index
    gather's backward would; the masks zero them upstream."""

    def __init__(
        self,
        indices: np.ndarray,
        num_nodes: int,
        *,
        node_block: int = 256,
        edge_block: int = 512,
        device="cuda",
    ) -> None:
        indices = np.asarray(indices)
        if indices.ndim != 2:
            raise ValueError(f"indices must be [N, K], got {indices.shape}")
        self.shape = tuple(indices.shape)
        self.num_nodes = int(num_nodes)
        flat = indices.reshape(-1).astype(np.int64)
        if flat.size and (flat.min() < 0 or flat.max() >= num_nodes):
            raise ValueError(f"neighbor ids outside [0, {num_nodes})")
        self.plan = build_plan(
            flat, num_nodes, node_block=node_block, edge_block=edge_block,
            device=device,
        )
        self.flat_indices = torch.from_numpy(flat).to(self.plan.device)

    def __call__(self, table: torch.Tensor) -> torch.Tensor:
        if table.dim() != 2 or table.shape[0] != self.num_nodes:
            raise ValueError(
                f"gather table must be [{self.num_nodes}, D], got {tuple(table.shape)}"
            )
        if table.device != self.plan.device:
            raise ValueError(
                f"table on {table.device}, neighbor gather built for {self.plan.device}"
            )
        return _NeighborGatherFn.apply(table, self)


def make_neighbor_gather(
    indices: np.ndarray,
    num_nodes: int,
    *,
    node_block: int = 256,
    edge_block: int = 512,
    device="cuda",
) -> NeighborGather:
    """→ gather(table [N, D]) → [N, K, D] whose backward runs K3.

    ``indices`` is the HOST-side neighbor table ([N, K] numpy, or a CPU
    tensor): bucketing happens once per graph snapshot, and the returned
    callable keeps the bucket arrays on ``device``."""
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    return NeighborGather(
        indices, num_nodes, node_block=node_block, edge_block=edge_block,
        device=device,
    )
