"""Node-partitioned neighbor aggregation and node-sharded tables.

Port of ``dragonfly2_tpu/parallel/graph_sharding.py``.  The node table
shards over one mesh axis: the rank at coordinate ``c`` owns the contiguous
node block ``[c·S, (c+1)·S)``, but its nodes' neighbors live anywhere, so
each aggregation layer performs one exchange before a purely local gather
and masked mean:

- ``sharded_neighbor_aggregate``: an all-gather of every block (N·D floats
  to every rank per layer);
- ``halo_neighbor_aggregate``: one all-to-all of the halo, only the
  off-block rows the rank's table references (n·H rows, H ≪ S under
  locality), from a host-side ``HaloPlan`` (numpy verbatim: its arrays
  and digest equal the JAX package's for one table);
- ``precompute_hop_features_sharded``: the flagship's hop precompute on
  the rank's block, one halo all-to-all per hop, through the port's
  ``models/hop._hop_parts``, so the math stays shared with the replicated
  oracle.

The functions run on every rank of the axis at once (collectives), each
on its block: a tensor of ``N`` rows is cut to the rank's block, one of
``S`` rows is taken as the block.  A whole table is held to the plan's
digest; a block cannot be (the caller owns the pairing, as under ``jit``
in the reference).

``NodeShard`` is the trainers' node-table layout (``node_sharding=
"model"``): the rank's rows of the hop features, of the learnable
embedding and of its AdamW moments; an endpoint lookup is a masked local
gather and one all-reduce over the axis group.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..models.gnn import NeighborTable
from . import mesh as pm
from .mesh import DATA_AXIS, Mesh


def _block(t: torch.Tensor, mesh: Mesh, axis: str, n_rows: int) -> torch.Tensor:
    """The rank's block of a tensor of ``n_rows`` (whole) rows, or the
    tensor itself when it already has the block's rows."""
    n = mesh.shape[axis]
    rows = n_rows // n
    if t.shape[0] == rows:
        return t
    if t.shape[0] != n_rows:
        raise ValueError(f"{t.shape[0]} rows: neither the whole {n_rows} nor a block of {rows}")
    c = mesh.coord(axis)
    return t[c * rows:(c + 1) * rows]


def _table_block(table: NeighborTable, mesh: Mesh, axis: str, n_rows: int) -> NeighborTable:
    return NeighborTable(*(_block(t, mesh, axis, n_rows).to(mesh.device) for t in table))


def _local_aggregate(h_full: torch.Tensor, indices, mask, edge_feats) -> torch.Tensor:
    """Local block of the masked-mean aggregation against the gathered table."""
    nbr = h_full[indices.long()]                                  # [S, K, D]
    nbr = torch.cat([nbr, edge_feats.to(nbr.dtype)], dim=-1)
    m = mask.to(nbr.dtype)[..., None]
    denom = torch.clamp(m.sum(dim=1), min=1.0)
    return (nbr * m).sum(dim=1) / denom                           # [S, D+E]


@torch.no_grad()
def sharded_neighbor_aggregate(
    mesh: Mesh,
    h: torch.Tensor,
    table: NeighborTable,
    *,
    axis: str = DATA_AXIS,
) -> torch.Tensor:
    """Node-sharded masked-mean aggregation: → the rank's [S, D+E] block.

    ``h`` is the rank's [S, D] block; ``table`` the whole table or the
    rank's block (its indices are GLOBAL node ids).  One all-gather
    assembles the whole node table on every rank; everything after is
    local."""
    n = mesh.shape[axis]
    h_block = h.to(mesh.device)
    tb = _table_block(table, mesh, axis, h_block.shape[0] * n)
    h_full = torch.empty((h_block.shape[0] * n,) + tuple(h_block.shape[1:]),
                         dtype=h_block.dtype, device=mesh.device)
    pm.all_gather_into_tensor(h_full, h_block, mesh.group(axis))
    return _local_aggregate(h_full, tb.indices, tb.mask, tb.edge_feats)


def make_sharded_table(mesh: Mesh, table: NeighborTable, *, axis: str = DATA_AXIS) -> NeighborTable:
    """The rank's rows of a host-built table, on the rank's device."""
    return _table_block(table, mesh, axis, table.indices.shape[0])


def pad_nodes_for_mesh(n_nodes: int, mesh: Mesh, *, axis: str = DATA_AXIS) -> int:
    """Node count rounded up so every shard is equal (static shapes)."""
    n = mesh.shape[axis]
    return ((n_nodes + n - 1) // n) * n


# ---------------------------------------------------------------------------
# Halo exchange: ship only the boundary rows, not the whole table
# ---------------------------------------------------------------------------


class HaloPlan:
    """Host-side exchange plan for one graph snapshot.

    The full all-gather moves N·D floats to every device per layer; with a
    locality-partitioned graph each shard's neighbors mostly live on-shard,
    so only the **halo** — the off-shard rows its table references — needs
    to move.  The plan is static-shape (max-halo padded); rebuild it when
    the graph snapshot changes, not per step.

    - send_idx   [n, n, H]  — for src device i: local rows to ship to each
                              dest j (row i used inside shard i).
    - local_idx  [N, K]     — the table's global indices remapped into each
                              shard's local space: [0,S) own rows, then
                              halo slots [S + j·H + p].
    - halo       H          — max off-shard rows needed from any one shard.

    Both arrays are numpy int32 (the reference holds them as jnp arrays).
    """

    def __init__(
        self, n_shards: int, shard_size: int, send_idx, local_idx, halo: int,
        table_digest: str = "",
    ):
        self.n_shards = n_shards
        self.shard_size = shard_size
        self.send_idx = send_idx
        self.local_idx = local_idx
        self.halo = halo
        # Fingerprint of the table's indices at plan time: the plan remaps
        # THOSE indices, so pairing it with a resampled table would
        # silently misalign features.
        self.table_digest = table_digest


def _table_digest(table: NeighborTable) -> str:
    return hashlib.sha1(np.asarray(table.indices.cpu()).tobytes()).hexdigest()[:16]


def _check_plan(plan: "HaloPlan", table: NeighborTable) -> None:
    """Refuse a plan built for a different table sampling.  A block has
    no digest to check: the caller owns the pairing there."""
    if not plan.table_digest or table.indices.shape[0] != plan.local_idx.shape[0]:
        return
    if plan.table_digest != _table_digest(table):
        raise ValueError(
            "HaloPlan was built for a different table sampling — rebuild "
            "the plan whenever build_neighbor_table resamples (per epoch)"
        )


def build_halo_plan(table: NeighborTable, mesh: Mesh, *, axis: str = DATA_AXIS) -> HaloPlan:
    n = mesh.shape[axis]
    indices = np.asarray(table.indices.cpu())
    N, K = indices.shape
    if N % n:
        raise ValueError(f"node count {N} not divisible by {n} shards")
    S = N // n

    # needed[j][i]: sorted unique global rows shard j needs from shard i.
    # uniq is sorted, so each source shard's rows are one contiguous
    # searchsorted slice — no per-element Python (O(N·K) total, numpy).
    needed = [[None] * n for _ in range(n)]
    halo = 0
    bounds = np.arange(n + 1, dtype=np.int64) * S
    for j in range(n):
        block = indices[j * S : (j + 1) * S]
        uniq = np.unique(block)
        cuts = np.searchsorted(uniq, bounds)
        for i in range(n):
            rows = uniq[cuts[i] : cuts[i + 1]]
            if i == j:
                rows = rows[:0]  # own rows need no exchange
            needed[j][i] = rows
            halo = max(halo, len(rows))
    halo = max(halo, 1)

    # send_idx[i][j]: local offsets shard i ships to shard j (pad with 0).
    send_idx = np.zeros((n, n, halo), dtype=np.int32)
    # slot[g] = shard j's local slot for global id g; only ids that occur
    # in shard j's block are ever read, so stale entries are harmless.
    local_idx = np.empty_like(indices, dtype=np.int32)
    slot = np.empty(N, dtype=np.int32)
    for j in range(n):
        slot[j * S : (j + 1) * S] = np.arange(S, dtype=np.int32)
        for i in range(n):
            rows = needed[j][i]
            send_idx[i, j, : len(rows)] = rows - i * S
            slot[rows] = S + i * halo + np.arange(len(rows), dtype=np.int32)
        local_idx[j * S : (j + 1) * S] = slot[indices[j * S : (j + 1) * S]]
    return HaloPlan(
        n, S, send_idx, local_idx, halo,
        table_digest=_table_digest(table),
    )


def _plan_rows(plan: HaloPlan, mesh: Mesh, axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's row of ``send_idx`` [n, H] and its block of ``local_idx``
    [S, K], on its device."""
    c, S = mesh.coord(axis), plan.shard_size
    send = torch.from_numpy(plan.send_idx[c]).to(mesh.device).long()
    local = torch.from_numpy(plan.local_idx[c * S:(c + 1) * S]).to(mesh.device).long()
    return send, local


def _halo_assemble(h_block: torch.Tensor, my_send_idx: torch.Tensor, mesh: Mesh,
                   axis: str) -> torch.Tensor:
    """Exchange boundary rows and return the shard's LOCAL node table
    ``[S + n·H, D]`` (own rows first, then halo slots laid out as
    ``S + src_shard·H + p`` — the order ``build_halo_plan`` remapped
    ``local_idx`` against)."""
    send = h_block[my_send_idx]                                   # [n, H, D]
    recv = torch.empty_like(send)
    pm.all_to_all_single(recv, send, mesh.group(axis))
    # recv [n, H, D]: slice i = rows shipped by shard i to this shard.
    return torch.cat([h_block, recv.reshape(-1, h_block.shape[-1])], dim=0)


@torch.no_grad()
def precompute_hop_features_sharded(
    mesh: Mesh,
    node_feats,
    table: NeighborTable,
    plan: HaloPlan,
    *,
    hops: int = 2,
    axis: str = DATA_AXIS,
) -> torch.Tensor:
    """Node-sharded ``models.hop.precompute_hop_features``: → the rank's
    [S, F] block (float32, on its device).

    The replicated precompute holds the FULL [N, F] feature table (and a
    [N, K, D] gather) on every device — at config[4]'s multi-M-node scale
    that table, not the model, is the memory wall.  Here every rank owns
    S = N/n node rows; per hop the only cross-rank traffic is the halo
    all-to-all of [n·H, D] boundary rows, after which the gather and both
    masked means are local.  ``node_feats`` is [N, D] or the rank's
    block; numpy or a tensor."""
    _check_plan(plan, table)
    n_rows = plan.shard_size * plan.n_shards
    x = _block(torch.as_tensor(np.asarray(node_feats, np.float32))
               if not isinstance(node_feats, torch.Tensor) else node_feats,
               mesh, axis, n_rows).to(mesh.device, torch.float32)
    tb = _table_block(table, mesh, axis, n_rows)
    send, local = _plan_rows(plan, mesh, axis)
    from ..models.hop import _hop_parts

    # Per hop the aggregate keeps D, so ONE plan serves every hop's
    # exchange; the math is models.hop._hop_parts, shared with the
    # replicated oracle so the two cannot drift.
    return _hop_parts(
        x, tb.mask, tb.edge_feats,
        lambda h: _halo_assemble(h, send, mesh, axis)[local], hops,
    )


@torch.no_grad()
def halo_neighbor_aggregate(
    mesh: Mesh,
    h: torch.Tensor,
    table: NeighborTable,
    plan: HaloPlan,
    *,
    axis: str = DATA_AXIS,
) -> torch.Tensor:
    """Masked-mean aggregation with boundary-only exchange: → the rank's
    [S, D+E] block.  Per layer, one all-to-all of [n·H, D] rows replaces
    the [N, D] all-gather — with a locality-aware partition H ≪ S and the
    collective traffic drops by ~S/H.  Numerically identical to the full
    exchange."""
    _check_plan(plan, table)
    n_rows = plan.shard_size * plan.n_shards
    h_block = _block(h, mesh, axis, n_rows).to(mesh.device)
    tb = _table_block(table, mesh, axis, n_rows)
    send, local = _plan_rows(plan, mesh, axis)
    local_table = _halo_assemble(h_block, send, mesh, axis)       # [S + n·H, D]
    nbr = local_table[local]                                      # [S, K, D]
    nbr = torch.cat([nbr, tb.edge_feats.to(nbr.dtype)], dim=-1)
    m = tb.mask.to(nbr.dtype)[..., None]
    denom = torch.clamp(m.sum(dim=1), min=1.0)
    return (nbr * m).sum(dim=1) / denom


# ---------------------------------------------------------------------------
# Node-sharded tables for training (node_sharding="model")
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NodeShard:
    """The rank's block ``[start, start + rows)`` of every node table,
    the tables partitioned over ``axis`` of ``mesh``."""

    mesh: Mesh
    axis: str
    num_nodes: int

    @property
    def rows(self) -> int:
        return self.num_nodes // self.mesh.shape[self.axis]

    @property
    def start(self) -> int:
        return self.mesh.coord(self.axis) * self.rows

    def block(self, t):
        """The rank's rows of a whole table (numpy or tensor)."""
        return t[self.start:self.start + self.rows]

    def lookup(self, ids: torch.Tensor, *blocks: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Row ``ids`` (global node ids, the same on every rank of the
        axis) of each node table, from the blocks: each rank gathers the
        ids it owns (zero elsewhere) and one all-reduce over the axis
        sums the partial rows.  The backward of the sum is the identity
        (the caller's compute after the lookup is the same on every rank
        of the axis); each block's gradient adds its owned rows in sorted
        id order (``index_put_``), so a step is bit-reproducible."""
        return _ShardLookup.apply(self, ids, *blocks)

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The whole table from every rank's block (one all-gather)."""
        n = self.mesh.shape[self.axis]
        out = torch.empty((block.shape[0] * n,) + tuple(block.shape[1:]),
                          dtype=block.dtype, device=block.device)
        return pm.all_gather_into_tensor(out, block, self.mesh.group(self.axis))


class _ShardLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard: NodeShard, ids: torch.Tensor, *blocks: torch.Tensor):
        local = ids.long() - shard.start
        own = (local >= 0) & (local < shard.rows)
        local = torch.where(own, local, torch.zeros_like(local))
        widths = [b.shape[1] for b in blocks]
        parts = [torch.where(own[:, None], b.index_select(0, local).float(), 0.0)
                 for b in blocks]
        rows = pm.all_reduce(torch.cat(parts, dim=1), shard.mesh.group(shard.axis))
        ctx.save_for_backward(local, own)
        ctx.shapes = [tuple(b.shape) for b in blocks]
        ctx.dtypes = [b.dtype for b in blocks]
        return tuple(rows.split(widths, dim=1))

    @staticmethod
    def backward(ctx, *grads):
        local, own = ctx.saved_tensors
        outs = []
        for i, (shape, dtype) in enumerate(zip(ctx.shapes, ctx.dtypes)):
            g = grads[i]
            if not ctx.needs_input_grad[2 + i] or g is None:
                outs.append(None)
                continue
            out = g.new_zeros(shape, dtype=dtype)
            g = torch.where(own[:, None], g, torch.zeros((), dtype=g.dtype, device=g.device))
            out.index_put_((local,), g.to(dtype), accumulate=True)
            outs.append(out)
        return (None, None, *outs)
