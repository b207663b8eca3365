"""Hop-feature ranker: graph training with the aggregation precomputed.

Port of ``dragonfly2_tpu/models/hop.py``, the repo's flagship ranker.
Neighbor aggregates of the *input* features do not depend on the
parameters, so they are computed once per graph snapshot, SIGN-style
(Frasca et al., 2020, "SIGN: Scalable Inception Graph Neural Networks"),
and the gradient never flows through a gather wider than the edge batch:

    precompute:  H = [X, A1·X, A2·(A1·X), deg, rtt-stats]   (once per snapshot)
    train step:  rows = H[src], H[dst]  (narrow endpoint gathers)
                 score = head(enc(rows_s, E[src]), enc(rows_d, E[dst]), qef)

Only the learnable per-node embedding table E is scattered into in the
backward ([B, embed] rows).  The step is dense matrix work: on the card,
cuBLAS GEMMs in bfloat16.  This model has no hand-written kernel, in
either package.

The modules mirror flax's: float32 parameters, bfloat16 compute at flax's
cast points (``Dense`` casts its input, kernel and bias; the encoder's
output layer and the scalar head run in float32), kernels ``[in, out]``,
flax's auto-names (``HopEncoder_0/{Embed_0, Dense_0..2}``, then the head
``Dense_0..2``), so a flax param tree maps onto ``state_dict`` keys path
for path (``models/gnn.load_flax_params``).  Unlike flax, sizes are given
at construction: ``num_nodes`` is the hop features' row count and
``in_dim`` their width.  Dropout (after the encoder's first ``Dense``
only) draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from .gnn import Dense, NeighborTable, dropout, gelu


@dataclass(frozen=True)
class HopConfig:
    hidden: int = 128
    out_dim: int = 64
    hops: int = 2
    node_embed_dim: int = 32
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16


def hop_feature_dim(in_dim: int, hops: int) -> int:
    """Width of ``precompute_hop_features``' output for ``in_dim`` inputs:
    the input, a mean and an RTT-weighted mean per hop, degree and mean
    RTT."""
    return in_dim * (1 + 2 * hops) + 2


@torch.no_grad()
def precompute_hop_features(
    node_feats: torch.Tensor,
    table: NeighborTable,
    *,
    hops: int = 2,
) -> torch.Tensor:
    """[N, D] features + neighbor table → [N, F] hop-augmented features
    (float32, on the table's device).

    Per hop: masked-mean and inverse-RTT-weighted-mean aggregates of the
    previous hop's representation; plus degree and mean-edge-feature
    columns.  One-time gathers outside the train step.
    """
    x = torch.as_tensor(node_feats, dtype=torch.float32).to(table.indices.device)
    idx = table.indices.long()
    return _hop_parts(x, table.mask, table.edge_feats, lambda h: h[idx], hops)


def _hop_parts(
    x: torch.Tensor,
    mask: torch.Tensor,
    edge_feats: torch.Tensor,
    gather: Callable[[torch.Tensor], torch.Tensor],
    hops: int,
) -> torch.Tensor:
    """The hop-aggregation math.  ``gather(h) → [rows, K, D]`` supplies
    each row's neighbor representations (an index gather here; a sharded
    precompute would pass a halo-exchange gather)."""
    m = mask.float()[..., None]                           # [rows, K, 1]
    denom = torch.clamp(m.sum(dim=1), min=1.0)            # [rows, 1]
    # Inverse-RTT weights from the first edge-feature column (normalized
    # RTT at table build): nearer probes describe the node better.
    rtt = edge_feats[..., :1].float()                     # [rows, K, 1]
    w = m / (1.0 + torch.clamp(rtt, min=0.0))
    w_denom = torch.clamp(w.sum(dim=1), min=1e-6)

    parts = [x]
    h = x
    for _ in range(hops):
        nbr = gather(h)                                   # [rows, K, D]
        mean_agg = (nbr * m).sum(dim=1) / denom
        wmean_agg = (nbr * w).sum(dim=1) / w_denom
        h = mean_agg
        parts.extend([mean_agg, wmean_agg])
    deg = m.sum(dim=1) / m.shape[1]                       # [rows, 1] norm degree
    mean_rtt = (rtt * m).sum(dim=1) / denom               # [rows, 1]
    parts.extend([deg, mean_rtt])
    return torch.cat(parts, dim=-1)


class _RowGather(torch.autograd.Function):
    """``table.index_select(0, ids)`` whose backward adds the rows of a
    repeated id in a fixed order.  ``index_select``'s own backward is an
    ``index_add_``, which on the card adds them with atomics in whatever
    order the threads land, so two runs of one step from one state may
    differ in the last bits.  ``index_put_(accumulate=True)`` sorts the
    ids and sums each id's run in sorted order."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table.index_select(0, ids)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (ids,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows,) + tuple(grad.shape[1:]))
        out.index_put_((ids.long(),), grad, accumulate=True)
        return out, None


class Embed(nn.Module):
    """flax ``nn.Embed`` with ``param_dtype=float32``: a [num, features]
    table, initialized as flax's default ``variance_scaling(1.0,
    "fan_in", "normal", out_axis=0)`` (normal, std 1 / sqrt(features)).
    The gather's backward is ``_RowGather``'s, so a step is
    bit-reproducible on the card."""

    def __init__(
        self, num_embeddings: int, features: int, generator: Optional[torch.Generator] = None
    ) -> None:
        super().__init__()
        table = torch.empty(num_embeddings, features)
        nn.init.normal_(table, std=math.sqrt(1.0 / features), generator=generator)
        self.embedding = nn.Parameter(table)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return _RowGather.apply(self.embedding, ids)


class HopEncoder(nn.Module):
    """Hop features (+ learned node embedding) → node representation."""

    def __init__(
        self,
        cfg: HopConfig,
        *,
        num_nodes: int,
        in_dim: int,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.cfg = cfg
        d = in_dim
        if cfg.node_embed_dim > 0:
            self.Embed_0 = Embed(num_nodes, cfg.node_embed_dim, generator)
            d += cfg.node_embed_dim
        self.Dense_0 = Dense(d, cfg.hidden, cfg.dtype, generator)
        self.Dense_1 = Dense(cfg.hidden, cfg.hidden, cfg.dtype, generator)
        self.Dense_2 = Dense(cfg.hidden, cfg.out_dim, torch.float32, generator)

    def forward(
        self,
        rows: torch.Tensor,
        ids: torch.Tensor,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        emb: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``emb``: the embedding rows of ``ids`` when the caller looked
        them up (a node-sharded table), else ``Embed_0(ids)``."""
        cfg = self.cfg
        x = rows.to(cfg.dtype)
        if cfg.node_embed_dim > 0:
            if emb is None:
                emb = self.Embed_0(ids)
            x = torch.cat([x, emb.to(cfg.dtype)], dim=-1)
        x = gelu(self.Dense_0(x))
        if train and cfg.dropout > 0:
            x = dropout(x, cfg.dropout, generator)
        x = gelu(self.Dense_1(x))
        return self.Dense_2(x)


class HopRanker(nn.Module):
    """The flagship ranker: same call signature as ``GATRanker``, but
    ``hop_feats`` must be the PRECOMPUTED hop features and the table is
    not read (aggregation already happened).

    forward(hop_feats, table, src, dst, qef) → [B] predicted
    log-bandwidth per queried parent→child edge.  ``query_edge_dim`` is
    the width of ``query_edge_feats`` (0: none)."""

    def __init__(
        self,
        config: Optional[HopConfig] = None,
        *,
        num_nodes: int,
        in_dim: int,
        query_edge_dim: int = 0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        cfg = config or HopConfig()
        self.config = cfg
        self.num_nodes = num_nodes
        # Set by shard_nodes: this rank's block of the node tables.
        self.node_shard = None
        self.HopEncoder_0 = HopEncoder(cfg, num_nodes=num_nodes, in_dim=in_dim, generator=generator)
        self.Dense_0 = Dense(3 * cfg.out_dim + query_edge_dim, cfg.hidden, cfg.dtype, generator)
        self.Dense_1 = Dense(cfg.hidden, cfg.hidden // 2, cfg.dtype, generator)
        self.Dense_2 = Dense(cfg.hidden // 2, 1, torch.float32, generator)

    def shard_nodes(self, shard) -> "HopRanker":
        """Keep only this rank's block of the node tables
        (``parallel.graph_sharding.NodeShard``): the embedding drops to its
        ``[rows, embed]`` block, the hop features passed in are the
        block, and every endpoint lookup goes through ``shard.lookup``.
        The whole table was drawn first, so a sharded model holds exactly
        the unsharded model's rows."""
        if shard.num_nodes != self.num_nodes:
            raise ValueError(f"shard of {shard.num_nodes} nodes, model built for {self.num_nodes}")
        if self.node_shard is not None:
            raise ValueError("the model's node tables are sharded already")
        if self.config.node_embed_dim > 0:
            embed = self.HopEncoder_0.Embed_0
            embed.embedding = nn.Parameter(shard.block(embed.embedding.detach()).clone())
        self.node_shard = shard
        return self

    def _check(self, hop_feats: torch.Tensor) -> None:
        rows = self.num_nodes if self.node_shard is None else self.node_shard.rows
        if hop_feats.shape[0] != rows:
            raise ValueError(
                f"{hop_feats.shape[0]} hop-feature rows, model built for {rows} nodes"
            )

    def _encode(self, hop_feats, ids, *, train=False, generator=None) -> torch.Tensor:
        """The encoder on nodes ``ids``: an index gather of their hop rows
        and embeddings, or on a node-sharded model one lookup of both."""
        if self.node_shard is None:
            return self.HopEncoder_0(hop_feats.index_select(0, ids), ids,
                                     train=train, generator=generator)
        if self.config.node_embed_dim > 0:
            rows, emb = self.node_shard.lookup(
                ids, hop_feats, self.HopEncoder_0.Embed_0.embedding)
        else:
            (rows,), emb = self.node_shard.lookup(ids, hop_feats), None
        return self.HopEncoder_0(rows, ids, train=train, generator=generator, emb=emb)

    def embeddings(self, hop_feats: torch.Tensor, table: NeighborTable = None) -> torch.Tensor:
        """[N, out_dim] f32 node embeddings of every node (the export
        path, ``trainer/export.export_gnn_scorer``); eval mode.  On a
        node-sharded model every rank of the axis calls it."""
        self._check(hop_feats)
        ids = torch.arange(self.num_nodes, device=hop_feats.device)
        if self.node_shard is None:
            return self.HopEncoder_0(hop_feats, ids)
        return self._encode(hop_feats, ids)

    def forward(
        self,
        hop_feats: torch.Tensor,
        table: NeighborTable,
        src: torch.Tensor,
        dst: torch.Tensor,
        query_edge_feats: Optional[torch.Tensor] = None,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        return_embeddings: bool = False,
    ) -> torch.Tensor:
        if return_embeddings:
            return self.embeddings(hop_feats, table)
        self._check(hop_feats)
        cfg = self.config
        # Both endpoints through the encoder in one pass: its layers act
        # row by row, so this equals two calls.
        ids = torch.cat([src, dst])
        both = self._encode(hop_feats, ids, train=train, generator=generator)
        s, d = both[: src.shape[0]], both[src.shape[0]:]
        parts = [s, d, s * d]
        if query_edge_feats is not None:
            parts.append(query_edge_feats)
        x = torch.cat(parts, dim=-1).to(cfg.dtype)
        x = gelu(self.Dense_0(x))
        x = gelu(self.Dense_1(x))
        return self.Dense_2(x)[..., 0]
