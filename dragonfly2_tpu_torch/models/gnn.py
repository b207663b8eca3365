"""GNNs over the probe graph: GraphSAGE and the GAT parent-peer ranker.

Port of ``dragonfly2_tpu/models/gnn.py``:
- ``GraphSAGE``  — mean-aggregator SAGE encoder (BASELINE configs[1]);
- ``GATRanker``  — GAT encoder + edge-score head predicting per-edge
  log-bandwidth for parent ranking (configs[2]).

Every node has exactly K neighbor slots (``build_neighbor_table``): the
model sees dense [N, K] index, mask and edge-feature tensors, and
aggregation is one gather and a masked mean (SAGE) or softmax (GAT).
Both layers take ``GNNConfig.gather_fn`` for the gather (the index
gather otherwise).

The modules mirror flax's: parameters are float32, compute is bfloat16
at exactly the places flax casts (``Dense`` casts its input, kernel and
bias to its dtype; the attention softmax and the embedding projection
run in float32), kernels are ``[in, out]`` and the submodules carry
flax's auto-names (``GATLayer_0``, ``Dense_3``, ...), so a flax param
tree maps onto ``state_dict`` keys path for path
(``load_flax_params``).  Unlike flax, sizes are given at construction
(``num_nodes``, ``in_dim``).  Dropout draws from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class NeighborTable(NamedTuple):
    """Dense, static-shape adjacency: for each node, K neighbor slots.

    indices   [N, K] int32   — neighbor node ids (0 where padded)
    mask      [N, K] float32 — 1.0 for real neighbors, 0.0 for padding
    edge_feats[N, K, E] float32 — per-edge features (normalized RTT, ...)
    """

    indices: torch.Tensor
    mask: torch.Tensor
    edge_feats: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.indices.shape[0]

    @property
    def max_neighbors(self) -> int:
        return self.indices.shape[1]

    def to(self, device) -> "NeighborTable":
        return NeighborTable(*(t.to(device) for t in self))


def build_neighbor_table(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    edge_feats: Optional[np.ndarray] = None,
    *,
    max_neighbors: int = 16,
    rng: Optional[np.random.Generator] = None,
) -> NeighborTable:
    """Host-side: edge lists → padded per-node neighbor slots (CPU tensors).

    Edges are directed src→dst; the table lists, for each *dst* node, the
    src nodes probing it (in-neighbors).  Over-degree nodes get a uniform
    sample (fresh each call ⇒ per-epoch resampling): a random permutation
    of the edge list followed by a stable sort on dst makes "first
    max_neighbors per group" a uniform without-replacement sample.
    """
    rng = rng or np.random.default_rng(0)
    src = np.asarray(src)
    dst = np.asarray(dst)
    if edge_feats is None:
        edge_feats = np.zeros((len(src), 1), dtype=np.float32)
    edge_feats = np.asarray(edge_feats, dtype=np.float32)
    if edge_feats.ndim == 1:
        edge_feats = edge_feats[:, None]
    e_dim = edge_feats.shape[1]

    indices = np.zeros((n_nodes, max_neighbors), dtype=np.int32)
    mask = np.zeros((n_nodes, max_neighbors), dtype=np.float32)
    feats = np.zeros((n_nodes, max_neighbors, e_dim), dtype=np.float32)

    if len(src):
        # Out-of-range dst (stale/hostile ids) drop silently — a negative
        # dst would otherwise wrap around into the LAST row.
        in_range = (dst >= 0) & (dst < n_nodes)
        if not in_range.all():
            src, dst, edge_feats = (
                src[in_range], dst[in_range], edge_feats[in_range]
            )
    if len(src):
        perm = rng.permutation(len(src))
        order = perm[np.argsort(dst[perm], kind="stable")]
        dst_s = dst[order]
        boundaries = np.searchsorted(dst_s, np.arange(n_nodes + 1))
        pos = np.arange(len(dst_s)) - boundaries[dst_s]  # rank within group
        keep = pos < max_neighbors
        rows, cols, eid = dst_s[keep], pos[keep], order[keep]
        indices[rows, cols] = src[eid]
        mask[rows, cols] = 1.0
        feats[rows, cols] = edge_feats[eid]
    return NeighborTable(
        indices=torch.from_numpy(indices),
        mask=torch.from_numpy(mask),
        edge_feats=torch.from_numpy(feats),
    )


@dataclass(frozen=True)
class GNNConfig:
    hidden: int = 128
    out_dim: int = 64
    num_layers: int = 2
    num_heads: int = 4
    edge_dim: int = 1
    # Learnable per-node embedding concatenated to the host features
    # (the latent position the host stats cannot encode).  0 disables.
    node_embed_dim: int = 32
    dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16
    # Optional neighbor-gather override (ops.segment.make_neighbor_gather):
    # an index gather whose backward scatter-add runs the segment-sum
    # kernel.  Must be built from the SAME [N, K] indices as the
    # NeighborTable passed at call time.
    gather_fn: Optional[Callable] = None


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh form (not ``F.gelu``'s erf default)."""
    return F.gelu(x, approximate="tanh")


@dataclass(frozen=True)
class BatchRowsDraw:
    """Dropout's draw on one rank of a data-parallel step: ``generator``
    draws the mask of the whole global batch (``parts`` data ranks of
    ``rows`` rows each, in data-coordinate order) and the rank keeps the
    rows of its data coordinate ``index``.  So every data rank gets its
    own masks, and together they are a one-device run's mask of the global
    batch.  An input of several stacked batches (the hop encoder's source
    rows over its destination rows) is drawn as that many global
    batches.  Every rank draws the same amount, so the generators stay
    equal across the mesh."""

    generator: torch.Generator
    parts: int
    index: int
    rows: int

    def rand(self, shape, device) -> torch.Tensor:
        stacked, rem = divmod(shape[0], self.rows)
        if rem:
            raise ValueError(f"{shape[0]} rows are not a stack of {self.rows}-row batches")
        full = torch.rand((stacked, self.parts, self.rows, *shape[1:]),
                          generator=self.generator, device=device)
        return full[:, self.index].reshape(shape)


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator | BatchRowsDraw]
) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    values by 1 / (1 - rate) in ``x``'s dtype."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    if isinstance(generator, BatchRowsDraw):
        draw = generator.rand(x.shape, x.device)
    else:
        draw = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draw < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Dense(nn.Module):
    """flax ``nn.Dense`` with ``param_dtype=float32``: kernel [in, out]
    (lecun-normal), bias [out] (zeros); input, kernel and bias cast to
    ``dtype``, the product and the bias add both in ``dtype``."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        dtype: torch.dtype = torch.bfloat16,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        std = math.sqrt(1.0 / max(in_dim, 1)) / 0.87962566103423978
        kernel = torch.empty(in_dim, out_dim)
        nn.init.trunc_normal_(kernel, std=std, a=-2 * std, b=2 * std, generator=generator)
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class NodeEmbedding(nn.Module):
    """[N, D] features → [N, D + embed_dim] with a learned identity."""

    def __init__(
        self, num_nodes: int, embed_dim: int, generator: Optional[torch.Generator] = None
    ) -> None:
        super().__init__()
        self.num_nodes = num_nodes
        self.embed_dim = embed_dim
        if embed_dim > 0:
            emb = torch.empty(num_nodes, embed_dim)
            nn.init.normal_(emb, std=0.1, generator=generator)
            self.embedding = nn.Parameter(emb)

    def forward(self, node_feats: torch.Tensor) -> torch.Tensor:
        if self.embed_dim <= 0:
            return node_feats
        if node_feats.shape[0] != self.num_nodes:
            raise ValueError(
                f"{node_feats.shape[0]} node rows, embedding built for {self.num_nodes}"
            )
        return torch.cat([node_feats, self.embedding.to(node_feats.dtype)], dim=-1)


def _gather_neighbors(
    h: torch.Tensor, table: NeighborTable, gather_fn: Optional[Callable]
) -> torch.Tensor:
    """[N, K, D] neighbor rows of ``h``: ``gather_fn(h)`` when given (built
    from the same [N, K] indices; its shape is checked against the
    table), else an index gather."""
    N, K = table.indices.shape
    if gather_fn is None:
        return h.index_select(0, table.indices.reshape(-1)).reshape(N, K, -1)
    h_n = gather_fn(h)
    if tuple(h_n.shape[:2]) != tuple(table.indices.shape):
        raise ValueError(
            f"gather_fn output {tuple(h_n.shape[:2])} does not match the "
            f"neighbor table {tuple(table.indices.shape)} — rebuild it "
            f"from table.indices (make_neighbor_gather, "
            f"make_transpose_gather) for THIS graph snapshot"
        )
    return h_n


class SAGELayer(nn.Module):
    """h' = act(W_self h ++ W_agg mean_k(h_nbr ++ e)) — one gather and
    three ``Dense`` (flax's ``Dense_0`` self, ``Dense_1`` aggregate,
    ``Dense_2`` out).  As flax computes it: the edge features are
    concatenated to the neighbor rows before the mean, and the mask, the
    denominator and the mean are all in the compute dtype."""

    def __init__(
        self,
        in_dim: int,
        width: int,
        edge_dim: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        gather_fn: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.width = width
        self.dtype = dtype
        self.gather_fn = gather_fn
        self.Dense_0 = Dense(in_dim, width, dtype, generator)              # self
        self.Dense_1 = Dense(in_dim + edge_dim, width, dtype, generator)   # aggregate
        self.Dense_2 = Dense(2 * width, width, dtype, generator)           # out

    def forward(self, h: torch.Tensor, table: NeighborTable) -> torch.Tensor:
        dt = self.dtype
        h = h.to(dt)
        nbr = _gather_neighbors(h, table, self.gather_fn)                  # [N, K, D]
        nbr = torch.cat([nbr, table.edge_feats.to(dt)], dim=-1)           # [N, K, D+E]
        m = table.mask.to(dt)[..., None]                                   # [N, K, 1]
        denom = torch.clamp(m.sum(dim=1), min=1.0)                         # [N, 1]
        agg = (nbr * m).sum(dim=1) / denom                                 # [N, D+E]
        out = torch.cat([self.Dense_0(h), self.Dense_1(agg)], dim=-1)
        return gelu(self.Dense_2(out))


class GraphSAGE(nn.Module):
    """Node features [N, D] + neighbor table → embeddings [N, out_dim]
    (flax names: ``NodeEmbedding_0``, ``SAGELayer_0..``, ``Dense_0``).
    Dropout applies after each layer when training."""

    def __init__(
        self,
        config: Optional[GNNConfig] = None,
        *,
        num_nodes: int,
        in_dim: int,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        cfg = config or GNNConfig()
        self.config = cfg
        self.NodeEmbedding_0 = NodeEmbedding(num_nodes, cfg.node_embed_dim, generator)
        d = in_dim + max(cfg.node_embed_dim, 0)
        for i in range(cfg.num_layers):
            setattr(self, f"SAGELayer_{i}", SAGELayer(
                d, cfg.hidden, cfg.edge_dim, cfg.dtype, cfg.gather_fn, generator,
            ))
            d = cfg.hidden
        self.Dense_0 = Dense(d, cfg.out_dim, torch.float32, generator)

    def forward(
        self,
        node_feats: torch.Tensor,
        table: NeighborTable,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        cfg = self.config
        h = self.NodeEmbedding_0(node_feats)
        for i in range(cfg.num_layers):
            h = getattr(self, f"SAGELayer_{i}")(h, table)
            if train and cfg.dropout > 0:
                h = dropout(h, cfg.dropout, generator)
        return self.Dense_0(h)


class GATLayer(nn.Module):
    """Multi-head attention over the K neighbor slots (masked softmax in
    f32).  The raw neighbor rows are gathered ONCE and k/v projected
    after the gather: one [N, K, D] gather and one backward scatter."""

    def __init__(
        self,
        in_dim: int,
        width: int,
        num_heads: int,
        edge_dim: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        gather_fn: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.width = width
        self.num_heads = num_heads
        self.dtype = dtype
        self.gather_fn = gather_fn
        hw = num_heads * width
        self.Dense_0 = Dense(in_dim, hw, dtype, generator)        # q
        self.Dense_1 = Dense(in_dim, hw, dtype, generator)        # k
        self.Dense_2 = Dense(in_dim, hw, dtype, generator)        # v
        self.Dense_3 = Dense(edge_dim, num_heads, dtype, generator)  # edge bias
        self.Dense_4 = Dense(hw, hw, dtype, generator)            # output

    def forward(self, h: torch.Tensor, table: NeighborTable) -> torch.Tensor:
        H, W, dt = self.num_heads, self.width, self.dtype
        h = h.to(dt)
        q = self.Dense_0(h)
        N, K = table.indices.shape
        q = q.reshape(N, H, W)
        h_n = _gather_neighbors(h, table, self.gather_fn)      # [N, K, D]
        k_n = self.Dense_1(h_n).reshape(N, K, H, W)
        v_n = self.Dense_2(h_n).reshape(N, K, H, W)
        e_bias = self.Dense_3(table.edge_feats.to(dt))           # [N, K, H]
        # As flax: the logits einsum, the division by sqrt(W) (computed
        # in bf16) and the bias add all in bf16, then f32.
        scale = torch.sqrt(torch.tensor(float(W), dtype=dt, device=h.device))
        logits = torch.einsum("nhw,nkhw->nkh", q, k_n) / scale
        logits = (logits + e_bias).float()
        neg_inf = torch.tensor(torch.finfo(torch.float32).min, device=h.device)
        mask = table.mask[..., None]
        logits = torch.where(mask > 0, logits, neg_inf)
        attn = torch.softmax(logits, dim=1)
        # Fully-padded rows: softmax over all -inf is uniform garbage → zero it.
        attn = attn * mask
        out = torch.einsum("nkh,nkhw->nhw", attn.to(dt), v_n).reshape(N, H * W)
        return gelu(self.Dense_4(out) + out)


class GATRanker(nn.Module):
    """GAT encoder + edge-score head (the parent-peer ranker).

    forward(node_feats, table, src, dst, query_edge_feats) → [B] scores:
    predicted log-bandwidth for each queried src→dst (parent→child)
    edge.  ``query_edge_dim`` is the width of ``query_edge_feats`` (0:
    none)."""

    def __init__(
        self,
        config: Optional[GNNConfig] = None,
        *,
        num_nodes: int,
        in_dim: int,
        query_edge_dim: int = 0,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        cfg = config or GNNConfig()
        self.config = cfg
        per_head = max(cfg.hidden // cfg.num_heads, 1)
        self.NodeEmbedding_0 = NodeEmbedding(num_nodes, cfg.node_embed_dim, generator)
        d = in_dim + max(cfg.node_embed_dim, 0)
        for i in range(cfg.num_layers):
            setattr(self, f"GATLayer_{i}", GATLayer(
                d, per_head, cfg.num_heads, cfg.edge_dim, cfg.dtype, cfg.gather_fn,
                generator,
            ))
            d = per_head * cfg.num_heads
        self.Dense_0 = Dense(d, cfg.out_dim, torch.float32, generator)
        self.Dense_1 = Dense(3 * cfg.out_dim + query_edge_dim, cfg.hidden, cfg.dtype, generator)
        self.Dense_2 = Dense(cfg.hidden, cfg.hidden // 2, cfg.dtype, generator)
        self.Dense_3 = Dense(cfg.hidden // 2, 1, torch.float32, generator)

    def embeddings(
        self,
        node_feats: torch.Tensor,
        table: NeighborTable,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """[N, out_dim] f32 node embeddings (the export path)."""
        cfg = self.config
        h = self.NodeEmbedding_0(node_feats)
        for i in range(cfg.num_layers):
            h = getattr(self, f"GATLayer_{i}")(h, table)
            if train and cfg.dropout > 0:
                h = dropout(h, cfg.dropout, generator)
        return self.Dense_0(h)

    def forward(
        self,
        node_feats: torch.Tensor,
        table: NeighborTable,
        src: torch.Tensor,
        dst: torch.Tensor,
        query_edge_feats: Optional[torch.Tensor] = None,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        return_embeddings: bool = False,
    ) -> torch.Tensor:
        emb = self.embeddings(node_feats, table, train=train, generator=generator)
        if return_embeddings:
            return emb
        s = emb.index_select(0, src)
        d = emb.index_select(0, dst)
        parts = [s, d, s * d]
        if query_edge_feats is not None:
            parts.append(query_edge_feats)
        x = torch.cat(parts, dim=-1).to(self.config.dtype)
        x = gelu(self.Dense_1(x))
        x = gelu(self.Dense_2(x))
        return self.Dense_3(x)[..., 0]


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v.items()), path))
        else:
            out[path] = np.asarray(v)
    return out


def load_flax_params(model: nn.Module, params: Dict) -> nn.Module:
    """Copy a flax param tree (nested dicts of arrays, e.g. after
    ``jax.tree_util.tree_map(np.asarray, params)``) into ``model``, a
    ``GATRanker``, a ``GraphSAGE`` (or the trainer's edge model around
    one) or an ``MLPRegressor``.

    Flax paths map one for one onto ``state_dict`` keys.  GraphSAGE:
    ``NodeEmbedding_0/embedding``; ``SAGELayer_i/Dense_0..2/{kernel,bias}``
    (self, aggregate, out); ``Dense_0/{kernel,bias}``.  GATRanker:
    ``NodeEmbedding_0/embedding``; ``GATLayer_i/Dense_0..4/{kernel,bias}``
    (q, k, v, edge bias, output); ``Dense_0..3/{kernel,bias}``
    (embedding projection, then the head).  MLPRegressor:
    ``Dense_0..n/{kernel,bias}``.  Kernels are ``[in, out]`` on both
    sides.  A missing, extra or misshapen leaf raises.  A node-sharded
    model (``HopRanker.shard_nodes``) takes its block of each whole node
    table (an ``embedding`` leaf)."""
    flat = _flatten(params)
    state = dict(model.named_parameters())
    want = {k.replace(".", "/") for k in state}
    if set(flat) != want:
        raise ValueError(
            f"flax params do not match the model: missing {sorted(want - set(flat))}, "
            f"unexpected {sorted(set(flat) - want)}"
        )
    shard = getattr(model, "node_shard", None)
    with torch.no_grad():
        for path, value in flat.items():
            p = state[path.replace("/", ".")]
            if (shard is not None and path.split("/")[-1] == "embedding"
                    and value.shape[0] == shard.num_nodes):
                value = shard.block(value)
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{path}: flax shape {value.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(value, np.float32)))
    return model


def to_flax_params(model: nn.Module) -> Dict:
    """The model's parameters as a flax-shaped nested dict of numpy arrays."""
    tree: Dict = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().cpu().numpy()
    return tree
