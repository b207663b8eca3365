"""Spawned ranks and the multi-device dry run.

``run_ranks(body, n)`` starts ``n`` processes, one per device, joins them
in one process group through a ``FileStore`` in a fresh temporary
directory (no fixed port) and returns each rank's result.
``dryrun_multichip(n, device=)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: its phases on an (n/2 × 2) mesh.

The rank bodies live in this module and import neither JAX nor anything
of the JAX package, so the spawned children never load JAX, even when
the process that spawns them has.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist


def _rank_entry(rank, n, body, device, backend, tmp, args) -> None:
    dev = torch.device(device)
    if dev.type == "cpu":
        # The n ranks share the host's cores: one intra-op thread each
        # keeps them from oversubscribing it.
        torch.set_num_threads(1)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), n)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"), store=store,
        rank=rank, world_size=n, timeout=datetime.timedelta(seconds=600),
    )
    try:
        out = body(rank, dev, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(
    body: Callable, n: int, *, device="cpu", backend: Optional[str] = None,
    args: Sequence = (),
) -> list:
    """``body(rank, device, *args)`` in ``n`` spawned processes; → their
    return values (anything ``torch.save`` takes) in rank order.

    ``body`` is a module-level function (the children import it by
    name).  ``device`` is ``"cpu"``, ``"cuda"`` (rank ``r`` on card ``r``
    mod the card count) or one card for every rank (``"cuda:0"``: only
    with ``backend="gloo"``, NCCL refuses two ranks on one device).  The
    group's backend is NCCL on a card and gloo on the CPU unless
    ``backend`` names one.  A CPU rank runs one intra-op thread.  A rank
    that raises fails the call."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="df_ranks_")
    try:
        mp.spawn(_rank_entry, args=(n, body, str(device), backend, tmp, tuple(args)),
                 nprocs=n, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The multi-device dry run
# ---------------------------------------------------------------------------


def _dryrun_rank(rank: int, dev: torch.device, n_devices: int, backend: Optional[str]) -> dict:
    """One rank of ``dryrun_multichip``: the reference's phases on an
    (n/2 × 2) mesh, tiny but real shapes.  → the phases' numbers."""
    import numpy as np

    from ..models.gnn import GATRanker, GNNConfig, build_neighbor_table
    from ..models.hop import HopConfig, HopRanker, precompute_hop_features
    from ..records.features import DOWNLOAD_COLUMNS
    from ..records.synthetic import SyntheticCluster
    from ..trainer.online_graph import OnlineGraphConfig, OnlineGraphTrainer
    from ..trainer.train import (
        TrainConfig, TrainState, _graph_train_step, _is_node_table_path, _make_optimizer,
        _MeshSync,
    )
    from .graph_sharding import (
        NodeShard, build_halo_plan, halo_neighbor_aggregate, make_sharded_table,
        pad_nodes_for_mesh, precompute_hop_features_sharded,
    )
    from .mesh import DATA_AXIS, MODEL_AXIS, MeshSpec, create_mesh

    model_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = create_mesh(MeshSpec(data=n_devices // model_par, model=model_par),
                       device=dev, backend=backend)
    out = {"mesh": dict(mesh.shape)}

    # Tiny but real: node count divisible by the model axis, batch by data.
    n_nodes = 8 * model_par
    batch = 4 * (n_devices // model_par)
    cluster = SyntheticCluster(num_hosts=n_nodes, seed=0)
    src, dst, rtt = cluster.probe_edges(density=0.5, seed=0)
    table = build_neighbor_table(n_nodes, src, dst, rtt / 1e9, max_neighbors=4)
    node_feats = torch.from_numpy(cluster._host_feature_matrix())
    rng = np.random.default_rng(0)
    q_src = torch.from_numpy(rng.integers(0, n_nodes, batch))
    q_dst = torch.from_numpy(rng.integers(0, n_nodes, batch))
    target = torch.from_numpy(rng.normal(size=batch).astype(np.float32))
    per = batch // mesh.shape[DATA_AXIS]
    mine = slice(mesh.coord(DATA_AXIS) * per, (mesh.coord(DATA_AXIS) + 1) * per)
    cfg = TrainConfig(warmup_steps=1)

    def step(model, nf, node_sharded=False):
        """One data-parallel step on this rank's rows of the batch."""
        model.to(dev)
        state = TrainState(model=model, opt=_make_optimizer(list(model.parameters()), cfg, 1),
                           generator=torch.Generator(device=dev).manual_seed(1))
        state.opt.sync = _MeshSync(mesh, [
            node_sharded and _is_node_table_path(n) for n, _ in model.named_parameters()])
        state, loss = _graph_train_step(
            state, nf.to(dev), table.to(dev), q_src[mine].to(dev), q_dst[mine].to(dev),
            target[mine].to(dev), None)
        loss = float(loss)
        assert np.isfinite(loss), f"non-finite loss {loss}"
        assert state.step == 1
        return loss

    # Phase 1 — one data-parallel GAT step.  The node table stays whole on
    # every rank (the reference shards it by placement and XLA gathers it
    # back: the function is the same).
    gat = GATRanker(GNNConfig(hidden=16, out_dim=8, num_layers=1, num_heads=2, node_embed_dim=8),
                    num_nodes=n_nodes, in_dim=node_feats.shape[1],
                    generator=torch.Generator().manual_seed(0))
    out["gat_loss"] = step(gat, node_feats)

    # Phase 1b / 1c — the flagship, one step replicated, then one with the
    # hop features, the embedding and its moments node-sharded over the
    # model axis: the same update.
    hop_cfg = HopConfig(hidden=16, out_dim=8, node_embed_dim=8, hops=2)
    hop_feats = precompute_hop_features(node_feats, table.to(dev), hops=hop_cfg.hops)

    def hop_model():
        return HopRanker(hop_cfg, num_nodes=n_nodes, in_dim=hop_feats.shape[1],
                         generator=torch.Generator().manual_seed(2))

    out["hop_loss"] = step(hop_model(), hop_feats)
    shard = NodeShard(mesh, MODEL_AXIS, n_nodes)
    out["hop_mp_loss"] = step(hop_model().shard_nodes(shard), shard.block(hop_feats),
                              node_sharded=True)
    np.testing.assert_allclose(out["hop_mp_loss"], out["hop_loss"], rtol=1e-4, atol=1e-5)

    # Phase 2 — the halo-exchange aggregation over the data axis against
    # the unsharded oracle.
    n_halo = pad_nodes_for_mesh(16 * (n_devices // model_par), mesh)
    cluster2 = SyntheticCluster(num_hosts=n_halo, seed=1)
    src2, dst2, rtt2 = cluster2.probe_edges(density=0.3, seed=1)
    table2 = build_neighbor_table(n_halo, src2, dst2, rtt2 / 1e9, max_neighbors=4)
    h = torch.from_numpy(np.random.default_rng(2).normal(size=(n_halo, 8)).astype(np.float32))
    nbr = torch.cat([h[table2.indices.long()], table2.edge_feats], dim=-1)
    m = table2.mask[..., None]
    want = (nbr * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    plan = build_halo_plan(table2, mesh)
    got = halo_neighbor_aggregate(mesh, h, make_sharded_table(mesh, table2), plan)
    S = plan.shard_size
    c = mesh.coord(DATA_AXIS)
    np.testing.assert_allclose(got.cpu().numpy(), want[c * S:(c + 1) * S].numpy(),
                               rtol=1e-4, atol=1e-4)
    out["halo"] = {"H": plan.halo, "S": S}

    # Phase 2b — the flagship precompute node-sharded over the model axis
    # against the replicated one from 1b.
    plan_mp = build_halo_plan(table, mesh, axis=MODEL_AXIS)
    hop_sharded = precompute_hop_features_sharded(mesh, node_feats, table, plan_mp,
                                                  hops=hop_cfg.hops, axis=MODEL_AXIS)
    np.testing.assert_allclose(hop_sharded.cpu().numpy(), shard.block(hop_feats).cpu().numpy(),
                               rtol=1e-5, atol=1e-5)

    # Phase 3 — the online graph trainer on the mesh: rank 0 feeds, every
    # rank trains its columns of each dispatch, the snapshot swaps.
    def online(max_neighbors, nf, s, d, r):
        return OnlineGraphTrainer(
            OnlineGraphConfig(
                num_nodes=n_nodes, max_neighbors=max_neighbors, batch_size=batch,
                super_steps=2, queue_capacity=8,
                model=HopConfig(hidden=16, out_dim=8, node_embed_dim=4),
                train=TrainConfig(warmup_steps=1), total_steps_hint=64,
                mesh=mesh, node_sharding="model",
            ),
            node_feats=nf, topo_src=s, topo_dst=d, topo_rtt=r,
        )

    rtt_s = np.asarray(rtt / 1e9, np.float32)
    og = online(4, cluster._host_feature_matrix(), src, dst, rtt_s)
    rng_og = np.random.default_rng(5)
    for _ in (1, 2):
        es = rng_og.integers(0, n_nodes, 2 * batch).astype(np.int32)
        ed = (es + rng_og.integers(1, n_nodes, 2 * batch).astype(np.int32)) % n_nodes
        y = rng_og.normal(size=2 * batch).astype(np.float32)
        if rank == 0:
            og.feed_downloads(es, ed, y)
    assert og.run(max_dispatches=2, idle_timeout=0.5) == 2
    if rank == 0:
        og.feed_topology(dst, src, rtt_s)
    assert og.refresh_snapshot() is not None  # sharded precompute re-runs
    es = rng_og.integers(0, n_nodes, 2 * batch).astype(np.int32)
    if rank == 0:
        og.feed_downloads(es, (es + 1) % n_nodes, np.zeros(2 * batch, np.float32))
    assert og.run(max_dispatches=1, idle_timeout=0.5) == 1
    assert og.state.step == 6 and og.snapshot_idx == 1

    # Phase 3b — the same mesh loop fed through the wire adapter on rank 0
    # at K = 32: bucket rows → WireIngestAdapter → a wire-fed snapshot by
    # the sharded precompute → dispatch blocks from the adapter.
    z = np.zeros(0, np.int32)
    og2 = online(32, np.zeros((n_nodes, 12), np.float32), z, z, np.zeros(0, np.float32))
    rng_w = np.random.default_rng(6)
    topo_rows = np.zeros((n_nodes * 8, 3), np.float32)
    topo_rows[:n_nodes, 0] = np.arange(n_nodes)  # ascending: identity ids
    topo_rows[:n_nodes, 1] = np.roll(np.arange(n_nodes), 1)
    topo_rows[n_nodes:, 0] = rng_w.integers(0, n_nodes, n_nodes * 7)
    topo_rows[n_nodes:, 1] = rng_w.integers(0, n_nodes, n_nodes * 7)
    topo_rows[:, 2] = rng_w.random(len(topo_rows)).astype(np.float32) * 0.05
    dl = rng_w.random((3 * batch, len(DOWNLOAD_COLUMNS))).astype(np.float32)
    dl[:, 0] = rng_w.integers(0, n_nodes, len(dl))
    dl[:, 1] = (dl[:, 0] + 1 + rng_w.integers(0, n_nodes - 1, len(dl))) % n_nodes
    ad = og2.make_wire_adapter() if rank == 0 else None
    if ad is not None:
        ad.feed_topology_rows(topo_rows)
    assert og2.refresh_snapshot() is not None  # K=32 sharded precompute
    if ad is not None:
        ad.feed_download_rows(dl)
        assert ad.overflow_edges == 0
    assert og2.run(max_dispatches=1, idle_timeout=5.0) == 1
    og2.close()
    out["online_steps"] = og.state.step
    return out


def dryrun_multichip(n_devices: int, *, device="cuda") -> dict:
    """Spawn ``n_devices`` ranks on ``device`` (``"cpu"``: gloo; ``"cuda"``:
    one card each, NCCL) and run the reference dry run's phases on an
    (n/2 × 2) mesh: a data-parallel GAT step (1), one flagship step
    replicated and one node-sharded with equal losses (1b, 1c), the halo
    aggregate against the unsharded oracle (2), the sharded precompute
    against the replicated one (2b), and the online mesh trainer directly
    (3) and through the wire adapter (3b).  A failed check raises.
    → ``{"ok": True, "mesh": ..., "ranks": [each rank's numbers]}``."""
    ranks = run_ranks(_dryrun_rank, n_devices, device=device, args=(n_devices, None))
    losses = {(r["gat_loss"], r["hop_loss"], r["hop_mp_loss"]) for r in ranks}
    if len(losses) != 1:
        raise AssertionError(f"ranks disagree on the losses: {losses}")
    first = ranks[0]
    print(
        f"dryrun_multichip ok: mesh={first['mesh']} gat_loss={first['gat_loss']:.4f} "
        f"hop_loss={first['hop_loss']:.4f} hop_mp_loss={first['hop_mp_loss']:.4f} "
        f"halo_exchange=verified precompute_sharded=verified online_mesh_trainer=verified "
        f"wire_adapter_k32=python", flush=True,
    )
    return {"ok": True, "mesh": first["mesh"], "ranks": ranks}
