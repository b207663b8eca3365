"""Port parity: the online graph trainer,
``dragonfly2_tpu_torch/trainer/online_graph.py`` against
``dragonfly2_tpu/trainer/online_graph.py`` (BASELINE configs[4] as the
north star writes it: continuous two-stream ingest into the flagship hop
ranker, mid-training snapshot refresh, node-id recycling, resume).

The port runs on the CPU (``device="cpu"``); the JAX package on its CPU
backend.  Both run ``native_ingest=False`` (the Python adapter, the
spec), except where a case says otherwise: the native ``oi_*`` engine,
the default in both packages, is held to the spec and to the JAX
package's engine in ``tests/test_torch_native_ingest.py``.  Sizes are the reference test's own (128 nodes, K 8, batch
256, 4 steps a dispatch, ``HopConfig(hidden=16, out_dim=8,
node_embed_dim=4)``).  Parity runs carry flax's init into the port
(``load_flax_params``) and set dropout to 0: a seed initializes the two
packages with other weights, and their dropout draws differ.

Tolerances, stated:
- the snapshot: neighbor-table indices and mask exact; edge features and
  hop features within 1e-5 absolute (float32 sums in another order);
- the wire-fed run (a snapshot from the wire, a refresh after dispatch
  2, TTL eviction of 126 ids before dispatch 3): each dispatch's mean
  loss within 5e-3 (bf16) and 1e-4 (float32) relative; per parameter
  leaf and for the embedding's AdamW moments, ``‖port − jax‖ /
  ‖jax − initial‖`` within 2e-1 (bf16) and 5e-4 (float32) over the
  elements whose second AdamW moment in the JAX run has ``sqrt(nu)`` >
  1e-7 (an RMS gradient of ~1e-6 over these 12 steps), at least 45 % of
  every leaf: measured 8.4e-2 and 1.0e-4.
  The rest are the inputs and outputs of saturated gelu units (the hop
  features are unnormalized, the targets ~17 log-units from a head with
  no bias warm start): their gradients are ~1e-9 in float32, near Adam's
  eps, and exactly 0 in JAX's bfloat16 autodiff of the tanh gelu where
  ``F.gelu``'s backward computes a small non-zero slope in float32, so
  Adam moves them by up to lr a step in one package and not the other
  (up to half of the head's second kernel at these widths).  A planted
  fault in the port — a skipped recycle (queued ids dropped, rows not
  reset) — must read above twice the limit on the embedding leaf, and
  reads 1.0;
- the wire adapter against the JAX Python adapter on one chunk sequence
  with an injected clock: id tables, feature sums and counts, overflow,
  evicted and recycled counts equal (the port's counterparts of the
  reference's five ``TestNodeLifecycle`` cases);
- within the port: a resume across a refresh boundary is byte-identical
  (``state_hash``).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models.hop import HopConfig as JHopConfig
from dragonfly2_tpu.trainer import online_graph as jog
from dragonfly2_tpu.trainer.train import TrainConfig as JTrainConfig
from dragonfly2_tpu_torch.models.gnn import load_flax_params
from dragonfly2_tpu_torch.models.hop import HopConfig
from dragonfly2_tpu_torch.records.columnar import ColumnarHeader, _encode_header
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS, TOPO_COLUMNS
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
from dragonfly2_tpu_torch.trainer import online_graph as tog
from dragonfly2_tpu_torch.trainer.train import TrainConfig

N_NODES = 128
HOP = dict(hidden=16, out_dim=8, node_embed_dim=4)
DTYPES = {"bf16": (jax.numpy.bfloat16, torch.bfloat16), "f32": (jax.numpy.float32, torch.float32)}
LOSS_RTOL = {"bf16": 5e-3, "f32": 1e-4}
MOVE_TOL = {"bf16": 2e-1, "f32": 5e-4}
GRAD_FLOOR = 1e-7          # sqrt(nu) of the elements the leaf moves hold
BASE = dict(
    num_nodes=N_NODES,
    max_neighbors=8,
    batch_size=256,
    super_steps=4,
    queue_capacity=16,  # tests feed the whole stream before run()
    total_steps_hint=1000,
)


def _mk_cluster(seed=0):
    return SyntheticCluster(num_hosts=N_NODES, seed=seed)


def _topo(cluster, seed):
    rng = np.random.default_rng(seed)
    n = N_NODES * 8
    src = rng.integers(0, N_NODES, n)
    dst = rng.integers(0, N_NODES, n)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # Deterministic rtt (no shared-rng draw) for replayable streams.
    return src, dst, (cluster._rtt_vec(src, dst, noise=False) / 1e9).astype(np.float32)


def _downloads(cluster, seed, n):
    rng = np.random.default_rng(seed)
    es = rng.integers(0, N_NODES, n).astype(np.int32)
    ed = (es + rng.integers(1, N_NODES, n).astype(np.int32)) % N_NODES
    y = np.log1p(cluster._bandwidth_vec(es, ed, rng=rng)).astype(np.float32)
    return es, ed, y


def _mk_trainer(cluster, tmp_path=None, *, dropout=0.1, **cfg_kw):
    """A port trainer on the CPU, bootstrapped as the reference test's,
    on the Python adapter unless ``native_ingest`` says otherwise."""
    cfg = tog.OnlineGraphConfig(
        **{**BASE, "native_ingest": False, "model": HopConfig(dropout=dropout, **HOP),
           "train": TrainConfig(warmup_steps=2), **cfg_kw}
    )
    src, dst, rtt = _topo(cluster, seed=1)
    return tog.OnlineGraphTrainer(
        cfg,
        node_feats=cluster._host_feature_matrix(),
        topo_src=src, topo_dst=dst, topo_rtt=rtt,
        checkpoint_dir=str(tmp_path) if tmp_path else None,
        device="cpu",
    )


def _pair(dtype="f32", *, bootstrap=None, **cfg_kw):
    """(JAX trainer, port trainer) with the same config, dropout 0, the
    port carrying flax's init.  ``bootstrap``: (node_feats, src, dst,
    rtt); empty topology and zero features when None."""
    jd, td = DTYPES[dtype]
    if bootstrap is None:
        bootstrap = (np.zeros((N_NODES, 12), np.float32), np.zeros(0, np.int32),
                     np.zeros(0, np.int32), np.zeros(0, np.float32))
    nf, src, dst, rtt = bootstrap
    kw = {**BASE, **cfg_kw}
    jt = jog.OnlineGraphTrainer(
        jog.OnlineGraphConfig(model=JHopConfig(dtype=jd, dropout=0.0, **HOP),
                              train=JTrainConfig(warmup_steps=2), native_ingest=False, **kw),
        node_feats=nf, topo_src=src, topo_dst=dst, topo_rtt=rtt,
    )
    tt = tog.OnlineGraphTrainer(
        tog.OnlineGraphConfig(model=HopConfig(dtype=td, dropout=0.0, **HOP),
                              train=TrainConfig(warmup_steps=2), native_ingest=False, **kw),
        node_feats=nf, topo_src=src, topo_dst=dst, topo_rtt=rtt, device="cpu",
    )
    load_flax_params(tt.state.model, jax.tree_util.tree_map(np.asarray, jt.state.params))
    return jt, tt


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v, np.float64)})
    return out


def _port_leaves(tt):
    """flax path → (param, mu, nu) as float64 numpy."""
    return {name: tuple(np.asarray(a.detach(), np.float64) for a in (p, m, v))
            for name, p, m, v in tog._leaves(tt.state)}


def _jax_leaves(jt):
    adam = jt.state.opt_state[1][0]
    params, mu, nu = (_flat(jax.tree_util.tree_map(np.asarray, t))
                      for t in (jt.state.params, adam.mu, adam.nu))
    return {k: (params[k], mu[k], nu[k]) for k in params}


def _rel(a, b, start, nu=None):
    """‖a − b‖ / ‖b − start‖ over the elements whose second moment
    ``nu`` (the JAX run's) is above ``GRAD_FLOOR``² (all when None)."""
    m = np.ones(a.shape, bool) if nu is None else np.sqrt(nu) > GRAD_FLOOR
    return float(np.linalg.norm((a - b)[m]) / max(np.linalg.norm((b - start)[m]), 1e-12))


def _topo_rows(cluster, seed, buckets):
    src, dst, rtt = _topo(cluster, seed)
    rows = np.zeros((len(src), len(TOPO_COLUMNS)), np.float32)
    rows[:, 0], rows[:, 1], rows[:, 2] = buckets[src], buckets[dst], rtt
    return rows


def _lifecycle_rows(src_b, dst_b, rng):
    n = len(src_b)
    rows = rng.random((n, len(DOWNLOAD_COLUMNS))).astype(np.float32)
    rows[:, 0] = src_b
    rows[:, 1] = dst_b
    rows[:, -1] = np.log1p(rng.random(n).astype(np.float32) * 50.0)
    return rows


# ---------------------------------------------------------------------------
# The snapshot
# ---------------------------------------------------------------------------


def test_snapshot_and_refresh_match_jax():
    cluster = _mk_cluster()
    src, dst, rtt = _topo(cluster, seed=1)
    jt, tt = _pair(bootstrap=(cluster._host_feature_matrix(), src, dst, rtt))
    for step in range(2):
        if step:
            cluster.drift(np.random.default_rng(7))
            for tr in (jt, tt):
                tr.set_node_features(cluster._host_feature_matrix())
                tr.feed_topology(*_topo(cluster, seed=9))
                assert tr.refresh_snapshot() is not None
        jt._ensure_snapshot()
        tt._ensure_snapshot()
        assert np.array_equal(np.asarray(jt.table.indices), tt.table.indices.numpy())
        assert np.array_equal(np.asarray(jt.table.mask), tt.table.mask.numpy())
        assert np.max(np.abs(np.asarray(jt.table.edge_feats) - tt.table.edge_feats.numpy())) <= 1e-5
        assert np.max(np.abs(np.asarray(jt.hop_feats) - tt.hop_feats.numpy())) <= 1e-5
        assert (tt.table.mask.numpy() == 0).any() and tt.snapshot_idx == jt.snapshot_idx == step


# ---------------------------------------------------------------------------
# The wire-fed run: losses, leaf moves, adapter state, planted fault
# ---------------------------------------------------------------------------


def _drive_wire(tr, ad, clock, data, snaps):
    """One chunk sequence through an adapter (either package): topology
    and downloads, a snapshot from the wire, 2 dispatches with a refresh
    after the second, a wave of new hosts that evicts all but two, then
    a dispatch on the new hosts (recycled ids)."""
    clock["now"] = 0.0
    ad.feed_topology_rows(data["topo0"])
    ad.feed_download_rows(data["dl0"])
    assert tr.refresh_snapshot() is not None
    clock["now"] = 1.0
    ad.feed_topology_rows(data["topo1"])
    assert tr.run(max_dispatches=2, idle_timeout=0.1) == 2
    snaps.append(tr.snapshot_idx)
    clock["now"] = 20.0
    ad.feed_topology_rows(data["warm"])
    clock["now"] = 25.0
    ad.feed_download_rows(data["dl1"])
    assert tr.run(max_dispatches=1, idle_timeout=0.1) == 1


def _wire_data():
    cluster = _mk_cluster()
    buckets = cluster._bucket_table()
    rng = np.random.default_rng(3)
    wave = np.arange(N_NODES - 2, dtype=np.int64) + 10_000
    src_b = wave[rng.integers(0, len(wave), 4 * 256)]
    dst_b = wave[(np.searchsorted(wave, src_b) + rng.integers(1, len(wave), len(src_b)))
                 % len(wave)]
    b0, b1 = int(buckets[0]), int(buckets[1])
    return {
        "topo0": _topo_rows(cluster, 1, buckets),
        "dl0": cluster.generate_feature_rows(2 * 4 * 256, seed=5),
        "topo1": _topo_rows(cluster, 2, buckets),
        "warm": np.array([[b0, b1, 0.01]], np.float32),
        "dl1": _lifecycle_rows(src_b, dst_b, rng),
    }


def _wire_run(tr, dtype_run=None, *, fault=None):
    """Drive one trainer (JAX or port) through ``_drive_wire``; → dict of
    its losses, leaves, adapter state and snapshot."""
    ad = tr.make_wire_adapter() if isinstance(tr, tog.OnlineGraphTrainer) else \
        jog.WireIngestAdapter(tr, use_native=False)
    clock = {"now": 0.0}
    ad.clock = lambda: clock["now"]
    losses = []
    if isinstance(tr, jog.OnlineGraphTrainer):
        fn = tr._dispatch_fn

        def capture(*args):
            out = fn(*args)
            losses.append(float(out[1]))
            return out

        tr._dispatch_fn = capture
        leaves = _jax_leaves
    else:
        run = tr._train_dispatch

        def capture(*args):
            out = run(*args)
            losses.append(float(out))
            return out

        tr._train_dispatch = capture
        if fault == "skipped_recycle":
            def skip():
                with tr._recycle_lock:
                    tr._pending_recycle = []
                return 0
            tr.apply_pending_recycles = skip
        leaves = _port_leaves
    start = leaves(tr)
    snaps = []
    _drive_wire(tr, ad, clock, _wire_data(), snaps)
    return {
        "losses": losses, "start": start, "end": leaves(tr), "snapshot_idx": snaps,
        "id_table": ad._id_table.copy(), "feat_sum": ad._feat_sum.copy(),
        "feat_cnt": ad._feat_cnt.copy(), "overflow": ad.overflow_edges,
        "evicted": ad.evicted_nodes, "recycled": tr.nodes_recycled,
        "hop_feats": np.asarray(tr.hop_feats if isinstance(tr, jog.OnlineGraphTrainer)
                                else tr.hop_feats.numpy()),
    }


@pytest.fixture(scope="module", params=["f32", "bf16"])
def wire_runs(request):
    dtype = request.param
    jt, tt = _pair(dtype, refresh_every=2, node_ttl=10.0)
    jres = _wire_run(jt)
    # The port's own start equals flax's init: it was carried in.
    return dtype, jres, _wire_run(tt)


def test_wire_fed_run_matches_jax(wire_runs):
    dtype, j, t = wire_runs
    assert len(j["losses"]) == len(t["losses"]) == 3
    rel = np.abs(np.array(t["losses"]) - j["losses"]) / np.abs(j["losses"])
    assert rel.max() <= LOSS_RTOL[dtype], (t["losses"], j["losses"])
    assert j["snapshot_idx"] == t["snapshot_idx"] == [2]
    # The adapter: one mapping, one feature stream, one lifecycle.
    assert np.array_equal(t["id_table"], j["id_table"])
    assert np.array_equal(t["feat_cnt"], j["feat_cnt"])
    assert np.max(np.abs(t["feat_sum"] - j["feat_sum"])) <= 1e-4
    assert (t["overflow"], t["evicted"], t["recycled"]) == \
        (j["overflow"], j["evicted"], j["recycled"]) == (0, N_NODES - 2, N_NODES - 2)
    assert np.max(np.abs(t["hop_feats"] - j["hop_feats"])) <= 1e-5
    for name, (p_j, mu_j, nu_j) in j["end"].items():
        p_t, mu_t, nu_t = t["end"][name]
        p0, mu0, nu0 = j["start"][name]
        assert (np.sqrt(nu_j) > GRAD_FLOOR).mean() >= 0.45, name
        assert _rel(p_t, p_j, p0, nu_j) <= MOVE_TOL[dtype], name
        if name.endswith("embedding"):
            assert _rel(mu_t, mu_j, mu0, nu_j) <= MOVE_TOL[dtype], name
            assert _rel(nu_t, nu_j, nu0, nu_j) <= MOVE_TOL[dtype], name


def test_wire_fed_run_planted_fault_reads_above_the_limit(wire_runs):
    """A skipped recycle keeps 126 evicted hosts' embedding rows and
    moments: the embedding leaf must read above twice the limit."""
    dtype, j, _ = wire_runs
    _, tt = _pair(dtype, refresh_every=2, node_ttl=10.0)
    t = _wire_run(tt, fault="skipped_recycle")
    name = "HopEncoder_0/Embed_0/embedding"
    reading = _rel(t["end"][name][0], j["end"][name][0], j["start"][name][0],
                   j["end"][name][2])
    assert reading > 2 * MOVE_TOL[dtype], reading
    assert t["recycled"] == 0


# ---------------------------------------------------------------------------
# The wire adapter: the reference's five node-lifecycle cases, both packages
# ---------------------------------------------------------------------------


def _twin(ttl):
    jt, tt = _pair(node_ttl=ttl)
    clock = {"now": 0.0}
    jad = jog.WireIngestAdapter(jt, use_native=False)
    tad = tt.make_wire_adapter()
    jad.clock = tad.clock = lambda: clock["now"]
    return jt, jad, tt, tad, clock


def _feed_both(jad, tad, kind, rows):
    getattr(jad, f"feed_{kind}_rows")(rows)
    getattr(tad, f"feed_{kind}_rows")(rows)


def _assert_adapters_equal(jt, jad, tt, tad):
    assert np.array_equal(tad._id_table, jad._id_table)
    assert np.array_equal(tad._bucket_of, jad._bucket_of)
    assert np.array_equal(tad._feat_cnt, jad._feat_cnt)
    assert np.max(np.abs(tad._feat_sum - jad._feat_sum)) <= 1e-4
    assert (tad._next_id, sorted(tad._free)) == (jad._next_id, sorted(jad._free))
    assert (tad.overflow_edges, tad.evicted_nodes, tt.nodes_recycled) == \
        (jad.overflow_edges, jad.evicted_nodes, jt.nodes_recycled)


def _embedding_rows(tt):
    return [a.detach().numpy() for name, p, m, v in tog._leaves(tt.state)
            if name.endswith("embedding") for a in (p, m, v)]


def test_lifecycle_churn_3x_capacity_recycles_like_jax():
    cluster = _mk_cluster()
    jt, jad, tt, tad, t = _twin(10.0)
    rng = np.random.default_rng(0)

    def phase_buckets(phase):
        return np.arange(N_NODES, dtype=np.int64) + 10_000 * (phase + 1)

    b = phase_buckets(0)
    for _ in range(3):
        _feed_both(jad, tad, "download", _lifecycle_rows(b, np.roll(b, 1), rng))
        t["now"] += 1.0
    assert tad._next_id == N_NODES and tad.overflow_edges == 0
    # Train the port so its embedding rows and moments are live.
    tt.feed_downloads(*_downloads(cluster, 5, 4 * 256 * 2))
    assert tt.run(max_dispatches=2, idle_timeout=0.1) == 2
    extra = np.array([999_999], dtype=np.int64)
    _feed_both(jad, tad, "download", _lifecycle_rows(extra, b[:1], rng))
    assert tad.overflow_edges == 1
    t["now"] = 20.0
    _feed_both(jad, tad, "topology", np.array([[10_000, 10_001, 0.01]], np.float32))
    survivors = [int(tad._id_table[10_000]), int(tad._id_table[10_001])]
    t["now"] = 25.0
    b1 = phase_buckets(1)[: N_NODES - 2]
    _feed_both(jad, tad, "download", _lifecycle_rows(b1, np.roll(b1, 1), rng))
    assert tad.evicted_nodes == N_NODES - 2 and tad.overflow_edges == 1
    assert tt.apply_pending_recycles() == jt.apply_pending_recycles() == N_NODES - 2
    evicted = np.ones(N_NODES, bool)
    evicted[survivors] = False
    for leaf in _embedding_rows(tt):
        assert not leaf[evicted].any(), "recycled row not reset"
        assert np.abs(leaf[survivors]).sum() > 0, "survivor row clobbered"
    t["now"] = 40.0
    _feed_both(jad, tad, "download", _lifecycle_rows(extra, phase_buckets(1)[:1], rng))
    assert int(tad._id_table[999_999]) >= 0 and tad.evicted_nodes >= N_NODES
    jt.apply_pending_recycles()
    tt.apply_pending_recycles()
    _assert_adapters_equal(jt, jad, tt, tad)


def test_lifecycle_ttl_zero_keeps_frozen_first_come_mapping_like_jax():
    jt, jad, tt, tad, t = _twin(0.0)
    rng = np.random.default_rng(1)
    b0 = np.arange(N_NODES, dtype=np.int64) + 10_000
    _feed_both(jad, tad, "download", _lifecycle_rows(b0, np.roll(b0, 1), rng))
    mapping = tad._id_table[b0].copy()
    t["now"] = 1e9
    _feed_both(jad, tad, "download",
               _lifecycle_rows(np.array([999_999], np.int64), b0[:1], rng))
    assert int(tad._id_table[999_999]) == -1 and tad.evicted_nodes == 0
    assert np.array_equal(tad._id_table[b0], mapping)
    assert tt.apply_pending_recycles() == jt.apply_pending_recycles() == 0
    _assert_adapters_equal(jt, jad, tt, tad)


def test_lifecycle_dropped_host_alone_reclaims_expired_capacity_like_jax():
    jt, jad, tt, tad, t = _twin(10.0)
    rng = np.random.default_rng(2)
    b0 = np.arange(N_NODES, dtype=np.int64) + 10_000
    _feed_both(jad, tad, "download", _lifecycle_rows(b0, np.roll(b0, 1), rng))
    x = np.array([777_777], dtype=np.int64)
    _feed_both(jad, tad, "download", _lifecycle_rows(x, b0[:1], rng))
    assert int(tad._id_table[777_777]) == -1
    t["now"] = 30.0
    _feed_both(jad, tad, "download", _lifecycle_rows(x, b0[:1], rng))
    assert int(tad._id_table[777_777]) >= 0 and tad.evicted_nodes > 0
    _assert_adapters_equal(jt, jad, tt, tad)


def test_lifecycle_returning_host_is_touched_not_evicted_like_jax():
    cluster = _mk_cluster()
    jt, jad, tt, tad, t = _twin(10.0)
    rng = np.random.default_rng(3)
    b0 = np.arange(N_NODES, dtype=np.int64) + 10_000
    _feed_both(jad, tad, "download", _lifecycle_rows(b0, np.roll(b0, 1), rng))
    tt.feed_downloads(*_downloads(cluster, 4, 4 * 256))
    assert tt.run(max_dispatches=1, idle_timeout=0.1) == 1
    h_id = int(tad._id_table[10_000])
    t["now"] = 30.0
    before = tad.overflow_edges
    _feed_both(jad, tad, "download",
               _lifecycle_rows(np.array([888_888], np.int64), b0[:1], rng))
    assert int(tad._id_table[10_000]) == h_id and int(tad._id_table[888_888]) >= 0
    assert tad.overflow_edges == before
    assert tt.apply_pending_recycles() == jt.apply_pending_recycles() > 0
    for leaf in _embedding_rows(tt)[:1]:
        assert np.abs(leaf[h_id]).sum() > 0, "live host row reset"
    _assert_adapters_equal(jt, jad, tt, tad)


def test_lifecycle_mapping_survives_checkpoint_resume(tmp_path):
    cluster = _mk_cluster()
    jt, jad, tt, tad, t = _twin(10.0)
    tt.checkpoint_dir = str(tmp_path)
    t["now"] = 1000.0
    rng = np.random.default_rng(4)
    b0 = np.arange(N_NODES, dtype=np.int64) + 10_000
    _feed_both(jad, tad, "download", _lifecycle_rows(b0, np.roll(b0, 1), rng))
    _assert_adapters_equal(jt, jad, tt, tad)
    mapping = tad._id_table[b0].copy()
    feat_cnt = tad._feat_cnt.copy()
    tt.checkpoint()

    tr2 = _mk_trainer(cluster, tmp_path, node_ttl=10.0)
    assert tr2.resume()
    ad2 = tr2.make_wire_adapter()
    ad2.clock = lambda: t["now"] + 1.0
    assert np.array_equal(ad2._id_table[b0], mapping) and ad2._next_id == N_NODES
    assert np.array_equal(ad2._feat_cnt, feat_cnt)
    ad2.feed_download_rows(_lifecycle_rows(b0[:4], b0[4:8], rng))
    assert np.array_equal(ad2._id_table[b0], mapping)


# ---------------------------------------------------------------------------
# Within the port (the reference's own cases, on the CPU)
# ---------------------------------------------------------------------------


def test_swap_changes_graph_not_optimizer():
    cluster = _mk_cluster()
    tr = _mk_trainer(cluster)
    tr.feed_downloads(*_downloads(cluster, 2, 4 * 256 * 2))
    assert tr.run(max_dispatches=2, idle_timeout=0.1) == 2
    hash_before, step_before = tog.state_hash(tr.state), tr.state.step
    gen_before = tr.state.generator.get_state()
    digest_before = tr.snapshot_digest()
    cluster.drift(np.random.default_rng(7))
    tr.set_node_features(cluster._host_feature_matrix())
    tr.feed_topology(*_topo(cluster, seed=9))
    assert tr.refresh_snapshot() is not None
    assert tr.snapshot_digest() != digest_before and tr.snapshot_idx == 1
    assert tog.state_hash(tr.state) == hash_before and tr.state.step == step_before
    assert torch.equal(tr.state.generator.get_state(), gen_before)
    tr.feed_downloads(*_downloads(cluster, 3, 4 * 256))
    assert tr.run(max_dispatches=1, idle_timeout=0.1) == 1
    assert tr.state.step == step_before + 4 and tr.state.opt.count == step_before + 4
    assert torch.isfinite(tr.last_loss) and tr.last_loss.ndim == 0


def test_refresh_with_no_new_topology_keeps_old_graph():
    cluster = _mk_cluster()
    tr = _mk_trainer(cluster, topo_window=100)
    digest = tr.snapshot_digest()
    assert tr.refresh_snapshot() is None
    assert tr.snapshot_digest() == digest and tr.snapshot_idx == 0
    tr.feed_topology(*_topo(cluster, seed=77))
    assert tr.refresh_snapshot() is not None and tr.snapshot_idx == 1


def test_topology_window_trims_oldest():
    cluster = _mk_cluster()
    tr = _mk_trainer(cluster, topo_window=500)
    for seed in range(5):
        tr.feed_topology(*_topo(cluster, seed=seed))
    src, _, _ = tr._drain_window()
    assert len(src) <= 500
    last_src, _, _ = _topo(cluster, seed=4)
    np.testing.assert_array_equal(src[-len(last_src):], last_src[-len(src):])


def test_byte_identical_resume_across_refresh_boundary(tmp_path):
    """Checkpoint after a swap, resume in a fresh trainer, continue →
    the same bytes as the uninterrupted run (dropout on: the generator's
    state travels with the checkpoint)."""
    def feed_all(tr, cluster):
        tr.feed_topology(*_topo(cluster, seed=100))
        for d in range(4):
            tr.feed_downloads(*_downloads(cluster, 50 + d, 4 * 256))

    ca = _mk_cluster()
    a = _mk_trainer(ca, tmp_path / "a", refresh_every=2)
    feed_all(a, ca)
    assert a.run(max_dispatches=4, idle_timeout=0.1) == 4 and a.snapshot_idx >= 1

    cb = _mk_cluster()
    b = _mk_trainer(cb, tmp_path / "b", refresh_every=2)
    feed_all(b, cb)
    assert b.run(max_dispatches=3, idle_timeout=0.1) == 3 and b.snapshot_idx >= 1
    b.checkpoint()
    del b

    cc = _mk_cluster()
    c = _mk_trainer(cc, tmp_path / "b", refresh_every=2)
    assert c.resume()
    assert c.dispatch == 3 and c.snapshot_idx >= 1
    assert c.snapshot_digest() == a.snapshot_digest()
    c.feed_downloads(*_downloads(cc, 53, 4 * 256))
    assert c.run(max_dispatches=1, idle_timeout=0.1) == 1
    assert tog.state_hash(c.state) == tog.state_hash(a.state)


def test_resume_without_checkpoint_returns_false(tmp_path):
    assert not _mk_trainer(_mk_cluster(), tmp_path / "none").resume()


def test_deterministic_embedding_gather_has_index_selects_gradient():
    """``Embed``'s sorted backward changes the order of ``index_select``'s
    sums, not their value."""
    from dragonfly2_tpu_torch.models.hop import Embed

    emb = Embed(50, 4, torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 50, 400))
    g = torch.randn(400, 4, generator=torch.Generator().manual_seed(1))
    grads = [torch.autograd.grad((out * g).sum(), emb.embedding)[0]
             for out in (emb.embedding.index_select(0, ids), emb(ids))]
    assert torch.allclose(grads[0], grads[1], atol=1e-5, rtol=0)
    assert grads[0].abs().sum() > 0


def _dfc(columns, rows):
    return _encode_header(ColumnarHeader(columns=columns)) + rows.tobytes()


def test_train_stream_feeds_online_trainer(tmp_path):
    """DFC1 chunks through ``TrainerService.receive_shard_bytes`` →
    ``_feed_online`` → the adapter → the trainer: a dispatch runs and the
    wire-fed topology builds the next snapshot."""
    from dragonfly2_tpu_torch.trainer.service import TrainerService

    cluster = _mk_cluster()
    tr = _mk_trainer(cluster, native_ingest=True)  # the default engine
    adapter = tr.make_wire_adapter()
    assert adapter.is_native
    service = TrainerService(data_dir=str(tmp_path / "stage"), online_sink=adapter,
                             device="cpu")
    session = service.open_train_stream(ip="10.0.0.7", hostname="wire-online",
                                        scheduler_id="s")
    dl = _dfc(DOWNLOAD_COLUMNS, cluster.generate_feature_rows(4 * 256 * 3, seed=5))
    # Chunks that split rows: the decoder reassembles each row once.
    for seq, at in enumerate(range(0, len(dl), 50_001)):
        service.receive_shard_bytes(session, "download", "dl.dfc", dl[at:at + 50_001], seq=seq)
    topo = _topo_rows(cluster, 8, cluster._bucket_table())
    service.receive_shard_bytes(session, "networktopology", "topo.dfc",
                                _dfc(TOPO_COLUMNS, topo), seq=0)
    assert adapter.overflow_edges == 0
    assert tr.run(max_dispatches=2, idle_timeout=0.5) == 2
    assert tr.records_seen == 2 * 4 * 256
    digest = tr.snapshot_digest()
    assert tr.refresh_snapshot() is not None and tr.snapshot_digest() != digest
    assert len(session.download_shards) == 1 and len(session.topology_shards) == 1


class _Sink:
    def __init__(self):
        self.download_rows = 0
        self.topology_rows = 0

    def feed_download_rows(self, rows):
        self.download_rows += len(rows)

    def feed_topology_rows(self, rows):
        self.topology_rows += len(rows)


def test_reconnect_resend_feeds_rows_once(tmp_path):
    from dragonfly2_tpu_torch.trainer.service import TrainerService

    sink = _Sink()
    service = TrainerService(data_dir=str(tmp_path / "stage"), online_sink=sink, device="cpu")
    rng = np.random.default_rng(0)
    blob = _dfc(DOWNLOAD_COLUMNS, rng.random((100, len(DOWNLOAD_COLUMNS))).astype(np.float32))
    for _ in range(2):  # a reconnect: fresh session, the same shard from scratch
        s = service.open_train_stream(ip="1.2.3.4", hostname="h", scheduler_id="s")
        service.receive_shard_bytes(s, "download", "d.dfc", blob, seq=0)
        assert sink.download_rows == 100
    rows = np.random.default_rng(0).random((130, len(DOWNLOAD_COLUMNS))).astype(np.float32)
    s3 = service.open_train_stream(ip="1.2.3.4", hostname="h", scheduler_id="s")
    service.receive_shard_bytes(s3, "download", "d.dfc", _dfc(DOWNLOAD_COLUMNS, rows), seq=0)
    assert sink.download_rows == 130


def test_online_mode_tolerates_reference_csv(tmp_path):
    from dragonfly2_tpu_torch.trainer.service import TrainerService

    class Sink:
        def feed_download_rows(self, rows):
            raise AssertionError("CSV must not online-decode")

        feed_topology_rows = feed_download_rows

    service = TrainerService(data_dir=str(tmp_path / "stage"), online_sink=Sink(), device="cpu")
    s = service.open_train_stream(ip="1.2.3.4", hostname="h", scheduler_id="s")
    service.receive_shard_bytes(s, "download", "legacy.csv", b"a,b,c\n1,2,3\n", seq=0)
    assert len(s.download_shards) == 1


# ---------------------------------------------------------------------------
# Paths not ported, and configurations that cannot run, refuse loudly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw, exc, match",
    [
        (dict(native_ingest=True), NotImplementedError, "item 14"),
        (dict(mesh=object()), ValueError, "create_mesh"),
        (dict(node_sharding="model"), ValueError, "needs a mesh"),
        (dict(node_sharding="bogus"), ValueError, "unknown node_sharding"),
    ],
)
def test_unported_paths_refuse(kw, exc, match):
    if kw == dict(native_ingest=True):
        # Ported (the native oi_* engine): what raised now builds a
        # trainer whose wire adapter runs the engine.
        tr = _mk_trainer(_mk_cluster(), **kw)
        assert tr.config.native_ingest and tr.make_wire_adapter().is_native
        return
    with pytest.raises(exc, match=match):
        _mk_trainer(_mk_cluster(), **kw)


def test_native_adapter_refuses():
    """Ported: ``use_native=True`` runs the port's native engine, and the
    trainer takes its blocks from the engine's edge ring."""
    tr = _mk_trainer(_mk_cluster())
    ad = tog.WireIngestAdapter(tr, use_native=True)
    assert ad.is_native and tr.block_source is not None
    tr.close()
    assert not ad.is_native and tr.block_source is None


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tog.OnlineGraphConfig(num_nodes=8, model=HopConfig(**HOP))
    with pytest.raises(RuntimeError, match="cuda"):
        tog.OnlineGraphTrainer(cfg, node_feats=np.zeros((8, 12), np.float32),
                               topo_src=np.zeros(0), topo_dst=np.zeros(0),
                               topo_rtt=np.zeros(0))
