"""Port parity: the port's native online-ingest engine (``oi_*`` in the
port's own ``native/src/native.cpp``, behind
``trainer.online_graph.WireIngestAdapter``).

- The port's ``NativeOnlineIngest`` and the JAX package's are fed the same
  seeded rows and clocks (with TTL churn): their id mapping, dispatch
  edges, feature means, recycled ids, counters and exported state are
  exactly equal — both are built from the same source.
- The port's native adapter against its own Python adapter, the spec
  (the cases of ``tests/test_native_ingest.py``): the same mapping,
  blocks, features and counters, and the reference's one stated
  divergence — the engine folds every kept row into the feature means,
  where the Python path samples ``FEATURE_SAMPLE_ROWS`` rows a feed.
- Dispatch blocks from ``trainer.block_source`` train and the counts add
  up; a full edge ring blocks the feeder until a block is taken; a
  checkpoint written on either engine resumes on the other.

The library is built here (no skip).
"""

import threading

import numpy as np
import pytest

from dragonfly2_tpu import native as j_native
from dragonfly2_tpu_torch import native as t_native
from dragonfly2_tpu_torch.models.hop import HopConfig
from dragonfly2_tpu_torch.records.features import (
    DOWNLOAD_COLUMNS,
    HOST_FEATURE_DIM,
    NUM_HASH_BUCKETS,
)
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
from dragonfly2_tpu_torch.trainer.online_graph import OnlineGraphConfig, OnlineGraphTrainer
from dragonfly2_tpu_torch.trainer.train import TrainConfig

N = 64


def _mk(native: bool, ttl: float = 0.0, **kw):
    cluster = SyntheticCluster(num_hosts=N, seed=0)
    rng = np.random.default_rng(1)
    src = rng.integers(0, N, N * 4)
    dst = (src + 1 + rng.integers(0, N - 1, N * 4)) % N
    defaults = dict(
        num_nodes=N,
        max_neighbors=8,
        batch_size=128,
        super_steps=2,
        queue_capacity=16,
        node_ttl=ttl,
        native_ingest=native,
        model=HopConfig(hidden=16, out_dim=8, node_embed_dim=4, dropout=0.0),
        train=TrainConfig(warmup_steps=2),
        total_steps_hint=500,
    )
    ckpt = kw.pop("checkpoint_dir", None)
    defaults.update(kw)
    tr = OnlineGraphTrainer(
        OnlineGraphConfig(**defaults),
        node_feats=cluster._host_feature_matrix(),
        topo_src=src, topo_dst=dst,
        topo_rtt=(cluster._rtt_vec(src, dst, noise=False) / 1e9).astype(np.float32),
        checkpoint_dir=ckpt,
        device="cpu",
    )
    ad = tr.make_wire_adapter()
    t = {"now": 1000.0}
    ad.clock = lambda: t["now"]
    return tr, ad, t


def _lookup(ad, buckets):
    return np.asarray(ad.map_known(np.asarray(buckets)), np.int32)


def _rows(src_b, dst_b, rng):
    n = len(src_b)
    rows = rng.random((n, len(DOWNLOAD_COLUMNS))).astype(np.float32)
    rows[:, 0] = src_b
    rows[:, 1] = dst_b
    rows[:, -1] = np.log1p(rng.random(n).astype(np.float32) * 50.0)
    return rows


def _chunks(seed, n_chunks=8, n=96, hi=80):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_chunks):
        sb = rng.integers(0, hi, n)
        db = rng.integers(0, hi, n)
        keep = sb != db
        out.append(_rows(sb[keep], db[keep], rng))
    return out


def test_default_adapter_runs_the_port_engine():
    tr, ad, _ = _mk(True)
    assert OnlineGraphConfig(num_nodes=N).native_ingest is True
    assert ad.is_native and isinstance(ad._native, t_native.NativeOnlineIngest)
    assert tr.block_source is not None
    tr.close()
    assert not ad.is_native and tr.block_source is None


class TestEngineParityWithJax:
    """The two packages' engines, driven directly with one stream."""

    @pytest.mark.parametrize("ttl", [0.0, 10.0], ids=["frozen", "ttl"])
    def test_mapping_edges_features_state_equal(self, ttl):
        n_nodes, ring = 48, 4096
        engines = {
            name: mod.NativeOnlineIngest(n_nodes, NUM_HASH_BUCKETS, HOST_FEATURE_DIM,
                                         len(DOWNLOAD_COLUMNS), ttl, ring)
            for name, mod in (("jax", j_native), ("torch", t_native))
        }
        rng = np.random.default_rng(21)
        pool = rng.integers(0, 200_000, 160)  # more hosts than ids: overflow / churn
        recycled = {name: [] for name in engines}
        edges = {name: [] for name in engines}
        for step in range(12):
            now = 1000.0 + 7.0 * step
            sb, db = rng.choice(pool, 80), rng.choice(pool, 80)
            keep = sb != db
            rows = _rows(sb[keep], db[keep], rng)
            kept = {name: e.feed_download_rows(rows.copy(), now, block=True)
                    for name, e in engines.items()}
            assert kept["jax"] == kept["torch"]
            for name, e in engines.items():
                recycled[name].append(e.take_recycled())
                got = e.take_edges(64, 0.0)
                edges[name].append(None if got is None else np.concatenate(
                    [got[0], got[1], got[2].view(np.int32)]))
        j, t = engines["jax"], engines["torch"]
        assert j.stats() == t.stats()
        probe = np.concatenate([pool, [7, 11, NUM_HASH_BUCKETS - 1]]).astype(np.float32)
        np.testing.assert_array_equal(j.lookup(probe), t.lookup(probe))
        np.testing.assert_array_equal(j.node_features(), t.node_features())
        for a, b in zip(recycled["jax"], recycled["torch"]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(edges["jax"], edges["torch"]):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        sj, st = j.export_state(), t.export_state()
        assert sj.keys() == st.keys()
        for k in sj:
            np.testing.assert_array_equal(np.asarray(sj[k]), np.asarray(st[k]), err_msg=k)
        if ttl:
            assert t.stats()["evicted_nodes"] > 0
        for e in engines.values():
            e.close()


class TestParityWithSpec:
    def test_mapping_edges_features_match_python_spec(self):
        """Same stream → identical id mapping, identical dispatch
        blocks, identical feature means, identical counters."""
        tr_py, ad_py, t_py = _mk(False)
        tr_nat, ad_nat, t_nat = _mk(True)
        assert ad_nat.is_native and not ad_py.is_native
        chunks = _chunks(7)
        for c in chunks:
            ad_py.feed_download_rows(c.copy())
            ad_nat.feed_download_rows(c.copy())
        all_buckets = np.unique(np.concatenate([c[:, :2].ravel() for c in chunks]))
        np.testing.assert_array_equal(_lookup(ad_py, all_buckets), _lookup(ad_nat, all_buckets))
        assert ad_py.overflow_edges == ad_nat.overflow_edges > 0
        np.testing.assert_allclose(ad_py.node_features(), ad_nat.node_features(), rtol=1e-6)
        b_py = tr_py._next_dispatch_block(timeout=1.0)
        b_nat = tr_nat._next_dispatch_block(timeout=1.0)
        assert b_py is not None and b_nat is not None
        for a, b in zip(b_py, b_nat):
            np.testing.assert_array_equal(a, b)

    def test_the_engine_folds_every_row_into_the_means(self):
        """The reference's divergence: with ``FEATURE_SAMPLE_ROWS`` below
        a chunk, the Python path averages the first rows of each feed and
        the engine every kept row — the engine's means equal a Python
        adapter's that samples nothing away; mapping and edges agree."""
        tr_nat, ad_nat, _ = _mk(True)
        tr_all, ad_all, _ = _mk(False)
        tr_smp, ad_smp, _ = _mk(False)
        ad_smp.FEATURE_SAMPLE_ROWS = 16
        chunks = _chunks(8)
        assert all(len(c) > 16 for c in chunks)
        for c in chunks:
            for ad in (ad_nat, ad_all, ad_smp):
                ad.feed_download_rows(c.copy())
        np.testing.assert_allclose(ad_nat.node_features(), ad_all.node_features(), rtol=1e-6)
        assert not np.allclose(ad_nat.node_features(), ad_smp.node_features(), rtol=1e-3)
        buckets = np.unique(np.concatenate([c[:, :2].ravel() for c in chunks]))
        np.testing.assert_array_equal(_lookup(ad_nat, buckets), _lookup(ad_smp, buckets))
        for a, b in zip(tr_nat._next_dispatch_block(timeout=1.0),
                        tr_smp._next_dispatch_block(timeout=1.0)):
            np.testing.assert_array_equal(a, b)

    def test_churn_parity_with_injected_clocks(self):
        """TTL eviction: same clocks → same evictions, same recycled id
        sets, same post-churn mapping on both engines."""
        tr_py, ad_py, t_py = _mk(False, ttl=10.0)
        tr_nat, ad_nat, t_nat = _mk(True, ttl=10.0)
        rng1, rng2 = (np.random.default_rng(3) for _ in range(2))
        for phase in range(3):
            b = np.arange(N, dtype=np.int64) + 10_000 * (phase + 1)
            for ad, t, rng in ((ad_py, t_py, rng1), (ad_nat, t_nat, rng2)):
                t["now"] = 1000.0 + phase * 40.0
                ad.feed_download_rows(_rows(b, np.roll(b, 1), rng))
            assert ad_py.evicted_nodes == ad_nat.evicted_nodes == phase * N
            np.testing.assert_array_equal(_lookup(ad_py, b), _lookup(ad_nat, b))
        assert ad_py.overflow_edges == ad_nat.overflow_edges == 0
        n_py = tr_py.apply_pending_recycles()
        n_nat = tr_nat.apply_pending_recycles()
        assert n_py == n_nat == N
        assert tr_py.nodes_recycled == tr_nat.nodes_recycled


class TestNativeTraining:
    def test_block_source_trains_and_counts(self):
        """Dispatch blocks come straight from the C++ ring: the trainer
        runs, records count, loss is finite, EOF ends the run."""
        tr, ad, t = _mk(True)
        rng = np.random.default_rng(5)
        need = 2 * 128  # super_steps * batch
        b = np.arange(N, dtype=np.int64) + 10_000
        fed = 0
        while fed < 3 * need:
            sb = rng.choice(b, 256)
            db = rng.choice(b, 256)
            keep = sb != db
            fed += int(keep.sum())
            ad.feed_download_rows(_rows(sb[keep], db[keep], rng))
        assert tr.run(max_dispatches=3, idle_timeout=2.0) == 3
        assert tr.records_seen == 3 * need
        assert ad.native_stats()["rows_in"] == fed
        assert np.isfinite(float(tr.last_loss))
        tr.end_of_stream()
        assert tr.run(max_dispatches=1, idle_timeout=0.5) == 0  # EOF drains
        v = tr.eval_mae(
            rng.integers(0, N, 128), rng.integers(0, N, 128),
            rng.random(128).astype(np.float32),
        )
        assert np.isfinite(v)

    def test_feed_downloads_rejected_with_native_adapter(self):
        tr, ad, _ = _mk(True)
        with pytest.raises(RuntimeError, match="wire adapter"):
            tr.feed_downloads(
                np.zeros(4, np.int32), np.ones(4, np.int32),
                np.zeros(4, np.float32),
            )

    def test_backpressure_blocks_until_taken(self):
        """A full edge ring blocks the feeder (wire backpressure) until
        the trainer takes a block."""
        tr, ad, t = _mk(True, queue_capacity=1, super_steps=1, batch_size=64)
        rng = np.random.default_rng(9)
        b = np.arange(N, dtype=np.int64) + 10_000
        ring_cap = 2 * 64  # max(queue_capacity, 2) * super * batch
        done = threading.Event()

        def feeder():
            fed = 0
            while fed < ring_cap + 64:  # one block beyond capacity
                sb, db = rng.choice(b, 64), rng.choice(b, 64)
                keep = sb != db
                fed += int(keep.sum())
                ad.feed_download_rows(_rows(sb[keep], db[keep], rng))
            done.set()

        th = threading.Thread(target=feeder, daemon=True)
        th.start()
        assert not done.wait(0.5), "feeder never blocked on the full ring"
        assert tr.run(max_dispatches=2, idle_timeout=5.0) == 2
        assert done.wait(5.0), "feeder did not resume after space freed"
        th.join(5.0)


class TestCheckpointInterop:
    def test_native_checkpoint_restores_into_python_and_back(self, tmp_path):
        """The adapter state format is engine-agnostic: a mapping built
        natively restores into the python adapter (and back) with ids,
        free pool and feature accumulators intact."""
        rng = np.random.default_rng(11)
        b = np.arange(N, dtype=np.int64) + 10_000

        tr1, ad1, t1 = _mk(True, ttl=10.0, checkpoint_dir=str(tmp_path))
        ad1.feed_download_rows(_rows(b, np.roll(b, 1), rng))
        mapping = _lookup(ad1, b)
        feats = ad1.node_features()
        tr1.checkpoint()

        tr2, ad2, t2 = _mk(False, ttl=10.0, checkpoint_dir=str(tmp_path))
        assert tr2.resume()
        np.testing.assert_array_equal(_lookup(ad2, b), mapping)
        np.testing.assert_allclose(ad2.node_features(), feats, rtol=1e-6)
        tr2.checkpoint()

        tr3, ad3, t3 = _mk(True, ttl=10.0, checkpoint_dir=str(tmp_path))
        assert tr3.resume()
        np.testing.assert_array_equal(_lookup(ad3, b), mapping)
        np.testing.assert_allclose(ad3.node_features(), feats, rtol=1e-6)
        assert ad3.native_stats()["next_id"] == N
