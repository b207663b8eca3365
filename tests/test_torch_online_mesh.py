"""The online graph trainer on a mesh, ``dragonfly2_tpu_torch/trainer/
online_graph.py`` with ``OnlineGraphConfig(mesh=…)``: the port's
counterparts of ``tests/test_online_graph.py``'s ``TestOnlineMeshMode``.

The mesh runs as 4 spawned gloo ranks on the CPU, a (2 data × 2 model)
mesh (``parallel.dryrun.run_ranks``: one spawn for the module, a
``FileStore`` in a fresh temporary directory).  Rank 0 is the one feeder:
only it is handed downloads and topology after the bootstrap, directly
or through its wire adapter (on the native ingest engine, the default,
and on the Python path: the same rows train the same state).  The
one-device runs are the port's own, in the test process, at the
reference test's sizes (128 nodes, K 8, batch 256, 4 steps a dispatch,
``HopConfig(hidden=16, out_dim=8, node_embed_dim=4)``).  The JAX online
trainer's mesh mode is not run here: the step it scans is
``_graph_train_step``, held to the JAX trainers on a (2 × 2) mesh in
``tests/test_torch_multidevice_train.py``, and the one-device online
trainer is held to the JAX one in ``tests/test_torch_online_graph.py``.

Tolerances, stated:
- node-sharded mesh against one device: validation MAE within 5e-3 (the
  reference's), dropout 0.1 (the reference test's: each data rank keeps
  its columns of the one mask of a step's global batch);
  each snapshot's hop table within 1e-5 absolute (the halo precompute
  sums in another order);
- resumes: ``state_hash`` equal (byte identity), across a refresh on the
  mesh, and across a mesh checkpoint resumed on one device and the
  reverse.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.models.hop import HopConfig
from dragonfly2_tpu_torch.parallel import mesh as tpm
from dragonfly2_tpu_torch.parallel.dryrun import run_ranks
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
from dragonfly2_tpu_torch.trainer import online_graph as tog
from dragonfly2_tpu_torch.trainer.train import TrainConfig

N_NODES = 128
HOP = dict(hidden=16, out_dim=8, node_embed_dim=4, dropout=0.1)
BASE = dict(num_nodes=N_NODES, max_neighbors=8, batch_size=256, super_steps=4,
            queue_capacity=16, total_steps_hint=1000)


def _mk_cluster(seed=0):
    return SyntheticCluster(num_hosts=N_NODES, seed=seed)


def _topo(cluster, seed):
    rng = np.random.default_rng(seed)
    n = N_NODES * 8
    src = rng.integers(0, N_NODES, n)
    dst = rng.integers(0, N_NODES, n)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return src, dst, (cluster._rtt_vec(src, dst, noise=False) / 1e9).astype(np.float32)


def _downloads(cluster, seed, n):
    rng = np.random.default_rng(seed)
    es = rng.integers(0, N_NODES, n).astype(np.int32)
    ed = (es + rng.integers(1, N_NODES, n).astype(np.int32)) % N_NODES
    y = np.log1p(cluster._bandwidth_vec(es, ed, rng=rng)).astype(np.float32)
    return es, ed, y


def _mk_trainer(cluster, ckpt=None, *, mesh=None, **cfg_kw):
    """A trainer bootstrapped as the reference test's: on ``mesh`` node-
    sharded, else on the CPU."""
    kw = dict(mesh=mesh, node_sharding="model") if mesh is not None else {}
    cfg = tog.OnlineGraphConfig(**{**BASE, "model": HopConfig(**HOP),
                                   "train": TrainConfig(warmup_steps=2), **kw, **cfg_kw})
    src, dst, rtt = _topo(cluster, seed=1)
    return tog.OnlineGraphTrainer(
        cfg, node_feats=cluster._host_feature_matrix(), topo_src=src, topo_dst=dst,
        topo_rtt=rtt, checkpoint_dir=str(ckpt) if ckpt else None, device="cpu")


def _feed_resume(tr, cl, feeder):
    if feeder:
        tr.feed_topology(*_topo(cl, seed=100))
        for d in range(3):
            tr.feed_downloads(*_downloads(cl, 60 + d, 4 * 256))


def _one_device(root):
    """The one-device runs: the swap run's MAE and hop tables, and a
    checkpoint for the mesh to resume."""
    cl = _mk_cluster()
    tr = _mk_trainer(cl)
    tr.feed_downloads(*_downloads(cl, 7, 4 * 256 * 2))
    assert tr.run(max_dispatches=2, idle_timeout=0.1) == 2
    out = {"mae": tr.eval_mae(*_downloads(cl, 99, 1024)),
           "hop0": tr.hop_feats.numpy().copy()}
    cl.drift(np.random.default_rng(3))
    tr.set_node_features(cl._host_feature_matrix())
    tr.feed_topology(*_topo(cl, seed=31))
    assert tr.refresh_snapshot() is not None
    out["hop1"] = tr.hop_feats.numpy().copy()
    cs = _mk_cluster()
    single = _mk_trainer(cs, root / "single", refresh_every=2)
    _feed_resume(single, cs, True)
    assert single.run(max_dispatches=2, idle_timeout=0.1) == 2
    single.checkpoint()
    out["single_hash"] = tog.state_hash(single.state)
    return out


def _rank_body(rank, dev, root):
    mesh = tpm.create_mesh(tpm.MeshSpec(data=2, model=2), device=dev)
    feeder = rank == 0
    out = {"rank": rank, "coord": mesh.coord(tpm.MODEL_AXIS)}

    # Against one device, then a snapshot swap on the mesh.
    cl = _mk_cluster()
    tr = _mk_trainer(cl, mesh=mesh)
    if feeder:
        tr.feed_downloads(*_downloads(cl, 7, 4 * 256 * 2))
    out["ran"] = tr.run(max_dispatches=2, idle_timeout=0.1)
    out["mae"] = tr.eval_mae(*_downloads(cl, 99, 1024)) if feeder else tr.eval_mae(None, None,
                                                                                    None)
    out["records_seen"] = tr.records_seen
    out["hash"] = tog.state_hash(tr.state)
    out["hop0"] = tr.hop_feats.numpy().copy()
    cl.drift(np.random.default_rng(3))
    if feeder:
        tr.set_node_features(cl._host_feature_matrix())
        tr.feed_topology(*_topo(cl, seed=31))
    out["swap"] = tr.refresh_snapshot()
    out["hop1"] = tr.hop_feats.numpy().copy()
    if feeder:
        tr.feed_downloads(*_downloads(cl, 8, 4 * 256))
    out["ran_after_swap"] = tr.run(max_dispatches=1, idle_timeout=0.1)
    out["snapshot_idx"] = tr.snapshot_idx
    try:
        tr.make_wire_adapter()
        out["adapter"] = "made"
    except ValueError as e:
        out["adapter"] = str(e)

    # Resume across a refresh: a runs 3 dispatches; b runs 2 and
    # checkpoints; c resumes b's checkpoint and runs the third.
    ca = _mk_cluster()
    a = _mk_trainer(ca, root / "a", mesh=mesh, refresh_every=2)
    _feed_resume(a, ca, feeder)
    out["ran_a"] = a.run(max_dispatches=3, idle_timeout=0.1)
    out["snapshot_a"] = a.snapshot_idx
    out["hash_a"] = tog.state_hash(a.state)
    cb = _mk_cluster()
    b = _mk_trainer(cb, root / "b", mesh=mesh, refresh_every=2)
    _feed_resume(b, cb, feeder)
    out["ran_b"] = b.run(max_dispatches=2, idle_timeout=0.1)
    b.checkpoint()
    out["hash_b"] = tog.state_hash(b.state)
    del b
    cc = _mk_cluster()
    c = _mk_trainer(cc, root / "b", mesh=mesh, refresh_every=2)
    out["resumed_c"] = c.resume()
    out["dispatch_c"] = (c.dispatch, c.snapshot_idx)
    if feeder:
        c.feed_downloads(*_downloads(cc, 62, 4 * 256))
    out["ran_c"] = c.run(max_dispatches=1, idle_timeout=0.1)
    out["hash_c"] = tog.state_hash(c.state)

    # One device's checkpoint resumed on the mesh.
    cs = _mk_cluster()
    s = _mk_trainer(cs, root / "single", mesh=mesh, refresh_every=2)
    out["resumed_single"] = s.resume()
    out["hash_single"] = tog.state_hash(s.state)

    # Rank 0 feeds through the wire adapter, on the native engine and on
    # the Python path: the same rows give the same blocks, broadcast.
    for engine in ("native", "python"):
        cw = _mk_cluster()
        w = _mk_trainer(cw, mesh=mesh, native_ingest=engine == "native")
        if feeder:
            ad = w.make_wire_adapter()
            out[f"wire_{engine}_is_native"] = ad.is_native
            ad.feed_download_rows(cw.generate_feature_rows(4 * 256 + 100, seed=17))
        out[f"wire_{engine}_ran"] = w.run(max_dispatches=1, idle_timeout=0.5)
        out[f"wire_{engine}_hash"] = tog.state_hash(w.state)
        w.close()

    # Configurations the mesh refuses.
    out["refusals"] = []
    for kw in (dict(num_nodes=N_NODES + 1), dict(batch_size=255)):
        try:
            _mk_trainer(_mk_cluster(), mesh=mesh, **kw)
            out["refusals"].append("accepted")
        except ValueError as e:
            out["refusals"].append(str(e))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("online_mesh")
    one = _one_device(root)
    ranks = run_ranks(_rank_body, 4, device="cpu", args=(root,))
    return one, ranks, root


def test_mesh_matches_one_device(runs):
    one, ranks, _ = runs
    for r in ranks:
        assert r["ran"] == 2
        assert abs(r["mae"] - one["mae"]) < 5e-3, (r["mae"], one["mae"])
        assert r["mae"] == ranks[0]["mae"]


def test_snapshot_swap_on_the_mesh(runs):
    one, ranks, _ = runs
    S = N_NODES // 2
    for r in ranks:
        assert r["swap"] is not None and r["swap"] == ranks[0]["swap"]
        assert r["ran_after_swap"] == 1 and r["snapshot_idx"] == 1
        c = r["coord"]
        for key in ("hop0", "hop1"):
            assert r[key].shape == (S, one[key].shape[1])
            assert np.max(np.abs(r[key] - one[key][c * S:(c + 1) * S])) <= 1e-5


def test_mesh_resume_across_refresh(runs):
    _, ranks, _ = runs
    for r in ranks:
        assert (r["ran_a"], r["ran_b"], r["ran_c"]) == (3, 2, 1)
        assert r["snapshot_a"] >= 1
        assert r["resumed_c"] and r["dispatch_c"][0] == 2 and r["dispatch_c"][1] >= 1
        assert r["hash_c"] == r["hash_a"] == ranks[0]["hash_a"]


def test_mesh_checkpoint_resumes_on_one_device(runs):
    _, ranks, root = runs
    cl = _mk_cluster()
    tr = _mk_trainer(cl, root / "b", refresh_every=2)
    assert tr.resume()
    assert tog.state_hash(tr.state) == ranks[0]["hash_b"]
    # ... and trains on from it.
    tr.feed_downloads(*_downloads(cl, 62, 4 * 256))
    assert tr.run(max_dispatches=1, idle_timeout=0.1) == 1


def test_one_device_checkpoint_resumes_on_the_mesh(runs):
    one, ranks, _ = runs
    for r in ranks:
        assert r["resumed_single"] and r["hash_single"] == one["single_hash"]


def test_only_rank_zero_feeds(runs):
    _, ranks, _ = runs
    for r in ranks:
        assert r["records_seen"] == 2 * 4 * 256
        assert r["hash"] == ranks[0]["hash"]
    assert ranks[0]["adapter"] == "made"
    assert all("rank 0 feeds" in r["adapter"] for r in ranks[1:])


def test_bad_configs_refuse(runs):
    _, ranks, _ = runs
    for r in ranks:
        assert all("not divisible" in msg for msg in r["refusals"]), r["refusals"]
    cl = _mk_cluster()
    with pytest.raises(ValueError, match="needs a mesh"):
        _mk_trainer(cl, node_sharding="model")
    with pytest.raises(ValueError, match="unknown node_sharding"):
        _mk_trainer(cl, node_sharding="bogus")
    with pytest.raises(ValueError, match="create_mesh"):
        _mk_trainer(cl, mesh=object())
    assert os.path.isdir(runs[2])


def test_rank_zero_feeds_from_the_native_engine(runs):
    """On a mesh the one feeder's wire adapter runs the native ingest
    engine (the default): its block is broadcast, every rank trains it,
    and the state equals the Python adapter's on the same rows."""
    _, ranks, _ = runs
    assert ranks[0]["wire_native_is_native"] and not ranks[0]["wire_python_is_native"]
    for r in ranks:
        assert r["wire_native_ran"] == r["wire_python_ran"] == 1
        assert r["wire_native_hash"] == r["wire_python_hash"] == ranks[0]["wire_native_hash"]
