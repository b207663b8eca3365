"""Port parity: validation MAE around each snapshot refresh of the online
graph trainer in a drifting world, ``dragonfly2_tpu_torch`` against
``dragonfly2_tpu`` on the CPU.

The world is ``bench/online_graph.py``'s ``--wire`` world at a reduced
size (1,000 hosts, K 16, ``HopConfig(hidden=64)`` in bfloat16, batch
1,024, 8 steps a dispatch, a refresh every 4 dispatches, 16 dispatches,
50 warm-up steps): per epoch a probe sweep in hash-bucket space and
``generate_feature_rows`` download chunks, one dispatch's rows a chunk,
fed through each package's wire adapter (the JAX one on its Python
path); snapshot 0 off the wire after the first chunk; at each epoch
boundary the world drifts, both packages score the epoch's validation
edges with the STALE snapshot, take the epoch's sweep, refresh, and
score them with the FRESH one.  The chunks are fed synchronously (no
producer thread), so both packages see one chunk order.  The port
carries flax's init (``load_flax_params``) and dropout is 0.

Tolerances, stated: each dispatch's loss within 1e-2 relative; each
stale and fresh MAE within 2e-2 relative; and each refresh's change
(fresh − stale) within 2e-2 of the stale MAE of the JAX one's, so a
refresh that helps or hurts in one package does the same in the other.

Run as a script, it prints both packages' losses and MAE per refresh as
one JSON line, at the flagship's width with ``--hidden 1024``:

    JAX_PLATFORMS=cpu python tests/test_torch_online_drift.py [--hidden 64]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from dragonfly2_tpu.models.hop import HopConfig as JHopConfig  # noqa: E402
from dragonfly2_tpu.trainer import online_graph as jog  # noqa: E402
from dragonfly2_tpu.trainer.train import TrainConfig as JTrainConfig  # noqa: E402
from dragonfly2_tpu_torch.bench.online_graph import _World  # noqa: E402
from dragonfly2_tpu_torch.models.gnn import load_flax_params  # noqa: E402
from dragonfly2_tpu_torch.models.hop import HopConfig  # noqa: E402
from dragonfly2_tpu_torch.records.features import HOST_FEATURE_DIM, TOPO_COLUMNS  # noqa: E402
from dragonfly2_tpu_torch.trainer import online_graph as tog  # noqa: E402
from dragonfly2_tpu_torch.trainer.train import TrainConfig  # noqa: E402

NODES = 1_000
HIDDEN = 64
BATCH = 1_024
SUPER = 8
REFRESH = 4
DISPATCHES = 16
WARMUP = 50
LOSS_RTOL = 1e-2
MAE_RTOL = 2e-2
CFG = dict(num_nodes=NODES, max_neighbors=16, batch_size=BATCH, super_steps=SUPER,
           refresh_every=0, topo_window=NODES * 16, queue_capacity=2,
           total_steps_hint=DISPATCHES * SUPER)


def _pair(hidden=HIDDEN):
    """(JAX trainer, its adapter, port trainer, its adapter): one config,
    dropout 0, the port carrying flax's init."""
    nf = np.zeros((NODES, HOST_FEATURE_DIM), np.float32)
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32))
    jt = jog.OnlineGraphTrainer(
        jog.OnlineGraphConfig(model=JHopConfig(hidden=hidden, dropout=0.0),
                              train=JTrainConfig(warmup_steps=WARMUP),
                              native_ingest=False, **CFG),
        node_feats=nf, topo_src=empty[0], topo_dst=empty[1], topo_rtt=empty[2],
    )
    tt = tog.OnlineGraphTrainer(
        tog.OnlineGraphConfig(model=HopConfig(hidden=hidden, dropout=0.0),
                              train=TrainConfig(warmup_steps=WARMUP),
                              native_ingest=False, **CFG),
        node_feats=nf, topo_src=empty[0], topo_dst=empty[1], topo_rtt=empty[2],
        device="cpu",
    )
    load_flax_params(tt.state.model, jax.tree_util.tree_map(np.asarray, jt.state.params))
    return jt, jog.WireIngestAdapter(jt, use_native=False), tt, tt.make_wire_adapter()


def _probe_rows(world, buckets, epoch):
    """Epoch's probe sweep as TOPO_COLUMNS rows in bucket space, as the
    ``--wire`` producer of ``bench/online_graph.py`` builds it."""
    rng = np.random.default_rng(world.key(88_000, epoch))
    src = rng.integers(0, NODES, NODES * 16)
    dst = rng.integers(0, NODES, NODES * 16)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    rows = np.zeros((len(src), len(TOPO_COLUMNS)), np.float32)
    rows[:, 0] = buckets[src]
    rows[:, 1] = buckets[dst]
    rows[:, 2] = (world.cluster._rtt_vec(src, dst, rng=rng) / 1e9).astype(np.float32)
    return rows


def _drive(trainer, adapter):
    """One package through the drifting world; → its dispatch losses and
    the (stale, fresh) MAE of each refresh."""
    producer = _World(NODES, BATCH, SUPER)
    scorer = _World(NODES, BATCH, SUPER)
    buckets = producer.cluster._bucket_table()
    losses, refreshes = [], []
    if isinstance(trainer, jog.OnlineGraphTrainer):
        dispatch_fn = trainer._dispatch_fn

        def capture(*args):
            out = dispatch_fn(*args)
            losses.append(float(out[1]))
            return out

        trainer._dispatch_fn = capture

    def val_set(epoch):
        rows = scorer.cluster.generate_feature_rows(2 * BATCH, seed=scorer.key(999_000, epoch))
        with adapter._mu:
            ids = adapter._id_table[np.concatenate([rows[:, 0], rows[:, 1]]).astype(np.int64)]
        src, dst = ids[: len(rows)], ids[len(rows):]
        assert (src >= 0).all() and (dst >= 0).all()
        return src.astype(np.int32), dst.astype(np.int32), rows[:, -1]

    def eval_mae(val):
        return float(trainer.eval_mae(*val))

    for d in range(DISPATCHES):
        epoch = d // REFRESH
        if d % REFRESH == 0:
            if epoch:
                scorer.drift(epoch)
                val = val_set(epoch)
                stale = eval_mae(val)
                producer.drift(epoch)
            adapter.feed_topology_rows(_probe_rows(producer, buckets, epoch))
        adapter.feed_download_rows(
            producer.cluster.generate_feature_rows(BATCH * SUPER, seed=producer.key(10_000, d)))
        if d % REFRESH == 0:
            assert trainer.refresh_snapshot() is not None
            if epoch:
                refreshes.append({"dispatch": d, "stale_mae": stale, "fresh_mae": eval_mae(val)})
        assert trainer.run(max_dispatches=1, idle_timeout=0.1) == 1
        if isinstance(trainer, tog.OnlineGraphTrainer):
            losses.append(float(trainer.last_loss))
    return {"losses": losses, "refreshes": refreshes}


def _runs(hidden=HIDDEN):
    jt, jad, tt, tad = _pair(hidden)
    return _drive(jt, jad), _drive(tt, tad)


@pytest.fixture(scope="module")
def runs():
    return _runs()


def test_drifting_world_losses_match_jax(runs):
    j, t = runs
    assert len(j["losses"]) == len(t["losses"]) == DISPATCHES
    rel = np.abs(np.array(t["losses"]) - j["losses"]) / np.abs(j["losses"])
    assert rel.max() <= LOSS_RTOL, (t["losses"], j["losses"])


def test_refresh_mae_matches_jax_at_each_refresh(runs):
    j, t = runs
    assert [r["dispatch"] for r in j["refreshes"]] == \
        [r["dispatch"] for r in t["refreshes"]] == [4, 8, 12]
    for rj, rt in zip(j["refreshes"], t["refreshes"]):
        for k in ("stale_mae", "fresh_mae"):
            assert abs(rt[k] - rj[k]) <= MAE_RTOL * rj[k], (rt, rj)
        change_j = rj["fresh_mae"] - rj["stale_mae"]
        change_t = rt["fresh_mae"] - rt["stale_mae"]
        assert abs(change_t - change_j) <= MAE_RTOL * rj["stale_mae"], (rt, rj)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hidden", type=int, default=HIDDEN)
    hidden = ap.parse_args().hidden
    j, t = _runs(hidden)
    print(json.dumps({"hidden": hidden, "jax": j, "port": t}))
