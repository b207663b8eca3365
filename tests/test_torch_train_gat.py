"""Port parity: GAT ranker training, ``dragonfly2_tpu_torch/trainer/train.py``
against ``dragonfly2_tpu/trainer/train.py``, and the GNN scorer artifact
of both packages' ``trainer/export.py``.

The JAX trainer runs once per module (bf16 compute, the segment-sum
gather in interpret mode, dropout 0, 2 epochs × 3 batches); the port
trains from the same flax init, carried across, on its plain K3.

Tolerances, stated:
- split and batch order: equal;
- loss per step: 5e-3 relative (bf16 compute; measured ~1e-3 on this
  CPU over 20 steps at lr 1e-2);
- parameters after 6 steps: 3 × the sum of the learning rates of those
  steps, absolute.  Adam's first updates are ±lr per element whatever
  the gradient's size, so a gradient element near 0 that bf16 rounding
  flips in sign moves its parameter by up to 2 lr a step;
- optimizer against optax: 1e-6 relative (f32); the schedule 1e-5
  (optax computes it in float32, the port in float64);
- GNN blobs across packages: 1e-5 (both score with the same numpy head);
- exported scorer against the model's own predictions: 3e-2 absolute
  (the model's head runs in bf16, the scorer's in f32; measured 7.6e-3
  at the trainer's full widths on this CPU, scores near 16).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dragonfly2_tpu.models import gnn as jg
from dragonfly2_tpu.ops.pallas_segment import make_neighbor_gather as jax_gather
from dragonfly2_tpu.trainer import export as jax_export
from dragonfly2_tpu.trainer import train as jtr
from dragonfly2_tpu_torch.models import gnn as tg
from dragonfly2_tpu_torch.ops.segment import make_neighbor_gather
from dragonfly2_tpu_torch.trainer import export
from dragonfly2_tpu_torch.trainer import train as ttr

N, K, B = 200, 8, 64
CFG = dict(learning_rate=1e-3, epochs=2, warmup_steps=1, log_every=1, seed=0)
EXPORT_TOL = 3e-2


class _Recorder(np.ndarray):
    """An edge array that logs every integer index array it is read with."""

    def __getitem__(self, idx):
        if isinstance(idx, np.ndarray) and idx.ndim == 1 and idx.dtype.kind in "iu":
            self.log.append(np.array(idx))
        return np.asarray(super().__getitem__(idx))


def _recording(a: np.ndarray) -> _Recorder:
    rec = a.view(_Recorder)
    rec.log = []
    return rec


def _data(seed=3, m=214):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 1200)
    dst = rng.integers(0, N, 1200)
    rtt = rng.random(1200).astype(np.float32)
    nf = rng.normal(size=(N, 12)).astype(np.float32)
    es = rng.integers(0, N, m)
    ed = (es + rng.integers(1, N, m)) % N
    y = (rng.normal(size=m) + 15.0).astype(np.float32)
    return src, dst, rtt, nf, es, ed, y


def _gnn_kw():
    return dict(hidden=16, num_heads=2, node_embed_dim=4, dropout=0.0)


@pytest.fixture(scope="module")
def runs():
    """One JAX training run and one port run from the carried init."""
    src, dst, rtt, nf, es, ed, y = _data()
    jt = jg.build_neighbor_table(N, src, dst, rtt, max_neighbors=K)
    tt = tg.build_neighbor_table(N, src, dst, rtt, max_neighbors=K)
    jcfg = jg.GNNConfig(gather_fn=jax_gather(np.asarray(jt.indices), N, edge_block=128,
                                             interpret=True), **_gnn_kw())
    j_src = _recording(es)
    jstate, jmet, jhist = jtr.train_gat_ranker(
        nf, jt, j_src, ed, y, model_config=jcfg, config=jtr.TrainConfig(**CFG), batch_size=B
    )
    # The JAX trainer's init: PRNGKey(seed) split, the first half to init.
    init_rng, _ = jax.random.split(jax.random.PRNGKey(CFG["seed"]))
    p0 = jg.GATRanker(jcfg).init(
        init_rng, jnp.asarray(nf), jt, jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32)
    )["params"]
    tcfg = tg.GNNConfig(gather_fn=make_neighbor_gather(tt.indices, N, edge_block=128,
                                                       device="cpu"), **_gnn_kw())
    model = tg.load_flax_params(tg.GATRanker(tcfg, num_nodes=N, in_dim=12),
                                jax.tree_util.tree_map(np.asarray, p0))
    t_src = _recording(es)
    tstate, tmet, thist = ttr._train_graph_model(
        model, nf, tt, t_src, ed, y, None, ttr.TrainConfig(**CFG), "cpu", B
    )
    return dict(
        jparams=jax.tree_util.tree_map(np.asarray, jstate.params), jmet=jmet, jhist=jhist,
        jlog=j_src.log, tstate=tstate, tmet=tmet, thist=thist, tlog=t_src.log,
        data=(src, dst, rtt, nf, es, ed, y), jt=jt, tt=tt,
    )


def test_split_and_batch_order_equal_the_jax_trainer(runs):
    jlog, tlog = runs["jlog"], runs["tlog"]
    # 2 epochs × 3 batches, then the validation edges.
    assert len(jlog) == len(tlog) == 7
    for a, b in zip(jlog, tlog):
        assert np.array_equal(a, b)
    val_idx, train_idx = ttr.split_edges(214, CFG["seed"])
    assert np.array_equal(tlog[-1], val_idx)
    batches = [b for e in range(2) for b in ttr.epoch_batches(train_idx, B, CFG["seed"], e)]
    assert all(np.array_equal(a, b) for a, b in zip(batches, tlog[:-1]))


def test_train_steps_match_the_jax_trainer(runs):
    jl = np.array([h["loss"] for h in runs["jhist"]])
    tl = np.array([h["loss"] for h in runs["thist"]])
    assert [h["step"] for h in runs["thist"]] == [h["step"] for h in runs["jhist"]] == list(range(1, 7))
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    schedule = ttr._make_optimizer([], ttr.TrainConfig(**CFG), 3).schedule
    lr_sum = sum(schedule(i) for i in range(6))
    got = tg._flatten(tg.to_flax_params(runs["tstate"].model))
    want = tg._flatten(runs["jparams"])
    assert set(got) == set(want)
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= 3 * lr_sum
    np.testing.assert_allclose(runs["tmet"].mae, runs["jmet"].mae, rtol=5e-3)


def test_train_gat_ranker_end_to_end_with_query_edge_features():
    src, dst, rtt, nf, es, ed, y = _data(seed=4, m=600)
    table = tg.build_neighbor_table(N, src, dst, rtt, max_neighbors=K)
    qef = np.random.default_rng(5).normal(size=(600, 3)).astype(np.float32)
    mcfg = tg.GNNConfig(hidden=16, num_heads=2, node_embed_dim=4,
                        gather_fn=make_neighbor_gather(table.indices, N, device="cpu"))
    state, metrics, hist = ttr.train_gat_ranker(
        nf, table, es, ed, y, qef, model_config=mcfg,
        config=ttr.TrainConfig(epochs=3, warmup_steps=2, log_every=2, learning_rate=3e-3),
        device="cpu", batch_size=128,
    )
    assert [h["step"] for h in hist] == [2, 4, 6, 8, 10, 12]
    assert all(np.isfinite(h["loss"]) and h["records_per_sec"] > 0 for h in hist)
    assert np.isfinite(list(metrics.to_dict().values())).all()
    assert state.step == 12 and state.opt.count == 12
    with pytest.raises(ValueError):
        export.export_gnn_scorer(state.model, nf, table, np.arange(N))


def test_no_full_batch_raises():
    # Two edges: one for validation, one for training, under the
    # trainer's smallest batch of two.
    src, dst, rtt, nf, es, ed, y = _data(m=2)
    table = tg.build_neighbor_table(N, src, dst, rtt, max_neighbors=K)
    model = tg.GATRanker(tg.GNNConfig(**_gnn_kw()), num_nodes=N, in_dim=12)
    with pytest.raises(ValueError):
        ttr._train_graph_model(model, nf, table, es, ed, y, None, ttr.TrainConfig(), "cpu", 64)


@pytest.mark.parametrize("clip", [False, True], ids=["under_norm", "clipped"])
def test_optimizer_matches_optax(clip):
    rng = np.random.default_rng(6)
    shapes = [(5, 3), (3,), (7,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    cfg = ttr.TrainConfig(learning_rate=1e-2, weight_decay=1e-2, epochs=1, warmup_steps=2)
    tx = jtr._make_optimizer(jtr.TrainConfig(**vars(cfg)), 6)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = ttr._make_optimizer(tp, cfg, 6)
    for step in range(6):
        scale = 3.0 if clip else 0.05
        grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.from_numpy(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_schedule_matches_optax():
    for warmup, total in ((2, 18), (100, 101), (0, 10)):
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=3e-4, warmup_steps=warmup, decay_steps=total)
        got = ttr.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, total)
        for count in range(total + 3):
            # optax computes in float32, the port in float64.
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-5, atol=1e-10)
    assert ttr.warmup_cosine_decay_schedule(0.0, 3e-4, 2, 18)(0) == 0.0


def test_huber_and_metrics_match_the_jax_package():
    rng = np.random.default_rng(7)
    pred = (rng.normal(size=500) * 2 + 15).astype(np.float32)
    target = (rng.normal(size=500) * 2 + 15).astype(np.float32)
    np.testing.assert_allclose(
        float(ttr._huber(torch.from_numpy(pred), torch.from_numpy(target))),
        float(jtr._huber(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)
    assert ttr._regression_metrics(pred, target).to_dict() == pytest.approx(
        jtr._regression_metrics(pred, target).to_dict(), rel=1e-6)


def _jax_scorer(runs):
    src, dst, rtt, nf, es, ed, y = runs["data"]
    model = jg.GATRanker(jg.GNNConfig(**_gnn_kw()))
    buckets = np.random.default_rng(8).permutation(N).astype(np.int64) * 7 + 3
    return jax_export.export_gnn_scorer(model, runs["jparams"], nf, runs["jt"], buckets), buckets


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_gnn_blob_loads_across_packages_and_scores_within_1e_5(runs, direction):
    jscorer, buckets = _jax_scorer(runs)
    src, dst, rtt, nf, es, ed, y = runs["data"]
    model = runs["tstate"].model
    tscorer = export.export_gnn_scorer(model, nf, runs["tt"], buckets)
    written, writer, reader = (
        (jscorer, jax_export, export) if direction == "jax_to_torch"
        else (tscorer, export, jax_export)
    )
    loaded = reader.load_scorer(writer.gnn_scorer_to_bytes(written))
    assert type(loaded).__name__ == "GNNScorer" and loaded.model_type == "gnn"
    assert np.array_equal(loaded.buckets, written.buckets)
    assert np.array_equal(loaded.embeddings, written.embeddings)
    q_src = np.concatenate([buckets[es], [10**9]])   # an unseen host too
    q_dst = np.concatenate([buckets[ed], [buckets[0]]])
    want = written.score(None, src_buckets=q_src, dst_buckets=q_dst)
    got = loaded.score(None, src_buckets=q_src, dst_buckets=q_dst)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_export_gnn_scorer_matches_the_jax_export_and_the_model(runs):
    src, dst, rtt, nf, es, ed, y = runs["data"]
    # The port's trained params exported by both packages.
    params = tg.to_flax_params(runs["tstate"].model)
    buckets = np.arange(N, dtype=np.int64)
    want = jax_export.export_gnn_scorer(
        jg.GATRanker(jg.GNNConfig(**_gnn_kw())), params, nf, runs["jt"], buckets)
    got = export.export_gnn_scorer(runs["tstate"].model, nf, runs["tt"], buckets)
    assert len(got.head_weights) == len(want.head_weights) == 3
    for (w, b), (w2, b2) in zip(got.head_weights, want.head_weights):
        assert np.array_equal(w, w2) and np.array_equal(b, b2)
    scale = max(1.0, float(np.abs(want.embeddings).max()))
    assert float(np.abs(got.embeddings - want.embeddings).max()) <= 2e-2 * scale
    # Served scores against the model's own predictions on the val edges.
    val_idx = runs["tstate"].val_idx
    scores = got.score(None, src_buckets=es[val_idx], dst_buckets=ed[val_idx])
    assert float(np.abs(scores - runs["tstate"].val_pred).max()) <= EXPORT_TOL
