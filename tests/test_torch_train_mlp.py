"""Port parity: batch MLP training and its input pipeline,
``dragonfly2_tpu_torch/trainer/{ingest,train}.py`` (``EdgeBatches``,
``load_download_dataset``, ``train_mlp``, ``evaluate_mlp``, the
checkpoints) against ``dragonfly2_tpu/trainer/{ingest,train}.py``.

The port runs on the CPU (``device="cpu"``); the JAX package on its CPU
backend (an 8-device mesh, so batches here are multiples of 8 and the
JAX trainer's batch rounding is a no-op).  Parity runs carry the JAX
trainer's flax init into the port (``load_flax_params``), with dropout 0.

Tolerances, stated:
- batches, splits, ``feat_mean`` / ``feat_std``: exact (numpy verbatim);
- losses per step: 5e-3 (bf16) and 1e-4 (float32) relative;
- validation metrics: MSE and MAE within 2e-2 (bf16) and 1e-4 (float32)
  relative; F1 within 3e-2 (bf16) and 1e-3 (float32) absolute (a
  prediction near the median threshold may land on either side);
- trained weights, per leaf: ``‖port − jax‖ / ‖jax − start‖``, the
  relative L2 of the two trainers' moves from the common (warm-started)
  start, with weight decay 0.1 so that decay moves the weights visibly:
  within 1.5e-2 (bf16) and 1e-4 (float32).  Measured on the CPU: at
  most 5.3e-3 (bf16) and 7.6e-6 (float32).  Two planted faults in the
  port must read more than twice the limit, and do: a top-level
  ``Dense_2`` whose gradients are dropped (~1.0, its kernel) and no
  weight decay (~0.89, ``Dense_2/bias``);
- checkpoints: bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models import mlp as jm
from dragonfly2_tpu.records import columnar as jcol
from dragonfly2_tpu.trainer import ingest as jing
from dragonfly2_tpu.trainer import train as jtr
from dragonfly2_tpu_torch.models import gnn as tg
from dragonfly2_tpu_torch.models import mlp as tm
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS, DOWNLOAD_FEATURE_DIM
from dragonfly2_tpu_torch.trainer import ingest as ting
from dragonfly2_tpu_torch.trainer import train as ttr

LOSS_RTOL = {"bf16": 5e-3, "f32": 1e-4}
METRIC_RTOL = {"bf16": 2e-2, "f32": 1e-4}
F1_ATOL = {"bf16": 3e-2, "f32": 1e-3}
MOVE_TOL = {"bf16": 1.5e-2, "f32": 1e-4}
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16), "f32": (jnp.float32, torch.float32)}
CFG = dict(learning_rate=3e-3, weight_decay=0.1, epochs=3, warmup_steps=2, log_every=1,
           seed=3)


def _rows(n, seed=0):
    """Download rows with a learnable target and one constant column."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, len(DOWNLOAD_COLUMNS)), np.float32)
    rows[:, 0] = rng.integers(0, 1 << 20, n)
    rows[:, 1] = rng.integers(0, 1 << 20, n)
    feats = (rng.standard_normal((n, DOWNLOAD_FEATURE_DIM)) * 2.0 + 1.0).astype(np.float32)
    feats[:, 7] = 3.0
    rows[:, 2:2 + DOWNLOAD_FEATURE_DIM] = feats
    w = rng.standard_normal(DOWNLOAD_FEATURE_DIM).astype(np.float32) * 0.2
    rows[:, -1] = 13.0 + feats @ w + rng.standard_normal(n).astype(np.float32) * 0.1
    return rows


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (True, False), (False, False)])
def test_edge_batches_epochs_are_bit_equal(shuffle, drop):
    rows = _rows(1000)
    j = jing.EdgeBatches(rows, batch_size=96, shuffle=shuffle, seed=4, drop_remainder=drop)
    t = ting.EdgeBatches(rows, batch_size=96, shuffle=shuffle, seed=4, drop_remainder=drop)
    assert len(j) == len(t)
    for epoch in range(3):
        jb, tb = list(j.epoch(epoch)), list(t.epoch(epoch))
        assert len(jb) == len(tb) == len(t)
        assert all(_same(a, b) for a, b in zip(jb, tb))
    with pytest.raises(ValueError, match="row width"):
        ting.EdgeBatches(rows[:, :10], batch_size=8)


def test_load_download_dataset_and_shards_match(tmp_path):
    paths = []
    for i in range(3):
        p = str(tmp_path / f"download_{i}.dfc")
        with jcol.ColumnarWriter(p, DOWNLOAD_COLUMNS) as w:
            w.append(_rows(150 + 40 * i, seed=i))
        paths.append(p)
    jt, jv = jing.load_download_dataset(paths, batch_size=64, seed=2)
    tt, tv = ting.load_download_dataset(paths, batch_size=64, seed=2)
    for a, b in ((jt, tt), (jv, tv)):
        assert np.array_equal(a.rows, b.rows)
        assert (a.batch_size, a.shuffle, a.drop_remainder) == (b.batch_size, b.shuffle,
                                                              b.drop_remainder)
    for pi in range(2):
        assert ting.shard_for_process(paths[::-1], pi, 2) == jing.shard_for_process(
            paths[::-1], process_index=pi, process_count=2)
    assert ting.shard_for_process(paths[::-1]) == sorted(paths)


def _jax_init(jcfg):
    """The JAX train_mlp's init: PRNGKey(seed) split, the first half."""
    init_rng, _ = jax.random.split(jax.random.PRNGKey(CFG["seed"]))
    params = jm.MLPRegressor(jcfg).init(init_rng, jnp.zeros((2, jcfg.in_dim)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _data(mod):
    rows = _rows(1200, seed=5)
    val_rows, train_rows = rows[:200], rows[200:]
    return (mod.EdgeBatches(train_rows, batch_size=128, seed=1),
            mod.EdgeBatches(val_rows, batch_size=128, shuffle=False, drop_remainder=False))


@pytest.fixture(scope="module", params=["bf16", "f32"])
def jax_run(request):
    dtype = request.param
    jcfg = jm.MLPConfig(hidden=(64, 32), dropout=0.0, dtype=DTYPES[dtype][0])
    jstate, jmet, jhist = jtr.train_mlp(*_data(jing), model_config=jcfg,
                                        config=jtr.TrainConfig(**CFG))
    return dict(dtype=dtype, p0=_jax_init(jcfg), jstate=jstate, jmet=jmet, jhist=jhist)


def _port_run(jax_run, fault=None):
    """The port's trainer from the JAX init, optionally with a planted fault."""
    tcfg = tm.MLPConfig(hidden=(64, 32), dropout=0.0, dtype=DTYPES[jax_run["dtype"]][1])
    model = tg.load_flax_params(tm.MLPRegressor(tcfg), jax_run["p0"])
    make = ttr._make_optimizer
    if fault == "frozen_dense_2":
        frozen = {id(p) for p in model.Dense_2.parameters()}

        def patched(params, cfg, steps):
            opt = make(params, cfg, steps)
            update = opt.update
            opt.update = lambda grads: update(
                [torch.zeros_like(g) if id(p) in frozen else g for p, g in zip(opt.params, grads)])
            return opt
    elif fault == "no_decay":
        def patched(params, cfg, steps):
            opt = make(params, cfg, steps)
            opt.weight_decay = 0.0
            return opt
    else:
        patched = make
    ttr._make_optimizer = patched
    try:
        tstate, tmet, thist = ttr._train_mlp_model(
            model, *_data(ting), ttr.TrainConfig(**CFG), "cpu")
    finally:
        ttr._make_optimizer = make
    return dict(jax_run, tstate=tstate, tmet=tmet, thist=thist, val=_data(ting)[1])


@pytest.fixture(scope="module")
def runs(jax_run):
    return jax_run["dtype"], _port_run(jax_run)


def test_standardization_is_exact(runs):
    _, r = runs
    assert np.array_equal(r["tstate"].feat_mean, np.asarray(r["jstate"].feat_mean))
    assert np.array_equal(r["tstate"].feat_std, np.asarray(r["jstate"].feat_std))
    assert r["tstate"].feat_std[7] == 1.0          # the constant column scales by 1


def test_losses_match_jax(runs):
    dtype, r = runs
    jl = np.array([h["loss"] for h in r["jhist"]])
    tl = np.array([h["loss"] for h in r["thist"]])
    assert len(tl) == len(jl) == 3 * (1000 // 128) == r["tstate"].step
    assert tl[-3:].mean() < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL[dtype])


def test_validation_metrics_match_jax(runs):
    dtype, r = runs
    jm_, tm_ = r["jmet"].to_dict(), r["tmet"].to_dict()
    for key in ("mse", "mae", "bandwidth_mae_mbps"):
        assert abs(tm_[key] - jm_[key]) <= METRIC_RTOL[dtype] * abs(jm_[key]), key
    assert abs(tm_["f1"] - jm_["f1"]) <= F1_ATOL[dtype]
    # evaluate_mlp again on the trained state: the same metrics.
    again = ttr.evaluate_mlp(r["tstate"], r["val"]).to_dict()
    assert again == tm_


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v, np.float64)})
    return out


def _moves(r):
    """Per leaf, ‖port − jax‖ / ‖jax − start‖ after training."""
    start = _flat(r["p0"])
    # Both trainers warm-start the output bias before their first step.
    start["Dense_2/bias"] = start["Dense_2/bias"] + float(_data(ting)[0].rows[:, -1].mean())
    jp = _flat(jax.tree_util.tree_map(np.asarray, r["jstate"].params))
    tp = _flat(tg.to_flax_params(r["tstate"].model))
    assert sorted(tp) == sorted(jp)
    return {k: float(np.linalg.norm(tp[k] - jp[k]) / max(np.linalg.norm(jp[k] - start[k]), 1e-12))
            for k in jp}


def test_trained_weights_move_as_jax(runs):
    dtype, r = runs
    moves = _moves(r)
    assert len(moves) == 6
    assert max(moves.values()) <= MOVE_TOL[dtype], moves


@pytest.mark.parametrize("fault", ["frozen_dense_2", "no_decay"])
def test_a_planted_fault_fails_the_weight_check(jax_run, fault):
    moves = _moves(_port_run(jax_run, fault=fault))
    assert max(moves.values()) > 2 * MOVE_TOL[jax_run["dtype"]], moves


def test_train_mlp_entry_point_and_no_full_batches():
    rows = _rows(600, seed=8)
    train = ting.EdgeBatches(rows[:500], batch_size=64, seed=0)
    val = ting.EdgeBatches(rows[500:], batch_size=64, shuffle=False, drop_remainder=False)
    state, metrics, hist = ttr.train_mlp(train, val, config=ttr.TrainConfig(
        epochs=2, log_every=1), device="cpu")
    assert isinstance(state.model, tm.MLPRegressor) and state.step == 2 * (500 // 64)
    assert np.isfinite(metrics.mae) and len(hist) == state.step
    small = ting.EdgeBatches(rows[:40], batch_size=64)
    for mod, kw in ((ttr, dict(device="cpu")), (jtr, {})):
        with pytest.raises(ValueError, match="no full batches"):
            mod.train_mlp(small, val, **kw)


def test_checkpoint_round_trip(runs, tmp_path):
    _, r = runs
    state = r["tstate"]
    path = str(tmp_path / "ckpt.pt")
    ttr.save_checkpoint(path, state)
    params = ttr.restore_params(path)
    fresh = tg.load_flax_params(tm.MLPRegressor(state.model.config), params)
    for (na, a), (nb, b) in zip(state.model.named_parameters(), fresh.named_parameters()):
        assert na == nb and torch.equal(a, b)
    assert torch.load(path, weights_only=True)["step"] == state.step
