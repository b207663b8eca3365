"""Port parity: federated FedAvg (BASELINE configs[3]),
``dragonfly2_tpu_torch/trainer/federated.py`` against
``dragonfly2_tpu/trainer/federated.py``.

Non-IID cluster shards as the reference test makes them (4 clusters of
32 hosts, each its own seed), here of unequal sizes so the sample-count
weighting shows.  The port runs on the CPU (``device="cpu"``), the JAX
package on its CPU backend.  Parity runs carry flax's init (after the
output-bias warm start, which both packages compute alike) into the
port: a seed initializes the two packages with other weights.

Tolerances, stated:
- one round and a 3-round run from the carried init (``MLPConfig()``:
  bf16 hidden layers): per leaf, ``‖port − jax‖ / ‖jax − initial‖``
  within 2e-2 (measured 9.5e-3 after one round, 9.0e-3 after three);
  the global validation MAE within 1e-3 relative of the JAX run's each
  round (measured 8e-5).  Two planted faults must read above twice the
  limit: an unweighted mean (reads 0.22), and an optimizer carried from
  shard to shard instead of re-initialized (reads 4.2);
- the weighted mean: within 1e-6 of numpy's (and of the JAX package's
  ``_tree_weighted_mean``) on the same trees;
- the published blob: the port's and the JAX package's ``load_scorer``
  score equally (1e-6), and within 3e-2 × max(1, |score|) of the bf16
  model's own predictions.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu.trainer import export as jexport
from dragonfly2_tpu.trainer import federated as jfed
from dragonfly2_tpu_torch.manager.registry import ModelRegistry
from dragonfly2_tpu_torch.records.synthetic import SyntheticCluster
from dragonfly2_tpu_torch.trainer import export
from dragonfly2_tpu_torch.trainer import federated as tfed

SIZES = (2500, 2500, 1600, 1200)
MOVE_TOL = 2e-2
MAE_RTOL = 1e-3


@pytest.fixture(scope="module")
def federation():
    shards, evals = [], []
    for c, n in enumerate(SIZES):
        rows = SyntheticCluster(num_hosts=32, seed=100 + c).generate_feature_rows(n + 500, seed=c)
        shards.append(rows[:n])
        evals.append(rows[n:])
    return shards, np.concatenate(evals, axis=0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v, np.float32)})
    return out


def _pair(rows, **cfg):
    """(JAX trainer, port trainer) on the same shards, the port carrying
    the JAX trainer's initial global params."""
    jt = jfed.FederatedTrainer([jfed.ClusterShard(f"c{i}", r) for i, r in enumerate(rows)],
                               config=jfed.FederatedConfig(**cfg))
    tt = tfed.FederatedTrainer([tfed.ClusterShard(f"c{i}", r) for i, r in enumerate(rows)],
                               config=tfed.FederatedConfig(**cfg), device="cpu")
    assert np.array_equal(tt.feat_mean, jt.feat_mean) and np.array_equal(tt.feat_std, jt.feat_std)
    tt.global_params = {k: torch.from_numpy(v.copy())
                        for k, v in _flat(jax.tree_util.tree_map(np.asarray, jt.global_params)).items()}
    return jt, tt


def _moves(tt, jt, start):
    jend = _flat(jax.tree_util.tree_map(np.asarray, jt.global_params))
    out = {}
    for k, j in jend.items():
        t = tt.global_params[k].numpy().astype(np.float64)
        out[k] = float(np.linalg.norm(t - j) / max(np.linalg.norm(j - start[k]), 1e-12))
    return out


def _run_round(fault, rows):
    jt, tt = _pair(rows, rounds=1, local_epochs=1)
    start = {k: v.numpy().astype(np.float64) for k, v in tt.global_params.items()}
    if fault == "unweighted":
        tfed_mean = tfed._tree_weighted_mean
        tt_round = lambda: setattr(tt, "global_params", tfed_mean(  # noqa: E731
            [tt.train_local(s, tt.global_params)[0] for s in tt.shards], [1.0] * len(tt.shards)))
        tt.run_round = tt_round
    elif fault == "carried_optimizer":
        make_opt, step = tt._local_step()
        shared = []

        def once():
            if not shared:
                shared.append(make_opt())
            return shared[0]

        tt._make_opt = once
    jt.run_round()
    tt.run_round()
    return _moves(tt, jt, start)


@pytest.fixture(scope="module")
def one_round(federation):
    return _run_round(None, federation[0])


def test_one_round_matches_jax_from_a_carried_init(one_round):
    assert max(one_round.values()) <= MOVE_TOL, one_round


@pytest.mark.parametrize("fault", ["unweighted", "carried_optimizer"])
def test_planted_fault_reads_above_the_limit(federation, fault):
    moves = _run_round(fault, federation[0])
    assert max(moves.values()) > 2 * MOVE_TOL, moves


def test_run_matches_jax_from_a_carried_init(federation):
    rows, eval_rows = federation
    jt, tt = _pair(rows, rounds=3, local_epochs=1, learning_rate=3e-3)
    start = {k: v.numpy().astype(np.float64) for k, v in tt.global_params.items()}
    jm = jt.run(eval_rows)
    tm = tt.run(eval_rows)
    moves = _moves(tt, jt, start)
    assert max(moves.values()) <= MOVE_TOL, moves
    j_maes = [h["mae"] for h in jt.history]
    t_maes = [h["mae"] for h in tt.history]
    assert np.max(np.abs(np.array(t_maes) - j_maes) / np.array(j_maes)) <= MAE_RTOL
    assert abs(tm.mae - jm.mae) <= MAE_RTOL * jm.mae
    # FedAvg improves the global model round over round and beats the
    # mean predictor (the reference test's claim, on the port).
    baseline = float(np.mean(np.abs(eval_rows[:, -1] - eval_rows[:, -1].mean())))
    assert t_maes[-1] < t_maes[0] and tm.mae < baseline


def test_weighted_mean_is_numpys_and_the_jax_packages():
    rng = np.random.default_rng(0)
    trees = [{"Dense_0/kernel": rng.normal(size=(32, 8)).astype(np.float32),
              "Dense_0/bias": rng.normal(size=8).astype(np.float32)} for _ in range(5)]
    weights = [2500, 50, 1200, 7, 999]
    got = tfed._tree_weighted_mean([{k: torch.from_numpy(v) for k, v in t.items()}
                                    for t in trees], weights)
    jax_tree = [{"d": {"kernel": t["Dense_0/kernel"], "bias": t["Dense_0/bias"]}} for t in trees]
    jgot = jfed._tree_weighted_mean(jax_tree, weights)
    w = np.asarray(weights, np.float64) / sum(weights)
    for k, leaf in (("Dense_0/kernel", "kernel"), ("Dense_0/bias", "bias")):
        want = sum(wi * t[k].astype(np.float64) for wi, t in zip(w, trees))
        assert np.max(np.abs(got[k].numpy() - want)) <= 1e-6
        assert np.max(np.abs(got[k].numpy() - np.asarray(jgot["d"][leaf]))) <= 1e-6


def test_round_aggregates_the_local_models_by_sample_count(federation):
    """A tiny shard must not dominate: the round's global params are the
    sample-weighted mean of the local models (within 1e-6)."""
    rows, _ = federation
    tt = tfed.FederatedTrainer([tfed.ClusterShard("big", rows[0]),
                                tfed.ClusterShard("tiny", rows[1][:50])],
                               config=tfed.FederatedConfig(rounds=1, local_epochs=1),
                               device="cpu")
    g0 = tt.global_params
    (p_big, n_big), (p_small, n_small) = (tt.train_local(s, g0) for s in tt.shards)
    tt.run_round()
    for k, agg in tt.global_params.items():
        want = (p_big[k].double() * n_big + p_small[k].double() * n_small) / (n_big + n_small)
        assert float((agg.double() - want).abs().max()) <= 1e-6


def test_published_blob_loads_in_both_packages(federation):
    rows, eval_rows = federation
    tt = tfed.FederatedTrainer([tfed.ClusterShard(f"c{i}", r) for i, r in enumerate(rows)],
                               config=tfed.FederatedConfig(rounds=2, local_epochs=1,
                                                           learning_rate=3e-3),
                               device="cpu")
    tt.run(eval_rows)
    registry = ModelRegistry()
    model = tt.publish(registry)
    assert model.version == 1 and model.evaluation == tt.history[-1]
    blob = registry.load_artifact(model)
    feats = eval_rows[:200, 2:-1]
    ours = export.load_scorer(blob).score(feats)
    theirs = jexport.load_scorer(blob).score(feats)
    assert np.max(np.abs(ours - theirs)) <= 1e-6
    pred = tt.predict(eval_rows[:200])
    assert np.max(np.abs(ours - pred) / np.maximum(1.0, np.abs(ours))) <= 3e-2


def test_cuda_device_without_a_card_raises(federation):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tfed.FederatedTrainer([tfed.ClusterShard("c", federation[0][0])])
