"""Port parity: the trainer service across ranks against the JAX service.

The JAX service's trainers take no mesh, so each trains data-parallel
over every local device: 8 forced CPU devices here (``tests/conftest.py``).
The port's service trains on 2 gloo ranks (``parallel/launch.RankGroup``;
the spawned rank imports this module, which imports JAX only inside
functions).  Both take the same DFC1 shards.  They train from their own
seeded inits, so the comparison is the one ``tests/test_torch_trainer_
service.py`` makes at one device:

- exact: the registry rows (name, type, version, scheduler id, state),
  the run's row counts, and what a trainer's refusal skips (the trainers'
  ``ValueError`` on every rank skips the model everywhere, and the round
  succeeds, in both packages);
- quality: each model's validation MAE within ``MAE_BAND`` (15 %) of the
  JAX service's (10 epochs from different inits).
"""

from __future__ import annotations

import threading

import pytest

from dragonfly2_tpu_torch.manager.registry import ModelRegistry as TRegistry
from dragonfly2_tpu_torch.parallel.launch import RankGroup
from dragonfly2_tpu_torch.trainer import service as tsvc
from dragonfly2_tpu_torch.trainer import train as ttr
from test_torch_trainer_ranks import train_round, write_shards

TRAIN = dict(epochs=10, learning_rate=3e-3, warmup_steps=5)
MAE_BAND = 0.15


def _refuse(*args, **kwargs):
    raise ValueError("no full batches: 3 rows < batch 8 (data axis 8)")


def rank_refuse_all(rank):
    tsvc.train_mlp = _refuse
    ttr.train_gat_ranker = _refuse


def _rows(registry, run):
    return sorted((m.name, m.type, m.version, m.scheduler_id, str(getattr(m.state, "value", m.state)))
                  for m in (registry.get(i) for i in run.models))


def _port(shards, rank_init=None):
    group = RankGroup(2, device="cpu", rank_init=rank_init)
    registry = TRegistry()
    svc = tsvc.TrainerService(registry, train_config=ttr.TrainConfig(**TRAIN),
                              gnn_model="gat", ranks=group)
    try:
        return registry, train_round(svc, shards)
    finally:
        group.close()


def _jax(shards):
    from dragonfly2_tpu.manager.registry import ModelRegistry as JRegistry
    from dragonfly2_tpu.trainer import service as jsvc
    from dragonfly2_tpu.trainer import train as jtr

    registry = JRegistry()
    svc = jsvc.TrainerService(registry, train_config=jtr.TrainConfig(**TRAIN), gnn_model="gat")
    return registry, train_round(svc, shards)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return write_shards(str(tmp_path_factory.mktemp("shards")))


@pytest.fixture(scope="module")
def both(shards):
    """The port's two ranks train in the spawned rank and a thread here
    while the JAX service compiles and trains in this thread."""
    port = {}
    worker = threading.Thread(target=lambda: port.update(out=_port(shards)))
    worker.start()
    try:
        jax_out = _jax(shards)
    finally:
        worker.join()
    return {"port": port["out"], "jax": jax_out}


def test_registry_rows_match_the_jax_service_on_its_mesh(both):
    (treg, trun), (jreg, jrun) = both["port"], both["jax"]
    assert trun.error is None and jrun.error is None
    assert _rows(treg, trun) == _rows(jreg, jrun)
    assert len(trun.models) == 2
    assert (trun.download_rows, trun.topology_rows) == (jrun.download_rows, jrun.topology_rows)
    assert [r["registry_calls"] for r in trun.ranks] == [2, 0]


def test_mae_within_the_band_of_the_jax_service(both):
    (_, trun), (_, jrun) = both["port"], both["jax"]
    assert sorted(trun.metrics) == sorted(jrun.metrics) == sorted(
        [tsvc.MLP_MODEL_NAME, tsvc.GNN_MODEL_NAME])
    for name, jm in jrun.metrics.items():
        tm = trun.metrics[name]
        assert abs(tm.mae - jm.mae) <= MAE_BAND * jm.mae, (name, tm.mae, jm.mae)
        for r in trun.ranks:
            assert r["metrics"][name] == tm.to_dict()


def test_a_trainer_refusal_skips_alike_in_both_packages(shards, monkeypatch):
    from dragonfly2_tpu.trainer import service as jsvc
    from dragonfly2_tpu.trainer import train as jtr

    monkeypatch.setattr(jsvc, "train_mlp", _refuse)
    monkeypatch.setattr(jtr, "train_gat_ranker", _refuse)
    monkeypatch.setattr(tsvc, "train_mlp", _refuse)
    monkeypatch.setattr(ttr, "train_gat_ranker", _refuse)
    jreg, jrun = _jax(shards)
    treg, trun = _port(shards, rank_init=rank_refuse_all)
    assert jrun.error is None and trun.error is None
    assert jrun.models == trun.models == []
    assert jrun.metrics == trun.metrics == {}
    assert [r["metrics"] for r in trun.ranks] == [{}, {}]
    assert (trun.download_rows, trun.topology_rows) == (jrun.download_rows, jrun.topology_rows)
