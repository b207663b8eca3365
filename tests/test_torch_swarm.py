"""Port parity: the swarm simulator and the scheduler binary's
``--simulate``, ``dragonfly2_tpu_torch/sim/swarm.py`` and
``dragonfly2_tpu_torch/cli/scheduler.py``, against
``dragonfly2_tpu/sim/swarm.py`` and ``dragonfly2_tpu/cli/scheduler.py``;
and the loop the reference's ``tests/test_e2e_loop.py`` closes, in the
port alone: swarm rows → ``cli.trainer --train-once`` → an ML evaluator
that beats the rule evaluator.

Both simulators are seeded alike: the numpy seed in ``SwarmConfig``, and
the JAX package's process-global ``random`` against the port's
``random.Random`` (candidate sampling and probe-target choice).  Peer ids
are ``uuid4`` in both packages, so records are compared by host ids.  A
record's parents come from a set in both packages (the DAG's parent
vertices), so they are compared as sets; the ranked order of every
schedule is compared exactly.  Parent-choice quality is compared
exactly (the same float64 sums over the same choices).
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest

from dragonfly2_tpu.cli import scheduler as jax_cli
from dragonfly2_tpu.records.storage import Storage as JaxStorage
from dragonfly2_tpu.scheduler import Evaluator as JaxEvaluator
from dragonfly2_tpu.scheduler.evaluator import NetworkTopologyEvaluator as JaxNT
from dragonfly2_tpu.sim import SwarmConfig as JaxSwarmConfig
from dragonfly2_tpu.sim import SwarmSimulator as JaxSwarm
from dragonfly2_tpu_torch.cli import scheduler as cli
from dragonfly2_tpu_torch.cli import trainer as trainer_cli
from dragonfly2_tpu_torch.manager.registry import ModelRegistry
from dragonfly2_tpu_torch.records.storage import Storage
from dragonfly2_tpu_torch.scheduler import Evaluator, MLEvaluator, ModelSubscriber
from dragonfly2_tpu_torch.scheduler.evaluator import NetworkTopologyEvaluator
from dragonfly2_tpu_torch.sim import SwarmConfig, SwarmSimulator
from dragonfly2_tpu_torch.trainer.service import GNN_MODEL_NAME, MLP_MODEL_NAME

HOSTS, SEED, RNG_SEED = 48, 3, 11


def _tap_schedules(sim):
    """Log the ranked parent host ids of every registration's schedule."""
    log = []
    register = sim.service.register_peer

    def wrapped(**kw):
        res = register(**kw)
        sched = res.schedule
        log.append((kw["host"].id, None if sched is None else sched.kind.name,
                    [] if sched is None else [p.host.id for p in sched.parents]))
        return res

    sim.service.register_peer = wrapped
    return log


@pytest.fixture(scope="module")
def swarms(tmp_path_factory):
    root = tmp_path_factory.mktemp("swarm")
    random.seed(RNG_SEED)
    jsim = JaxSwarm(JaxStorage(str(root / "jax")), config=JaxSwarmConfig(num_hosts=HOSTS, seed=SEED))
    jlog = _tap_schedules(jsim)
    jsim.run_downloads(240, tasks=6)
    jsim.run_probe_rounds(2)
    jsim.snapshot_topology()
    jsim.storage.flush()
    sim = SwarmSimulator(Storage(str(root / "port")), config=SwarmConfig(num_hosts=HOSTS, seed=SEED),
                         rng=random.Random(RNG_SEED))
    log = _tap_schedules(sim)
    sim.run_downloads(240, tasks=6)
    sim.run_probe_rounds(2)
    sim.snapshot_topology()
    sim.storage.flush()
    return jsim, jlog, sim, log


def _records(storage):
    """The Download records as their JSON dicts, oldest first."""
    out = []
    for path in reversed(storage.download_raw_paths()):
        with open(path) as f:
            out += [json.loads(line) for line in f if line.strip()]
    return out


def test_same_seed_same_schedules_records_and_probe_graph(swarms):
    jsim, jlog, sim, log = swarms
    assert log == jlog and len(log) == 240 + 2 * 6
    assert sum(kind == "PARENTS" for _, kind, _ in log) > 150
    jrec, rec = _records(jsim.storage), _records(sim.storage)
    assert len(rec) == len(jrec) == sim.storage.download_count == 252
    for a, b in zip(rec, jrec):
        assert a["host"]["id"] == b["host"]["id"] and a["state"] == b["state"]
        assert a["finished_piece_count"] == b["finished_piece_count"]
        assert sorted((p["host"]["id"], p["finished_piece_count"]) for p in a["parents"]) == \
            sorted((p["host"]["id"], p["finished_piece_count"]) for p in b["parents"])
    assert sum(len(r["parents"]) > 0 for r in rec) > 150
    jids, js, jd, jr = jsim.topology.to_edge_arrays()
    ids, s, d, r = sim.topology.to_edge_arrays()
    assert ids == jids and len(s) > 0
    assert np.array_equal(s, js) and np.array_equal(d, jd) and np.array_equal(r, jr)
    assert sim.storage.network_topology_count == jsim.storage.network_topology_count > 0


def test_parent_choice_quality_equal_for_rule_and_nt(swarms):
    jsim, _, sim, _ = swarms
    rule = sim.measure_parent_choice_quality(Evaluator(), n_trials=40)
    assert rule == jsim.measure_parent_choice_quality(JaxEvaluator(), n_trials=40)
    nt = sim.measure_parent_choice_quality(NetworkTopologyEvaluator(sim.topology), n_trials=40)
    assert nt == jsim.measure_parent_choice_quality(JaxNT(jsim.topology), n_trials=40)
    assert rule > 0 and nt > 0


def test_simulate_prints_the_reference_line_and_serve_mode_exits_2(tmp_path, monkeypatch,
                                                                   capsys):
    monkeypatch.setenv("DRAGONFLY_SCHEDULER_METRICS_ENABLE", "false")
    monkeypatch.setenv("DRAGONFLY_SCHEDULER_STORAGE_DIR", str(tmp_path / "jax"))
    assert jax_cli.run(["--simulate", "50"]) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    monkeypatch.setenv("DRAGONFLY_SCHEDULER_STORAGE_DIR", str(tmp_path / "port"))
    assert cli.run(["--simulate", "50", "--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want
    assert got.startswith("scheduler: simulated 50 downloads -> 66 download records")
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "download.dfc", "download.jsonl", "networktopology.dfc", "networktopology.jsonl"]
    # Serve mode with a gRPC port asks for the gRPC half: exit 2, naming it.
    monkeypatch.setenv("DRAGONFLY_SCHEDULER_SERVER_GRPC_PORT", "0")
    assert cli.run(["--device", "cpu"]) == 2
    assert "item 12c" in capsys.readouterr().err


def test_simulate_reloads_a_saved_probe_graph(tmp_path, monkeypatch, capsys):
    from dragonfly2_tpu_torch.scheduler import NetworkTopology, Probe

    saved = NetworkTopology()
    saved.enqueue_probe("a", "b", Probe(host_id="b", rtt_ns=5_000))
    (tmp_path / "records").mkdir()
    saved.save(str(tmp_path / "records" / "topology_state.json"))
    monkeypatch.setenv("DRAGONFLY_SCHEDULER_STORAGE_DIR", str(tmp_path / "records"))
    assert cli.run(["--simulate", "3", "--device", "cpu"]) == 0
    assert "scheduler: reloaded 1 probe edges" in capsys.readouterr().out


def test_swarm_rows_train_a_model_that_beats_the_rules(tmp_path, capsys):
    """tests/test_e2e_loop.py's loop, in the port: the swarm's own rows,
    the trainer binary, the registered MLP in an ML evaluator."""
    storage = Storage(str(tmp_path / "records"), buffer_size=50)
    sim = SwarmSimulator(storage, config=SwarmConfig(num_hosts=40, seed=7),
                         rng=random.Random(7))
    sim.run_downloads(300, tasks=10)
    sim.run_probe_rounds(rounds=2)
    assert sim.snapshot_topology() > 0
    storage.flush()
    registry = ModelRegistry()
    rc = trainer_cli.run(["--train-once", storage.directory, "--device", "cpu"],
                         registry=registry)
    out = capsys.readouterr().out
    assert rc == 0, out
    models = {m.name: m for m in registry.list()}
    assert sorted(models) == sorted([MLP_MODEL_NAME, GNN_MODEL_NAME])
    registry.activate(models[MLP_MODEL_NAME].id)
    ml = MLEvaluator()
    ModelSubscriber(registry, ml, scheduler_id=models[MLP_MODEL_NAME].scheduler_id).refresh()
    assert ml.has_model
    rules_bw = sim.measure_parent_choice_quality(Evaluator(), n_trials=60)
    ml_bw = sim.measure_parent_choice_quality(ml, n_trials=60)
    # BASELINE configs[2]: the learned evaluator beats the rule-based one
    # on the ground-truth bandwidth of the chosen parent.
    assert ml_bw > rules_bw, (ml_bw, rules_bw)
