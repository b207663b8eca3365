"""The manager-failover bench on the CPU: ``bench/manager_failover.run``
with ``device="cpu"`` (K1's plain version), 2 daemons, 4 MiB files and a
2 s lease.  Two manager binaries run as children; the leader is SIGKILLed
with a preheat queued, the standby promotes, and every check of the
summary holds: the leader died by SIGKILL, the survivor leads at term 2
with one failover counted, the standby answered 503 before its
promotion, the preheat reached SUCCESS at the survivor with the seed
holding B, every download of the three waves is sha256-equal to its
origin file, the subscriber never pinned, model B (activated at the
survivor) serves wave 3 through the fused scorer, every scorer call came
from a wave, and no manager child or native server outlived the run.

``cli.scheduler.serve``'s subscription installs an active model that K1
runs as ``FusedMLPScorer`` on the serve device, and a standardized or
two-layer one as ``load_scorer`` returned it.
"""

from __future__ import annotations

import os
import time

import numpy as np

from dragonfly2_tpu_torch import config, manager
from dragonfly2_tpu_torch.bench import manager_failover
from dragonfly2_tpu_torch.bench.wire_loop import seeded_k1_blob
from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer
from dragonfly2_tpu_torch.ops.fused_score import FusedMLPScorer
from dragonfly2_tpu_torch.trainer.export import MLPScorer, load_scorer, scorer_to_bytes


def test_leader_sigkill_fails_over_and_every_check_holds(tmp_path):
    summary = manager_failover.run(manager_failover.parse_args([
        "--daemons", "2", "--file-mib", "4", "--lease-ttl-s", "2", "--seed", "5",
        "--out", str(tmp_path), "--device", "cpu"]), log=lambda line: None)
    assert summary["checks"] and all(summary["checks"].values()), summary["checks"]
    assert summary["leader_returncode"] == -9
    assert summary["survivor_status"]["term"] == 2
    # The lease's TTL plus its grace bound the takeover (2 s lease, half of
    # it as grace, 1 s polls).
    assert 1.0 < summary["kill_to_promotion_s"] <= summary["kill_to_first_accepted_write_s"] < 10
    assert [w["file"] for w in summary["waves"]] == ["a", "c", "d"]
    assert summary["model_versions"] == {"A": 1, "B": 2}
    assert summary["scorer_calls_by_model"]["B"] >= summary["waves"][2]["scorer_calls"] > 0
    assert summary["endpoint_failovers"].get("scheduler", 0) >= 1
    assert summary["pinned_samples"]["n"] > 10
    assert not os.path.exists(tmp_path / "manager_failover")


def test_serve_installs_the_models_k1_runs_through_k1(tmp_path):
    k1 = load_scorer(seeded_k1_blob(3))
    rng = np.random.default_rng(4)
    standardized = MLPScorer(weights=k1.weights, feat_mean=rng.random(32, np.float32),
                             feat_std=1 + rng.random(32, np.float32))
    two_layer = MLPScorer(weights=[(w, b) for w, b in k1.weights[:1]]
                          + [(rng.standard_normal((64, 1)).astype(np.float32), np.zeros(1,
                                                                                np.float32))])
    registry = manager.ModelRegistry()
    srv = ManagerRESTServer(registry, manager.ClusterManager())
    srv.serve()
    cfg = config.SchedulerConfigFile()
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.storage.dir = str(tmp_path / "records")
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.model_poll_interval_s = 0.05
    cfg.manager_addr = srv.url
    try:
        serving = scheduler_cli.serve(cfg, device="cpu")
        ev = serving.service.scheduling.evaluator
        try:
            installed = []
            for scorer in (k1, standardized, two_layer):
                model = registry.create_model(
                    name="parent-bandwidth-mlp", type="mlp",
                    scheduler_id=serving.scheduler_id, artifact=scorer_to_bytes(scorer))
                registry.activate(model.id)
                deadline = time.monotonic() + 30
                while serving.model_subscriber._loaded_version != model.version:
                    assert time.monotonic() < deadline, "the subscription never installed"
                    time.sleep(0.02)
                installed.append(ev._scorer)
        finally:
            serving.stop()
    finally:
        srv.stop()
    fused, host_std, host_two = installed
    assert isinstance(fused, FusedMLPScorer) and fused.device.type == "cpu"
    assert all(np.array_equal(a, b) and np.array_equal(c, d)
               for (a, c), (b, d) in zip(fused._ref.weights, k1.weights))
    assert type(host_std) is MLPScorer and host_std.feat_mean is not None
    assert type(host_two) is MLPScorer and len(host_two.weights) == 2
    assert [FusedMLPScorer.runs_k1(s) for s in (k1, standardized, two_layer)] == [
        True, False, False]
