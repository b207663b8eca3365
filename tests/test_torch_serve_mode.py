"""The two binaries' serve mode and the wire loop, on the CPU.

- Each binary (``python -m dragonfly2_tpu_torch.cli.{scheduler,trainer}
  --device cpu``) boots in a child process, prints its URL, answers one
  request and exits 0 on SIGINT (``bench/wire_loop.boot_binary``).
- Each option whose reader is not ported exits 2 and names its ROADMAP
  item: a ``grpc://`` address, a gRPC port, a sharded scheduler config.
- The trainer binary with ``lifecycle.enable`` and a REST manager boots
  the lifecycle daemon and prints the reference's line for it.
- ``bench/wire_loop.run`` at a small size: the manager, both serve
  compositions and a rule scheduler in one process, every arrow a
  socket.

Every server binds port 0 and is stopped in a ``finally``; every client
call has a timeout.
"""

from __future__ import annotations

import pytest

from dragonfly2_tpu_torch.bench import wire_loop
from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
from dragonfly2_tpu_torch.cli import trainer as trainer_cli
from dragonfly2_tpu_torch.manager import ClusterManager, ModelRegistry
from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer
from dragonfly2_tpu_torch.rollout import RolloutController
from dragonfly2_tpu_torch.trainer.service import GNN_MODEL_NAME, MLP_MODEL_NAME


@pytest.mark.parametrize("kind", ["scheduler", "trainer"])
def test_serve_mode_boots_answers_and_exits_0_on_sigint(tmp_path, kind):
    out = wire_loop.boot_binary(kind, "cpu", str(tmp_path), timeout=120)
    assert out["rc"] == 0, out["stderr"]
    assert out["url"].startswith("http://127.0.0.1:")
    if kind == "scheduler":
        assert out["response"]["protocol"]["negotiated"] == 2
        assert out["response"]["protocol"]["capabilities"] == ["steering", "probe-sync"]
    else:
        assert out["response"] == {"session": "sess-1"}
    assert not any("SERVE_MODE_MISSING" in line or "rpc slice" in line
                   for line in out["stdout"])


def test_trainer_binary_serves_the_lifecycle_daemon_with_a_manager(tmp_path):
    """``lifecycle.enable`` with a REST manager: the binary boots the daemon
    (the reference's line, before the URL line), serves, exits 0."""
    registry = ModelRegistry()
    srv = ManagerRESTServer(registry, ClusterManager(), rollout=RolloutController(registry))
    srv.serve()
    try:
        out = wire_loop.boot_binary(
            "trainer", "cpu", str(tmp_path), timeout=120,
            argv=["--manager", srv.url, "--scheduler-id", "sched-lifecycle"],
            env={"DRAGONFLY_TRAINER_LIFECYCLE_ENABLE": "true"})
    finally:
        srv.stop()
    assert out["rc"] == 0, out["stderr"]
    assert out["response"] == {"session": "sess-1"}
    line = "trainer: lifecycle daemon on (epoch every 1024 records, regions=['global only'])"
    assert line in out["stdout"]
    assert out["stdout"].index(line) < next(
        i for i, x in enumerate(out["stdout"]) if x.startswith("trainer: ingest on "))


@pytest.mark.parametrize("kind,argv,env,item", [
    ("trainer", ["--manager", "grpc://manager:65003"], {}, "item 12c"),
    ("trainer", [], {"DRAGONFLY_TRAINER_SERVER_GRPC_PORT": "0"}, "item 12c"),
    ("trainer", ["--train-once", ".", "--manager", "grpc://manager:65003"], {}, "item 12c"),
    ("scheduler", [], {"DRAGONFLY_SCHEDULER_SERVER_GRPC_PORT": "0"}, "item 12c"),
    ("scheduler", [], {"DRAGONFLY_SCHEDULER_TRAINER_ENABLE": "true",
                       "DRAGONFLY_SCHEDULER_TRAINER_ADDR": "grpc://trainer:9090"}, "item 12c"),
    ("scheduler", ["--config", "sharded.yaml"], {}, "item 14"),
    ("scheduler", ["--config", "secured.yaml"], {}, "item 14"),
])
def test_refused_options_exit_2_naming_their_item(tmp_path, monkeypatch, capsys, kind, argv,
                                                  env, item):
    (tmp_path / "sharded.yaml").write_text("scheduling: {shard_max_inflight: 512}\n")
    (tmp_path / "secured.yaml").write_text("security: {auto_issue: true}\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("DRAGONFLY_SCHEDULER_STORAGE_DIR", str(tmp_path / "records"))
    monkeypatch.setenv("DRAGONFLY_TRAINER_DATA_DIR", str(tmp_path / "staged"))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    cli = scheduler_cli if kind == "scheduler" else trainer_cli
    assert cli.run(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.startswith(f"{kind}: ") and f"ROADMAP queue 1 {item}" in err, err
    assert not (tmp_path / "records").exists() and not (tmp_path / "staged").exists()


def test_wire_loop_small(tmp_path):
    """The deployment over sockets at a small size on the CPU: the
    Announcer's round after the probe snapshot stages every row written,
    both models register in the manager, the subscription installs the
    activated MLP, every trial is answered with parents, and the seed-made
    scorer served every flush before the swap."""
    s = wire_loop.run(wire_loop.parse_args([
        "--hosts", "60", "--downloads", "120", "--sequential", "8", "--tasks", "6",
        "--probe-rounds", "1", "--clients", "4", "--trials", "8", "--epochs", "1",
        "--train-interval", "1", "--model-poll", "0.2", "--timeout", "60",
        "--out", str(tmp_path), "--device", "cpu",
    ]), log=lambda line: None)
    dl, tr, pc, k1 = (s[k] for k in ("downloads", "train_round", "parent_choice", "k1"))
    assert dl["downloads"] == 120 and dl["sequential"]["downloads"] == 8
    assert dl["schedule_kinds"] == {"PARENTS": 120}
    assert dl["register_peer"]["calls"] == 120
    assert dl["server"]["register_peer"]["requests"] == 120
    assert 0 < dl["service_share_of_server_time"] <= 1
    assert tr["error"] is None and tr["models"] == sorted([MLP_MODEL_NAME, GNN_MODEL_NAME])
    assert tr["rows_staged"] == tr["rows_written"] and tr["rows_written"]["topology"] > 0
    assert tr["rows_written"]["download"] > 120
    assert pc["installed_scorer"] == "MLPScorer" and pc["activation_to_installed_s"] < 60
    for arm in ("k1_seed_scorer", "installed", "rule"):
        assert pc[arm]["trials_with_parents"] == pc[arm]["trials"] == 8
        assert pc[arm]["mb_s"] > 0
    # On the CPU the fused scorer runs its plain version: no K1 launch.
    assert k1["fused_flushes"] > 0 and k1["launches"] == k1["launches_after_swap"] == 0
    assert k1["batcher_fallbacks"] == 0 and k1["rule_degrades"] == 0
    assert s["registered_schedulers"] and s["registered_schedulers"][0].startswith("sched-")
