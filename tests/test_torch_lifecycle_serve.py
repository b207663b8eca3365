"""The self-driving lifecycle over the wire, on the CPU.

- One reduced deployment (``bench/wire_loop.run --lifecycle``: a manager
  with a ``RolloutController``, ``cli.trainer.serve`` running the
  lifecycle daemon, an ``ml`` scheduler serve with shadow scoring into
  ``storage.dir/shadow_replay.dfc`` and the rollout reporter) walks a
  candidate of the daemon SHADOW → CANARY → ACTIVE with no ``:activate``
  call, and the subscription installs it; candidates the guardrails roll
  back before that are reported apart.  The deployment's controller runs
  with the drift ceiling off: over the wire every host's upload counters
  start at 0 when the scheduler boots and grow with each piece served, so
  the upload-count features' PSI against the trained snapshot grows with
  elapsed time; the sample floors, the regret and the inversion
  guardrails keep the reference's defaults.
- The serve compositions: the trainer's runs the daemon for
  ``scheduler_id`` as the service's online sink and stops it; the
  scheduler's builds the subscriber with ``RolloutRESTClient``, the
  sample rate and the shadow log path, and the reporter at its interval.
- The scheduler config's ``shadow_sample_rate`` and
  ``rollout_report_interval_s`` load and validate as the reference's.
- The daemon's ``lifecycle.register`` / ``lifecycle.report`` fault seams
  defer and retry as the JAX package's daemon does.

Every server binds port 0 and is stopped in a ``finally``.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

import dragonfly2_tpu.config as j_config
import dragonfly2_tpu.lifecycle as j_lifecycle
import dragonfly2_tpu.manager as j_manager
import dragonfly2_tpu.rollout as j_rollout
import dragonfly2_tpu.trainer.export as j_export
import dragonfly2_tpu.utils.faultinject as j_fi
import dragonfly2_tpu_torch.config as t_config
import dragonfly2_tpu_torch.lifecycle as t_lifecycle
import dragonfly2_tpu_torch.manager as t_manager
import dragonfly2_tpu_torch.rollout as t_rollout
import dragonfly2_tpu_torch.trainer.export as t_export
import dragonfly2_tpu_torch.utils.faultinject as t_fi
from dragonfly2_tpu_torch.bench import wire_loop
from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
from dragonfly2_tpu_torch.cli import trainer as trainer_cli
from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS, DOWNLOAD_FEATURE_DIM
from dragonfly2_tpu_torch.rollout.shadow import SHADOW_COLUMNS

MODEL_NAME = "parent-bandwidth-mlp"
JAX = types.SimpleNamespace(config=j_config, lifecycle=j_lifecycle, manager=j_manager,
                            rollout=j_rollout, export=j_export, fi=j_fi)
PORT = types.SimpleNamespace(config=t_config, lifecycle=t_lifecycle, manager=t_manager,
                             rollout=t_rollout, export=t_export, fi=t_fi)


def test_reduced_deployment_walks_to_active_with_no_activate_call(tmp_path):
    s = wire_loop.run(wire_loop.parse_args([
        "--lifecycle", "--hosts", "100", "--downloads", "6000", "--tasks", "8",
        "--clients", "4", "--trials", "4", "--epochs", "1", "--train-interval", "3",
        "--model-poll", "0.2", "--lifecycle-interval", "0.5", "--report-interval", "1",
        "--timeout", "90", "--out", str(tmp_path), "--device", "cpu",
    ]), log=lambda line: None)
    walk, install, rows, k1 = (s[k] for k in ("walk", "install", "rows", "k1"))
    assert [p for p in walk["sampled_phases"] if p is not None] == ["shadow", "canary",
                                                                      "active"]
    # The promoted candidate: hold, then advance, then promote (earlier
    # candidates the guardrails rolled back are listed apart).
    mine = [d["decision"] for d in walk["decisions"] if d["version"] == walk["version"]]
    assert mine[-1] == "promote" and "advance" in mine and "rollback" not in mine, mine
    assert all(v < walk["version"] for v in walk["candidates_before"])
    assert walk["activate_posts"] == 0 and walk["rollout_posts"] >= 1
    assert walk["report_posts"] == len(walk["decisions"])
    # SHADOW: the shadow engine and no canary route; CANARY: both, at 10 %.
    shadow, canary = ({"shadow": True, "canary_percent": p} for p in (None, 10))
    assert walk["serving"][:2] == [shadow, canary], walk["serving"]
    assert all(x in (shadow, canary) for x in walk["serving"]), walk["serving"]
    assert install["installed_version"] == install["active_version"] == walk["version"]
    assert install["installed_scorer"] == "MLPScorer" and install["active_is_daemons"]
    assert install["flushes_checked"] > 0 and install["scores_equal_registry_artifact"]
    assert rows["fed_to_daemon"] == rows["staged_download_rows"] > 0
    assert rows["dropped_by_daemon"] == 0
    assert rows["shadow_rows_on_disk"] == rows["shadow_rows_logged"] > 0
    assert 0 < max(rows["reporter_reads"]) <= rows["shadow_rows_on_disk"]
    assert s["daemon"]["device"] == "cpu" and s["daemon"]["steps"] > 0
    # On the CPU the fused scorer runs its plain version: no K1 launch.
    assert k1["fused_flushes"] > 0 and k1["launches"] == k1["launches_after_swap"] == 0
    assert k1["fused_flushes_after_swap"] == 0
    assert k1["batcher_fallbacks"] == 0 and k1["rule_degrades"] == 0
    for arm in ("k1_seed_scorer", "installed", "rule"):
        assert s["parent_choice"][arm]["trials_with_parents"] == 4
    for t in ("first_byte_to_first_step_s", "first_byte_to_registered_s",
              "registered_to_shadow_s", "shadow_to_canary_s", "canary_to_active_s",
              "active_to_installed_s"):
        assert walk[t] >= 0, t


def test_trainer_serve_runs_the_lifecycle_daemon(tmp_path, capsys):
    registry = t_manager.ModelRegistry()
    srv = ManagerRESTServer(registry, t_manager.ClusterManager(),
                            rollout=t_rollout.RolloutController(registry))
    srv.serve()
    cfg = t_config.TrainerConfigFile()
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.data_dir = str(tmp_path / "staged")
    cfg.lifecycle.enable = True
    cfg.lifecycle.epoch_records = 512
    try:
        serving = trainer_cli.serve(cfg, device="cpu", manager=srv.url,
                                    scheduler_id="sched-x-1")
        try:
            daemon = serving.lifecycle_daemon
            assert serving.service.online_sink is daemon
            assert daemon.config.scheduler_id == "sched-x-1"
            assert daemon.config.epoch_records == 512
            assert isinstance(daemon.client, t_rollout.RolloutRESTClient)
            assert daemon.client.base_url == srv.url
            assert daemon._thread is not None and daemon._thread.is_alive()
        finally:
            serving.stop()
        daemon._thread.join(timeout=30)
        assert not daemon._thread.is_alive()
        out = capsys.readouterr().out.splitlines()
        assert out[0] == ("trainer: lifecycle daemon on (epoch every 512 records, "
                          "regions=['global only'])")
        assert out[1].startswith("trainer: ingest on http://127.0.0.1:")
        # No manager: the reference's line, no daemon.
        cfg.data_dir = str(tmp_path / "staged2")
        serving = trainer_cli.serve(cfg, device="cpu")
        serving.stop()
        assert serving.lifecycle_daemon is None
        assert capsys.readouterr().out.splitlines()[0] == (
            "trainer: lifecycle.enable set but no REST manager attached; "
            "lifecycle daemon not started")
    finally:
        srv.stop()


def test_scheduler_serve_wires_the_rollout_plane(tmp_path):
    registry = t_manager.ModelRegistry()
    srv = ManagerRESTServer(registry, t_manager.ClusterManager(),
                            rollout=t_rollout.RolloutController(registry))
    srv.serve()
    cfg = t_config.SchedulerConfigFile()
    cfg.server.host, cfg.server.port = "127.0.0.1", 0
    cfg.storage.dir = str(tmp_path / "records")
    cfg.scheduling.algorithm = "ml"
    cfg.scheduling.shadow_sample_rate = 0.25
    cfg.scheduling.rollout_report_interval_s = 7.0
    cfg.network_topology.enable = False
    cfg.manager_addr = srv.url
    try:
        serving = scheduler_cli.serve(cfg, device="cpu")
        try:
            sub, reporter = serving.model_subscriber, serving.rollout_reporter
            assert isinstance(sub.rollout_client, t_rollout.RolloutRESTClient)
            assert sub.rollout_client.base_url == srv.url
            assert sub.shadow_sample_rate == 0.25
            assert sub.shadow_log_path == str(tmp_path / "records" / "shadow_replay.dfc")
            assert (tmp_path / "records").is_dir()
            assert reporter.subscriber is sub and reporter.storage is serving.service.storage
            assert isinstance(reporter.client, t_rollout.RolloutRESTClient)
            assert reporter.interval_s == 7.0 and reporter._thread.is_alive()
        finally:
            serving.stop()
        reporter._thread.join(timeout=30)
        assert not reporter._thread.is_alive()
    finally:
        srv.stop()


@pytest.mark.parametrize("text", [
    "scheduling: {shadow_sample_rate: 0.5, rollout_report_interval_s: 12}\n",
    "scheduling: {shadow_sample_rate: 1.0}\n",
    "scheduling: {shadow_sample_rate: 0.0, rollout_report_interval_s: 0.5}\n",
    "scheduling: {shadow_sample_rate: 1.5}\n",
    "scheduling: {shadow_sample_rate: -0.1}\n",
])
def test_rollout_keys_load_and_validate_as_the_reference(tmp_path, text):
    path = tmp_path / "scheduler.yaml"
    path.write_text(text)

    def load(p):
        try:
            s = p.config.load_config(p.config.SchedulerConfigFile, str(path), env=False)
        except p.config.ConfigError as exc:
            return ("error", str(exc))
        return (s.scheduling.shadow_sample_rate, s.scheduling.rollout_report_interval_s)

    assert load(PORT) == load(JAX)


def test_stall_keys_name_item_12c(tmp_path):
    """The stall sweep's keys came with item 12c: they load as the
    reference's, and no message names the item any more."""
    path = tmp_path / "scheduler.yaml"
    path.write_text("scheduling: {stall_max_idle_s: 5, stall_sweep_interval_s: 0.5}\n")
    got = t_config.load_config(t_config.SchedulerConfigFile, str(path), env=False)
    want = j_config.load_config(j_config.SchedulerConfigFile, str(path), env=False)
    assert (got.scheduling.stall_max_idle_s, got.scheduling.stall_sweep_interval_s) == (
        want.scheduling.stall_max_idle_s, want.scheduling.stall_sweep_interval_s) == (5, 0.5)


# -- the daemon's fault seams -------------------------------------------------


def _weights(seed):
    rng = np.random.default_rng(seed)
    dims = (DOWNLOAD_FEATURE_DIM, 16, 1)
    return [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
             rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05)
            for i in range(2)]


class _StubTrainer:
    """The daemon's trainer surface with no training: one step an epoch,
    a fixed exported scorer."""

    def __init__(self, p):
        self.p, self.records_seen = p, 0

    def feed(self, rows, block=True):
        self.records_seen += len(rows)
        return True

    def run(self, max_steps=None, idle_timeout=None):
        return 1

    def export_scorer(self):
        return self.p.export.MLPScorer(weights=_weights(3))


def _replay(key):
    """64 joined edges over 8 announces, the candidate ranking as the
    outcome does."""
    col = {n: i for i, n in enumerate(SHADOW_COLUMNS)}
    shadow = np.zeros((64, len(SHADOW_COLUMNS)), np.float32)
    dl = np.zeros((64, len(DOWNLOAD_COLUMNS)), np.float32)
    for a in range(8):
        r = slice(8 * a, 8 * a + 8)
        shadow[r, col["announce_seq"]] = a
        shadow[r, col["src_bucket"]] = dl[r, 0] = np.arange(8) + 8 * a
        shadow[r, col["dst_bucket"]] = dl[r, 1] = 1000 + a
        shadow[r, col["candidate_rank"]] = np.arange(8)
        shadow[r, col["active_rank"]] = np.arange(8)[::-1]
        dl[r, -1] = np.log1p(np.linspace(100.0, 10.0, 8))
    return shadow, dl


def _seams(p, site):
    reg = p.manager.ModelRegistry()
    ctrl = p.rollout.RolloutController(reg, guardrails=p.rollout.RolloutGuardrails(
        min_shadow_samples=10, min_canary_samples=10))
    daemon = p.lifecycle.LifecycleDaemon(
        reg, p.rollout.LocalRolloutClient(ctrl),
        config=p.lifecycle.LifecycleConfig(scheduler_id="s1", epoch_records=16,
                                           min_joined=10),
        trainer_factory=lambda key: _StubTrainer(p), replay_source=_replay)
    daemon.feed(np.zeros((32, len(DOWNLOAD_COLUMNS)), np.float32))
    inj = p.fi.FaultInjector([p.fi.FaultSpec(site=site, kind="drop", at=(0,))])
    steps = []
    with p.fi.installed(inj):
        for _ in range(4):
            out = daemon.step()
            steps.append({"epochs": [(e["epoch"], e["version"]) for e in out["epochs"]],
                          "reports": [(r["decision"], r.get("phase")) for r in out["reports"]]})
    return {"steps": steps, "history": [(i.site, i.index, i.kind) for i in inj.history],
            "states": [(m.version, m.state.value) for m in reg.list()],
            "lineage": daemon.store.row("global").get("history")}


@pytest.mark.parametrize("site", ["lifecycle.register", "lifecycle.report"])
def test_daemon_fault_seams_equal_the_jax_package(site):
    got = _seams(PORT, site)
    assert got == _seams(JAX, site)
    assert got["history"] == [(site, 0, "drop")]
    if site == "lifecycle.register":
        # The first epoch's registration is cut: nothing registered until
        # the next cycle.
        assert got["steps"][0]["epochs"] == [] and got["steps"][1]["epochs"] == [(1, 1)]
    else:
        # The first report is cut; the next cycle reports.
        assert got["steps"][0]["reports"] == [] and got["steps"][1]["reports"]
