"""Port parity: the manager recovery drills (the reference's
``tests/test_manager_recovery.py``) on the port's manager binary, run as
child processes (``python -m dragonfly2_tpu_torch.cli.manager``), driven
by the port's clients.

- A manager SIGKILLed with a preheat group in flight restarts on the same
  state directory: the group survives and a late worker completes it,
  pushed topology re-merges, the registry and CRUD rows are intact, and
  the cluster CA's trust root is the same.
- A job a worker popped before the kill re-delivers after the restart.
- The HA acceptance drill: a leader and a hot standby
  (``--replicate-from``), the leader SIGKILLed mid-preheat and never
  restarted; the standby promotes on the lease's expiry (term 2), the
  preheat drains through it, the registry row and its artifact and the
  dynconfig payload keep serving, and the ``ModelSubscriber`` polling the
  pair never pins.  The kill waits until the standby has applied every
  row the leader wrote (its ``applied_seq`` reaches the leader's ``seq``).
- The two crash-between-rows drills of the rollout rows (in process, both
  packages): a reloaded controller adopts an orphan SHADOW candidate, and
  a row torn after the registry's promote follows the registry.
"""

import base64
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_torch_replication import Pkg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:
    import cryptography  # noqa: F401

    _HAS_CRYPTO = True
except ImportError:
    _HAS_CRYPTO = False


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url: str, path: str, body: dict) -> dict:
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read() or b"{}")


def _get(url: str, path: str) -> dict:
    with urllib.request.urlopen(url + path, timeout=10) as r:
        return json.loads(r.read())


class _Manager:
    """The port's manager binary on a FIXED port and state dir, so a
    restart is address-stable."""

    def __init__(self, tmp: str, port: int, *, name: str = "manager",
                 ha_yaml: str = "", extra_args=()):
        self.port = port
        self.cfg_path = os.path.join(tmp, f"{name}.yaml")
        with open(self.cfg_path, "w") as f:
            f.write(f"server: {{host: 127.0.0.1, port: {port}, grpc_port: -1}}\n"
                    f"registry: {{blob_dir: {tmp}/{name}}}\n"
                    f"ca_dir: {tmp}/ca-{name}\n"
                    "jobs_min_requeue_s: 0.01\n" + ha_yaml)
        self.extra_args = list(extra_args)
        self.proc = None
        self.url = f"http://127.0.0.1:{port}"
        self.lines = []

    def start(self) -> None:
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dragonfly2_tpu_torch.cli.manager",
             "--config", self.cfg_path, *self.extra_args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
            env={**os.environ, "PYTHONPATH": REPO})
        ready = threading.Event()
        lines = self.lines = []

        def pump():
            for line in self.proc.stdout:
                lines.append(line)
                if line.startswith("manager: serving"):
                    ready.set()

        threading.Thread(target=pump, daemon=True).start()
        if not ready.wait(60):
            raise AssertionError(f"manager never ready: {lines[-10:]}")

    def sigkill(self) -> int:
        self.proc.send_signal(signal.SIGKILL)
        return self.proc.wait(timeout=30)

    def stop(self) -> None:
        if self.proc and self.proc.poll() is None:
            self.proc.terminate()
            self.proc.wait(timeout=30)


@pytest.mark.skipif(not _HAS_CRYPTO,
                    reason="drill verifies CA trust-root survival; needs `cryptography`")
def test_kill_manager_mid_preheat_recovers(tmp_path):
    from dragonfly2_tpu_torch.jobs.remote import RemoteJobClient, RemoteJobWorker
    from dragonfly2_tpu_torch.security.ca import PeerIdentity

    mgr = _Manager(str(tmp_path), _free_port())
    mgr.start()
    try:
        client = RemoteJobClient(mgr.url)
        group = client.create_group("preheat", {"urls": ["https://origin/blob"]}, ["q-sched-a"])
        gid = group["group_id"]
        _post(mgr.url, "/api/v1/topology", {
            "scheduler_id": "sched-a",
            "edges": [{"src": "h1", "dst": "h2", "average_rtt_ns": 12345}]})
        _post(mgr.url, "/api/v1/models", {
            "name": "parent-bandwidth-mlp", "type": "mlp", "scheduler_id": "sched-a",
            "artifact_b64": base64.b64encode(b"npzbytes").decode()})
        _post(mgr.url, "/api/v1/clusters", {
            "id": "c1", "name": "c1", "scheduler_cluster_config": {"candidate_parent_limit": 7}})
        ident = PeerIdentity.request_from_manager(mgr.url, common_name="daemon-a")
        ca_pem_before = ident.ca_pem

        assert mgr.sigkill() == -9
        with pytest.raises(urllib.error.URLError):
            _get(mgr.url, "/api/v1/jobs")
        mgr.start()

        assert client.group_state(gid)["state"] == "PENDING"
        worker = RemoteJobWorker(mgr.url, "q-sched-a", poll_timeout_s=0.5)
        done = {}
        worker.register("preheat", lambda args: done.setdefault("urls", args["urls"]))
        assert worker.poll_once() is True
        assert done["urls"] == ["https://origin/blob"]
        assert client.group_state(gid)["state"] == "SUCCESS"
        edges = _get(mgr.url, "/api/v1/topology?exclude=sched-b")["edges"]
        assert any(e["src"] == "h1" and e["average_rtt_ns"] == 12345 for e in edges), edges
        models = _get(mgr.url, "/api/v1/models")
        assert any(m["name"] == "parent-bandwidth-mlp" for m in models), models
        assert _get(mgr.url, "/api/v1/clusters/c1:config")["scheduler_cluster_config"] == {
            "candidate_parent_limit": 7}
        renewed = PeerIdentity.request_from_manager(mgr.url, common_name="daemon-a")
        assert renewed.ca_pem == ca_pem_before
    finally:
        mgr.stop()


def test_started_job_redelivers_after_restart(tmp_path):
    from dragonfly2_tpu_torch.jobs.remote import RemoteJobClient, RemoteJobWorker

    mgr = _Manager(str(tmp_path), _free_port())
    mgr.start()
    try:
        client = RemoteJobClient(mgr.url)
        gid = client.create_group("preheat", {"urls": ["u"]}, ["q-s"])["group_id"]
        job = _post(mgr.url, "/api/v1/jobs:poll", {"queue": "q-s", "timeout_s": 2})
        assert job["id"]
        mgr.sigkill()
        mgr.start()
        assert client.group_state(gid)["jobs"][0]["state"] == "STARTED"
        worker = RemoteJobWorker(mgr.url, "q-s", poll_timeout_s=0.3)
        worker.register("preheat", lambda args: "done")
        assert worker.poll_once() is False
        job2 = _post(mgr.url, "/api/v1/jobs:poll", {
            "queue": "q-s", "timeout_s": 2, "requeue_started_after_s": 0.01})
        assert job2["id"] == job["id"]
    finally:
        mgr.stop()


def test_leader_sigkill_with_standby_fails_over_zero_pinning(tmp_path):
    from dragonfly2_tpu_torch.jobs.remote import RemoteJobClient, RemoteJobWorker
    from dragonfly2_tpu_torch.records.features import DOWNLOAD_FEATURE_DIM
    from dragonfly2_tpu_torch.rpc.registry_client import RemoteRegistry
    from dragonfly2_tpu_torch.scheduler import MLEvaluator, ModelSubscriber
    from dragonfly2_tpu_torch.trainer.export import MLPScorer, scorer_to_bytes

    ha_yaml = ("ha: {enable: true, lease_ttl_s: 2.0, poll_interval_s: 0.25, "
               "lease_secret: drill-secret-0123456789abcdef}\n")
    leader = _Manager(str(tmp_path), _free_port(), name="leader", ha_yaml=ha_yaml)
    leader.start()
    standby = _Manager(str(tmp_path), _free_port(), name="standby", ha_yaml=ha_yaml,
                       extra_args=["--replicate-from", leader.url])
    standby.start()
    pair = f"{leader.url},{standby.url}"
    try:
        assert " as leader (term 1) " in leader.lines[-1]
        assert " as standby (term 1) " in standby.lines[-1]
        client = RemoteJobClient(pair)
        gid = client.create_group("preheat", {"urls": ["https://origin/blob"]},
                                  ["q-sched-a"])["group_id"]
        rng = np.random.default_rng(0)
        weights = [(rng.standard_normal((DOWNLOAD_FEATURE_DIM, 1)).astype(np.float32),
                    np.zeros(1, dtype=np.float32))]
        artifact = scorer_to_bytes(MLPScorer(weights=weights))
        created = _post(leader.url, "/api/v1/models", {
            "name": "parent-bandwidth-mlp", "type": "mlp", "scheduler_id": "sched-a",
            "artifact_b64": base64.b64encode(artifact).decode()})
        _post(leader.url, f"/api/v1/models/{created['id']}:activate", {})
        remote = RemoteRegistry(pair, timeout=5.0)
        subscriber = ModelSubscriber(remote, MLEvaluator(), scheduler_id="sched-a")
        assert subscriber.refresh() is True
        assert subscriber.pinned is False

        # The standby has applied every row the leader wrote.
        leader_seq = _get(leader.url, "/api/v1/replication:status")["seq"]
        deadline = time.time() + 15
        health = {}
        while time.time() < deadline:
            health = _get(standby.url, "/api/v1/replication:status")
            if health["applied_seq"] >= leader_seq and health["role"] == "standby":
                break
            time.sleep(0.2)
        assert health["applied_seq"] >= leader_seq, (health, leader_seq)

        assert leader.sigkill() == -9
        assert subscriber.refresh() is False
        assert subscriber.pinned is False, "subscriber pinned with a live standby attached"

        worker = RemoteJobWorker(pair, "q-sched-a", poll_timeout_s=0.5)
        done = {}
        worker.register("preheat", lambda args: done.setdefault("urls", args["urls"]))
        deadline = time.time() + 30
        completed = False
        while time.time() < deadline and not completed:
            try:
                completed = worker.poll_once()
            except ConnectionError:
                time.sleep(0.3)
        assert completed, ("preheat never drained through the promoted follower",
                           standby.lines[-10:])
        assert done["urls"] == ["https://origin/blob"]
        assert client.group_state(gid)["state"] == "SUCCESS"
        status = _get(standby.url, "/api/v1/replication:status")
        assert status["role"] == "leader" and status["term"] >= 2
        assert any(line.startswith("manager: promoted to leader (term 2)")
                   for line in standby.lines), standby.lines[-10:]
        model = remote.active_model("sched-a", "parent-bandwidth-mlp")
        assert model is not None
        assert remote.load_artifact(model) == artifact
        assert "scheduler_cluster_config" in _get(standby.url,
                                                  "/api/v1/clusters/default:config")
        subscriber.refresh()
        assert subscriber.pinned is False
    finally:
        leader.stop()
        standby.stop()


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    p = Pkg(request.param)
    saved = p.utils__faultinject.active()
    yield p
    if saved is None:
        p.utils__faultinject.uninstall()
    else:
        p.utils__faultinject.install(saved)


def test_crash_between_registry_flip_and_rollout_row(tmp_path, pkg):
    reg, state, fi = pkg.manager__registry, pkg.manager__state, pkg.utils__faultinject
    RolloutController = pkg.rollout__controller.RolloutController
    db = str(tmp_path / "state.db")
    backend = state.SQLiteBackend(db)
    registry = reg.ModelRegistry(backend=backend)
    active = registry.create_model(name="ranker", type="mlp", scheduler_id="s1",
                                   artifact=b"\x01" * 4)
    registry.activate(active.id)
    candidate = registry.create_model(name="ranker", type="mlp", scheduler_id="s1",
                                      artifact=b"\x02" * 4)
    controller = RolloutController(registry, backend=backend)
    inj = fi.FaultInjector([fi.FaultSpec(site="state.put.rollouts", kind="drop", at=(0,))])
    with fi.installed(inj):
        with pytest.raises(ConnectionError):
            controller.begin(candidate.id)
    assert registry.get(candidate.id).state is reg.ModelState.SHADOW
    assert backend.table("rollouts").load_all() == {}
    backend.close()

    backend = state.SQLiteBackend(db)
    controller2 = RolloutController(reg.ModelRegistry(backend=backend), backend=backend)
    rollout = controller2.get("s1", "ranker")
    assert rollout is not None, "orphan SHADOW candidate was not adopted"
    assert rollout.model_id == candidate.id
    assert rollout.phase == "shadow"
    assert rollout.previous_active_id == active.id
    assert controller2.report("s1", "ranker", {"joined_edges": 1})["decision"] == "hold"
    backend.close()

    backend = state.SQLiteBackend(db)
    controller3 = RolloutController(reg.ModelRegistry(backend=backend), backend=backend)
    r3 = controller3.get("s1", "ranker")
    assert r3 is not None and r3.model_id == candidate.id
    assert r3.reason == "adopted during crash recovery"
    backend.close()


def test_crash_between_promote_and_rollout_row(tmp_path, pkg):
    reg, state, fi = pkg.manager__registry, pkg.manager__state, pkg.utils__faultinject
    ctl = pkg.rollout__controller
    db = str(tmp_path / "state.db")
    backend = state.SQLiteBackend(db)
    registry = reg.ModelRegistry(backend=backend)
    candidate = registry.create_model(name="ranker", type="mlp", scheduler_id="s1",
                                      artifact=b"\x02" * 4)
    rails = ctl.RolloutGuardrails(min_shadow_samples=1, min_canary_samples=1)
    controller = ctl.RolloutController(registry, guardrails=rails, backend=backend)
    controller.begin(candidate.id)
    clean = {"joined_edges": 10, "regret_at_k": {"candidate": 0.0, "active": 0.0, "k": 3},
             "inversion_rate": {"candidate": 0.0, "active": 0.0}, "psi_max": 0.0}
    assert controller.report("s1", "ranker", clean)["decision"] == "advance"
    inj = fi.FaultInjector([fi.FaultSpec(site="state.put.rollouts", kind="drop", at=(0,))])
    with fi.installed(inj):
        with pytest.raises(ConnectionError):
            controller.report("s1", "ranker", dict(clean, joined_edges=20))
    assert registry.get(candidate.id).state is reg.ModelState.ACTIVE
    backend.close()

    backend = state.SQLiteBackend(db)
    controller2 = ctl.RolloutController(reg.ModelRegistry(backend=backend), backend=backend)
    rollout = controller2.get("s1", "ranker")
    assert rollout is not None
    assert rollout.phase == "active", ("rollout row must follow the committed registry "
                                       "promote", rollout.phase)
    assert "reconciled" in rollout.reason
    backend.close()
