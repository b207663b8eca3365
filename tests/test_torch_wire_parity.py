"""Cross-package wire parity: every JAX client against the port's server
and every port client against the JAX server, on the same seeded
requests.

- ``SchedulerHTTPServer``: one seeded raw request sequence (explicit peer
  ids, so every answer is deterministic) gets the same status and JSON
  from the JAX server and the port's; one seeded client-driven swarm
  gets equal ranked parents (compared by host id) for every pairing of
  the two packages' ``RemoteScheduler`` and ``SchedulerHTTPServer``.
  Both schedulers rank with the rule evaluator and draw candidates and
  probe targets from one seeded generator (the JAX package's
  process-global ``random``, the port's ``random.Random``), as
  ``tests/test_torch_swarm.py`` does in process.
- ``TrainerHTTPServer``: each package's ``RemoteTrainer`` against the
  other's server stages a chunked shard byte-equal to the source, and
  the run view reads back.
- ``ManagerRESTServer``: each package's ``RemoteRegistry`` and
  ``RemoteClusterClient`` against the other's server, and each
  package's ``TopologySync``; a model registered through one package
  loads in both packages' ``load_scorer``.

Every server binds port 0 and is stopped in a ``finally``; every client
call has a timeout.  Port calls pass ``device="cpu"``.
"""

from __future__ import annotations

import json
import random
import urllib.error
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu import rpc as jrpc
from dragonfly2_tpu.manager import ClusterManager as JClusterManager
from dragonfly2_tpu.manager import ModelRegistry as JModelRegistry
from dragonfly2_tpu.manager.rest import ManagerRESTServer as JManagerRESTServer
from dragonfly2_tpu.records.storage import Storage as JStorage
from dragonfly2_tpu.rpc import trainer_transport as jtransport
from dragonfly2_tpu.rpc.cluster_client import RemoteClusterClient as JClusterClient
from dragonfly2_tpu.scheduler import Evaluator as JEvaluator
from dragonfly2_tpu.scheduler import NetworkTopology as JNetworkTopology
from dragonfly2_tpu.scheduler import Probe as JProbe
from dragonfly2_tpu.scheduler import Resource as JResource
from dragonfly2_tpu.scheduler import SchedulerService as JSchedulerService
from dragonfly2_tpu.scheduler import Scheduling as JScheduling
from dragonfly2_tpu.scheduler import SchedulingConfig as JSchedulingConfig
from dragonfly2_tpu.scheduler.resource import Host as JHost
from dragonfly2_tpu.scheduler.topology_sync import TopologySync as JTopologySync
from dragonfly2_tpu.trainer import export as jexport
from dragonfly2_tpu.trainer.service import TrainerService as JTrainerService
from dragonfly2_tpu.trainer.train import TrainConfig as JTrainConfig
from dragonfly2_tpu_torch import rpc
from dragonfly2_tpu_torch.manager import ModelRegistry
from dragonfly2_tpu_torch.manager.cluster import ClusterManager
from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer
from dragonfly2_tpu_torch.records.columnar import ColumnarWriter
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS
from dragonfly2_tpu_torch.records.storage import Storage
from dragonfly2_tpu_torch.records.synthetic import PIECE_SIZE, SyntheticCluster
from dragonfly2_tpu_torch.rpc import trainer_transport
from dragonfly2_tpu_torch.rpc.cluster_client import RemoteClusterClient
from dragonfly2_tpu_torch.scheduler import (
    Evaluator,
    NetworkTopology,
    Probe,
    Resource,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
)
from dragonfly2_tpu_torch.scheduler.resource import Host
from dragonfly2_tpu_torch.scheduler.topology_sync import TopologySync
from dragonfly2_tpu_torch.sim.swarm import host_from_latent
from dragonfly2_tpu_torch.trainer import export
from dragonfly2_tpu_torch.trainer.service import MLP_MODEL_NAME, TrainerService
from dragonfly2_tpu_torch.trainer.train import TrainConfig

TIMEOUT = 30.0
HOSTS, SEED = 40, 7


@pytest.fixture(scope="module")
def cluster():
    return SyntheticCluster(num_hosts=HOSTS, seed=SEED)


def _scheduler(pkg: str, tmp_path, seed: int):
    """A rule-ranking scheduler with a probe store behind its HTTP server,
    candidate sampling and probe targets drawn from one seeded
    generator."""
    if pkg == "jax":
        random.seed(seed)
        resource = JResource()
        service = JSchedulerService(
            resource, JScheduling(JEvaluator(), JSchedulingConfig(retry_interval=0)),
            JStorage(str(tmp_path / "jax_records")), JNetworkTopology(resource.host_manager))
        return jrpc.SchedulerHTTPServer(service)
    rng = random.Random(seed)
    resource = Resource()
    service = SchedulerService(
        resource, Scheduling(Evaluator(), SchedulingConfig(retry_interval=0), rng=rng),
        Storage(str(tmp_path / "port_records")),
        NetworkTopology(resource.host_manager, rng=rng))
    return rpc.SchedulerHTTPServer(service)


def _post(url: str, method: str, body: dict):
    """→ (status, JSON) of ``POST /rpc/<method>``."""
    req = urllib.request.Request(f"{url}/rpc/{method}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


def _raw_sequence(url: str, cluster) -> list:
    """A seeded request sequence with explicit peer ids; each request may
    depend on earlier answers.  → [(method, status, answer)]."""
    r = np.random.default_rng(SEED)
    hosts = [host_from_latent(h) for h in cluster.hosts]
    log = []

    def call(method, body):
        status, answer = _post(url, method, body)
        log.append((method, status, answer))
        return answer

    for h in hosts:
        wire = rpc.scheduler_server.host_to_wire(h)
        wire["cpu_percent"] = h.stats.cpu.percent
        wire["mem_used_percent"] = h.stats.memory.used_percent
        call("announce_host", {"host": wire, "protocol_version": 2})
    call("announce_host", {"host": rpc.scheduler_server.host_to_wire(hosts[0])})  # v1
    call("announce_host", {"host": rpc.scheduler_server.host_to_wire(hosts[0]),
                           "protocol_version": 0})
    for d in range(48):
        child = int(r.integers(0, HOSTS))
        peer = f"peer-{d}"
        reg = call("register_peer", {"host_id": hosts[child].id,
                                     "url": f"https://origin/raw-{d % 3}", "peer_id": peer})
        if reg.get("content_length", 0) < 0:
            call("set_task_info", {"peer_id": peer, "content_length": 3 * PIECE_SIZE,
                                   "total_piece_count": 3, "piece_size": PIECE_SIZE})
        parents = [p["peer_id"] for p in reg.get("parents", [])]
        if d % 11 == 5 and parents:
            call("report_piece_failed", {"peer_id": peer, "parent_id": parents[0]})
        call("report_pieces_finished", {"peer_id": peer, "pieces": [
            {"number": n, "parent_id": parents[n % len(parents)] if parents else "",
             "length": PIECE_SIZE, "cost_ns": int(1e7 * (1 + n + d % 5))}
            for n in range(3)]})
        call("report_peer_finished" if d % 7 else "report_peer_failed", {"peer_id": peer})
    for h in hosts[:8]:
        targets = call("sync_probes_start", {"host_id": h.id})["targets"]
        call("sync_probes_finished", {"host_id": h.id, "results": [
            [t["id"], 1_000_000 + 1000 * k] for k, t in enumerate(targets)]})
    call("topology_rtt", {"src": hosts[0].id, "dst": hosts[1].id})
    call("leave_peer", {"peer_id": "peer-3"})
    call("register_peer", {"host_id": "never-announced", "url": "https://origin/x"})
    call("report_peer_finished", {"peer_id": "no-such-peer"})
    call("nope", {})
    return log


def test_scheduler_server_answers_equal(tmp_path, cluster):
    """The same raw requests get the same status and JSON from the JAX
    scheduler server and the port's."""
    logs = {}
    for pkg in ("jax", "port"):
        server = _scheduler(pkg, tmp_path, SEED)
        server.serve()
        try:
            logs[pkg] = _raw_sequence(server.url, cluster)
        finally:
            server.stop()
    assert len(logs["jax"]) == len(logs["port"]) > 100
    for j, t in zip(logs["jax"], logs["port"]):
        assert j == t
    statuses = {s for _, s, _ in logs["port"]}
    assert statuses == {200, 404}
    assert logs["port"][0][2]["protocol"]["negotiated"] == 2
    assert logs["port"][HOSTS][2]["protocol"]["negotiated"] == 1


def _client_swarm(client_cls, url: str, cluster) -> list:
    """A seeded client-driven swarm → the ranked parents' host ids of
    every registration, the probe targets, the schedule kinds."""
    r = np.random.default_rng(SEED + 1)
    host_cls = JHost if client_cls is jrpc.RemoteScheduler else Host
    hosts = []
    for h in cluster.hosts:
        p = host_from_latent(h)
        host = host_cls(id=p.id, hostname=p.hostname, ip=p.ip, port=p.port,
                        download_port=p.download_port, type=p.type,
                        concurrent_upload_limit=p.concurrent_upload_limit)
        host.stats.network.idc = p.stats.network.idc
        host.stats.network.location = p.stats.network.location
        hosts.append(host)
    index = {h.id: i for i, h in enumerate(hosts)}
    client = client_cls(url, timeout=TIMEOUT)
    log = []
    for d in range(60):
        child = int(r.integers(0, HOSTS))
        res = client.register_peer(host=hosts[child], url=f"https://origin/swarm-{d % 4}")
        sched = res.schedule
        parents = list(sched.parents) if sched is not None else []
        log.append((hosts[child].id, sched.kind.name, [p.host.id for p in parents]))
        peer = res.peer
        if peer.task.content_length < 0:
            client.set_task_info(peer, 4 * PIECE_SIZE, 4, PIECE_SIZE)
        pieces = []
        for n in range(peer.task.total_piece_count):
            if parents:
                parent = parents[n % len(parents)]
                pid = parent.id
                bw = cluster.bandwidth(index[parent.host.id], child, noise=False)
            else:
                pid, bw = "", float(cluster.down_cap[child]) * 0.5
            pieces.append({"number": n, "parent_id": pid, "length": PIECE_SIZE,
                           "cost_ns": int(PIECE_SIZE / bw * 1e9)})
        client.report_pieces_finished(peer, pieces)
        client.report_peer_finished(peer)
    for h in hosts[:6]:
        targets = client.sync_probes_start(h)
        log.append(("probe", h.id, [t.id for t in targets]))
        client.sync_probes_finished(h, [(t.id, 2_000_000) for t in targets])
    return log


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_ranked_parents_equal_across_packages(tmp_path, cluster, server, client):
    """One seeded swarm through every pairing of client and server gives
    the JAX client on the JAX server's ranked parents, by host id."""
    logs = {}
    for srv_pkg, cli_pkg in (("jax", "jax"), (server, client)):
        srv = _scheduler(srv_pkg, tmp_path / f"{srv_pkg}-{cli_pkg}", SEED)
        srv.serve()
        try:
            logs[(srv_pkg, cli_pkg)] = _client_swarm(
                jrpc.RemoteScheduler if cli_pkg == "jax" else rpc.RemoteScheduler,
                srv.url, cluster)
        finally:
            srv.stop()
    want, got = logs[("jax", "jax")], logs[(server, client)]
    assert got == want
    assert sum(1 for e in want if e[0] != "probe" and e[2]) > 40
    assert sum(len(e[2]) for e in want if e[0] == "probe") > 10


# -- the trainer wire -----------------------------------------------------------


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_trainer_wire_across_packages(tmp_path, cluster, monkeypatch, client, server):
    """A chunked shard staged byte-equal to the source and the run read
    back, across the packages.  The port server trains (one epoch); the
    JAX one gets too few rows to train (its answer's shape is the point)."""
    rows = 1500 if server == "port" else 40
    shard = tmp_path / "download.dfc"
    with ColumnarWriter(str(shard), DOWNLOAD_COLUMNS) as w:
        w.append(cluster.generate_feature_rows(rows, seed=5))
    staged_dir = tmp_path / "staged"
    if server == "port":
        service = TrainerService(data_dir=str(staged_dir), device="cpu",
                                 train_config=TrainConfig(epochs=1, warmup_steps=2))
        srv = rpc.TrainerHTTPServer(service)
    else:
        service = JTrainerService(data_dir=str(staged_dir),
                                  train_config=JTrainConfig(epochs=1, warmup_steps=2))
        srv = jrpc.TrainerHTTPServer(service)
    transport = jtransport if client == "jax" else trainer_transport
    monkeypatch.setattr(transport, "UPLOAD_CHUNK_BYTES", 16 * 1024)
    srv.serve()
    try:
        remote = (jrpc.RemoteTrainer if client == "jax" else rpc.RemoteTrainer)(
            srv.url, timeout=TIMEOUT)
        session = remote.open_train_stream(ip="10.0.0.2", hostname="s2", scheduler_id="s2")
        session.send_download_shard(str(shard))
        staged = list(staged_dir.glob("*/download_download.dfc"))
        assert len(staged) == 1 and staged[0].read_bytes() == shard.read_bytes()
        key = session.close_and_train()
        run = remote.runs[key]
        assert run.key == key and run.error is None and run.done.is_set()
        assert run.download_rows == rows and run.topology_rows == 0
        if server == "port":
            assert [service.registry.get(m).name for m in run.models] == [MLP_MODEL_NAME]
            assert set(run.metrics) == {MLP_MODEL_NAME}
            assert run.metrics[MLP_MODEL_NAME].mae > 0
        else:
            assert run.models == [] and run.metrics == {}
        # A second close of the same session answers the same run key.
        assert remote._post_json("/train/close", {"session": session._session_id}) == {
            "run": key}
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(srv.url + "/train/run?key=nope", timeout=TIMEOUT)
        assert exc.value.code == 404
    finally:
        srv.stop()


# -- the manager's REST surface ---------------------------------------------------


def _weights():
    rng = np.random.default_rng(0)
    dims = (32, 64, 64, 1)
    return [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
             rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05)
            for i in range(3)]


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax")])
def test_manager_rest_across_packages(client, server):
    """Registry, cluster and topology clients of one package against the
    other package's manager; the model registered through the wire loads
    in both packages."""
    if server == "port":
        srv = ManagerRESTServer(ModelRegistry(), ClusterManager())
    else:
        srv = JManagerRESTServer(JModelRegistry(), JClusterManager())
    jax_client = client == "jax"
    srv.serve()
    try:
        registry = (jrpc.RemoteRegistry if jax_client else rpc.RemoteRegistry)(
            srv.url, timeout=TIMEOUT)
        blob = export.scorer_to_bytes(export.MLPScorer(weights=_weights()))
        assert registry.active_model("sched-1", MLP_MODEL_NAME) is None
        m = registry.create_model(name=MLP_MODEL_NAME, type="mlp", scheduler_id="sched-1",
                                  artifact=blob, evaluation={"mae": 0.5})
        assert (m.name, m.type, m.version, m.scheduler_id, m.evaluation) == (
            MLP_MODEL_NAME, "mlp", 1, "sched-1", {"mae": 0.5})
        assert [x.id for x in registry.list(scheduler_id="sched-1")] == [m.id]
        got = registry.get(m.id)
        assert (got.id, got.version, got.state, got.artifact_digest) == (
            m.id, m.version, m.state, m.artifact_digest) and got.artifact_digest
        assert registry.get("no-such-model") is None
        assert registry.candidate_model("sched-1", MLP_MODEL_NAME) is None
        active = registry.activate(m.id)
        assert active.state.value == "active"
        assert registry.active_model("sched-1", MLP_MODEL_NAME).id == m.id
        got = registry.load_artifact(active)
        assert got == blob
        feats = np.random.default_rng(1).standard_normal((16, 32)).astype(np.float32)
        np.testing.assert_array_equal(export.load_scorer(got).score(feats),
                                      jexport.load_scorer(got).score(feats))
        assert registry.deactivate(m.id).state.value != "active"
        assert registry.active_model("sched-1", MLP_MODEL_NAME) is None
        with pytest.raises(KeyError):
            registry.activate("no-such-model")

        clusters = (JClusterClient if jax_client else RemoteClusterClient)(
            srv.url, timeout=TIMEOUT)
        assert clusters.register_scheduler(id="sched-1", cluster_id="c1", hostname="h",
                                           ip="127.0.0.1", port=8002)
        assert clusters.keepalive("sched-1") and not clusters.keepalive("sched-unknown")
        with urllib.request.urlopen(srv.url + "/api/v1/schedulers", timeout=TIMEOUT) as r:
            assert json.loads(r.read()) == [{"id": "sched-1", "cluster_id": "c1",
                                             "ip": "127.0.0.1", "port": 8002,
                                             "state": "active"}]

        # Topology: this package's sync pushes its edges and pulls the
        # other replica's, which the other package's sync pushed.
        mine = (JNetworkTopology if jax_client else NetworkTopology)()
        theirs = (NetworkTopology if jax_client else JNetworkTopology)()
        mine.enqueue_probe("a", "b", (JProbe if jax_client else Probe)(
            host_id="b", rtt_ns=5_000))
        theirs.enqueue_probe("c", "d", (Probe if jax_client else JProbe)(
            host_id="d", rtt_ns=7_000))
        other = (TopologySync if jax_client else JTopologySync)(theirs, srv.url, "sched-2",
                                                               timeout=TIMEOUT)
        sync = (JTopologySync if jax_client else TopologySync)(mine, srv.url, "sched-1",
                                                              timeout=TIMEOUT)
        assert other.sync_once() == 0
        assert sync.sync_once() == 1
        assert mine.average_rtt("c", "d") == 7_000
        assert other.sync_once() == 1 and theirs.average_rtt("a", "b") == 5_000
    finally:
        srv.stop()


@pytest.mark.parametrize("path", ["/api/v1/rollouts", "/api/v1/users", "/api/v1/buckets",
                                  "/api/v1/certs:ca", "/api/v1/replication:status",
                                  "/api/v1/oauth:providers", "/api/v1/pats"])
def test_unported_routes_answer_404_as_the_reference_without_them(path):
    """Routes whose backing object the reference's server was not given
    answer 404 there; the port's server, which takes none, answers 404."""
    codes = []
    for srv in (ManagerRESTServer(ModelRegistry(), ClusterManager()),
                JManagerRESTServer(JModelRegistry(), JClusterManager())):
        srv.serve()
        try:
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(srv.url + path, timeout=TIMEOUT)
            codes.append(exc.value.code)
        finally:
            srv.stop()
    assert codes == [404, 404]
