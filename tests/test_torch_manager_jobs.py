"""Port parity: the job broker, its REST wire, the sync-peers and
image-preheat jobs and the cross-process preheat, ``dragonfly2_tpu_torch``
against ``dragonfly2_tpu``.

The cases of ``tests/test_jobs_remote.py`` (``TestJobsAPI``,
``TestBrokerWireSemantics``, ``TestSchedulerRegistration``,
``TestLiveClusterConfig``, ``TestCrossProcessPreheat``) and of
``tests/test_jobs_extended.py`` (``TestSyncPeers``, ``TestImageResolver``)
run on both packages (``pkg``), the port on the CPU.  The
unauthorized-poll case runs both workers against a stub that answers
401.  The live cluster
config runs the port's scheduler in process; the cross-process preheat
runs the port's three binaries, each its own process.

Then the two packages against each other: the same operations, drawn
from a seeded numpy generator, through both ``JobQueue``s and both
``CrudStore``s on a memory backend give equal group snapshots, equal
``:config`` payloads and equal rows (generated ids and times normalized).
"""

from __future__ import annotations

import importlib
import json
import os
import re
import select
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

import dragonfly2_tpu.jobs as j_jobs
import dragonfly2_tpu.jobs.remote as j_remote
import dragonfly2_tpu.jobs.sync_peers as j_sync
import dragonfly2_tpu.manager as j_manager
import dragonfly2_tpu.manager.crud as j_crud
import dragonfly2_tpu.manager.rest as j_rest
import dragonfly2_tpu.manager.state as j_state
import dragonfly2_tpu.rpc.cluster_client as j_cluster_client
import dragonfly2_tpu.scheduler as j_scheduler
import dragonfly2_tpu.scheduler.announcer as j_announcer
import dragonfly2_tpu.scheduler.resource as j_resource
import dragonfly2_tpu_torch.jobs as t_jobs
import dragonfly2_tpu_torch.jobs.remote as t_remote
import dragonfly2_tpu_torch.jobs.sync_peers as t_sync
import dragonfly2_tpu_torch.manager as t_manager
import dragonfly2_tpu_torch.manager.crud as t_crud
import dragonfly2_tpu_torch.manager.rest as t_rest
import dragonfly2_tpu_torch.manager.state as t_state
import dragonfly2_tpu_torch.rpc.cluster_client as t_cluster_client
import dragonfly2_tpu_torch.scheduler as t_scheduler
import dragonfly2_tpu_torch.scheduler.announcer as t_announcer
import dragonfly2_tpu_torch.scheduler.resource as t_resource

# ``jobs.preheat`` is also the name of a function the package exports.
j_preheat = importlib.import_module("dragonfly2_tpu.jobs.preheat")
t_preheat = importlib.import_module("dragonfly2_tpu_torch.jobs.preheat")

REPO = Path(__file__).resolve().parents[1]
PIECE = 32 * 1024
SEED = 13


def _ns(jobs, preheat, remote, sync, manager, crud, rest, state, cluster_client,
        scheduler, announcer, resource, records, daemon, source, idgen):
    return types.SimpleNamespace(
        JobQueue=jobs.JobQueue, JobState=jobs.JobState, Worker=jobs.Worker,
        ImageResolver=jobs.ImageResolver, parse_manifest_url=jobs.parse_manifest_url,
        preheat_image=jobs.preheat_image, PREHEAT=preheat.PREHEAT,
        make_preheat_handler=preheat.make_preheat_handler,
        RemoteJobClient=remote.RemoteJobClient, RemoteJobWorker=remote.RemoteJobWorker,
        SyncPeers=sync.SyncPeers, SYNC_PEERS=sync.SYNC_PEERS,
        make_sync_peers_handler=sync.make_sync_peers_handler,
        ModelRegistry=manager.ModelRegistry, ClusterManager=manager.ClusterManager,
        SchedulerInstance=manager.SchedulerInstance, CrudStore=crud.CrudStore,
        ManagerRESTServer=rest.ManagerRESTServer, MemoryBackend=state.MemoryBackend,
        RemoteClusterClient=cluster_client.RemoteClusterClient,
        Resource=scheduler.Resource, Announcer=announcer.Announcer, Host=resource.Host,
        Storage=records.Storage, Daemon=daemon.Daemon, source=source, idgen=idgen,
        scheduler=scheduler,
    )


def _jax():
    import dragonfly2_tpu.daemon as daemon
    import dragonfly2_tpu.records.storage as records
    import dragonfly2_tpu.source as source
    import dragonfly2_tpu.utils.idgen as idgen

    return _ns(j_jobs, j_preheat, j_remote, j_sync, j_manager, j_crud, j_rest, j_state,
               j_cluster_client, j_scheduler, j_announcer, j_resource, records, daemon,
               source, idgen)


def _torch():
    import dragonfly2_tpu_torch.daemon as daemon
    import dragonfly2_tpu_torch.records.storage as records
    import dragonfly2_tpu_torch.source as source
    import dragonfly2_tpu_torch.utils.idgen as idgen

    return _ns(t_jobs, t_preheat, t_remote, t_sync, t_manager, t_crud, t_rest, t_state,
               t_cluster_client, t_scheduler, t_announcer, t_resource, records, daemon,
               source, idgen)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    ns = _jax() if request.param == "jax" else _torch()
    ns.name = request.param
    return ns


@pytest.fixture(scope="module")
def _servers():
    """One manager REST server per package for the module (a server's
    stop waits out its poll interval); each test gets a fresh broker and
    cluster table on it."""
    servers = {}
    yield servers
    for server in servers.values():
        server.stop()


@pytest.fixture()
def broker_server(pkg, _servers):
    server = _servers.get(pkg.name)
    if server is None:
        server = _servers[pkg.name] = pkg.ManagerRESTServer(
            pkg.ModelRegistry(), pkg.ClusterManager())
        server.serve()
    server.jobqueue, server.clusters = pkg.JobQueue(), pkg.ClusterManager()
    return server, server.jobqueue


# -- tests/test_jobs_remote.py ------------------------------------------------


class TestJobsAPI:
    def test_group_create_poll_result_roundtrip(self, pkg, broker_server):
        server, jq = broker_server
        client = pkg.RemoteJobClient(server.url)
        group = client.create_group("preheat", {"urls": ["https://o/a"]}, ["q-1", "q-2"])
        assert group["state"] == "PENDING" and len(group["jobs"]) == 2

        worker = pkg.RemoteJobWorker(server.url, "q-1", poll_timeout_s=0.2)
        worker.register("preheat", lambda args: {"ok": args["urls"]})
        assert worker.poll_once() is True
        assert worker.poll_once() is False  # queue drained

        st = client.group_state(group["group_id"])
        states = {j["queue"]: j["state"] for j in st["jobs"]}
        assert states["q-1"] == "SUCCESS" and states["q-2"] == "PENDING"

        worker2 = pkg.RemoteJobWorker(server.url, "q-2", poll_timeout_s=0.2)
        worker2.register("preheat", lambda args: "done")
        worker2.poll_once()
        assert client.group_state(group["group_id"])["state"] == "SUCCESS"

    def test_list_groups_feeds_console(self, pkg, broker_server):
        """GET /api/v1/jobs: recent group snapshots, newest first (the
        console's jobs view)."""
        server, jq = broker_server
        client = pkg.RemoteJobClient(server.url)
        g1 = client.create_group("preheat", {"urls": ["u"]}, ["q-1"])
        g2 = client.create_group("sync_peers", {}, ["q-1", "q-2"])
        with urllib.request.urlopen(server.url + "/api/v1/jobs", timeout=5) as r:
            groups = json.loads(r.read())
        assert [g["group_id"] for g in groups[:2]] == [g2["group_id"], g1["group_id"]]
        assert len(groups[0]["jobs"]) == 2

    def test_handler_failure_reported(self, pkg, broker_server):
        server, jq = broker_server
        client = pkg.RemoteJobClient(server.url)
        group = client.create_group("preheat", {"urls": []}, ["qf"])
        worker = pkg.RemoteJobWorker(server.url, "qf", poll_timeout_s=0.2)

        def boom(args):
            raise RuntimeError("origin 403")

        worker.register("preheat", boom)
        worker.poll_once()
        st = client.group_state(group["group_id"])
        assert st["state"] == "FAILURE"
        assert "origin 403" in st["jobs"][0]["error"]

    def test_unknown_type_fails_job(self, pkg, broker_server):
        server, jq = broker_server
        client = pkg.RemoteJobClient(server.url)
        group = client.create_group("mystery", {}, ["qm"])
        worker = pkg.RemoteJobWorker(server.url, "qm", poll_timeout_s=0.2)
        worker.poll_once()
        assert client.group_state(group["group_id"])["state"] == "FAILURE"

    def test_worker_survives_manager_outage(self, pkg, broker_server):
        server, jq = broker_server
        worker = pkg.RemoteJobWorker(server.url, "qo", poll_timeout_s=0.2,
                                     error_backoff_s=0.05)
        done = []
        worker.register("t", lambda a: done.append(a) or "ok")
        dead = pkg.RemoteJobWorker("http://127.0.0.1:1", "qo", poll_timeout_s=0.2)
        with pytest.raises(ConnectionError):
            dead.poll_once()
        jq.enqueue("t", {"n": 1}, queue_name="qo")
        assert worker.poll_once() is True and done


class TestBrokerWireSemantics:
    def test_poll_skips_expired_jobs(self, pkg, broker_server):
        server, jq = broker_server
        jq.enqueue("t", {"n": 1}, queue_name="qe", expires_at=time.time() - 1)
        live = jq.enqueue("t", {"n": 2}, queue_name="qe")
        worker = pkg.RemoteJobWorker(server.url, "qe", poll_timeout_s=0.2)
        got = []
        worker.register("t", lambda a: got.append(a["n"]))
        assert worker.poll_once() is True
        assert got == [2]  # expired job failed server-side, never delivered
        expired = [j for j in jq.jobs.values() if j.id != live.id][0]
        assert expired.state is pkg.JobState.FAILURE
        assert "expired" in expired.error

    def test_stale_started_requeued(self, pkg, broker_server):
        server, jq = broker_server
        job = jq.enqueue("t", {"n": 1}, queue_name="qs")
        polled = jq.poll("qs", timeout=0.1)
        assert polled is not None and polled.state is pkg.JobState.STARTED
        polled.started_at = time.time() - 600
        again = jq.poll("qs", timeout=0.1, requeue_started_after_s=120)
        assert again is not None and again.id == job.id
        assert again.state is pkg.JobState.STARTED


class _Unauthorized(BaseHTTPRequestHandler):
    """Every request answers 401, as a manager with RBAC does to a
    tokenless caller."""

    def log_message(self, *args):
        pass

    def _deny(self):
        body = b'{"error": "unauthorized"}'
        self.send_response(401)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST = _deny


class TestSchedulerRegistration:
    def test_register_keepalive_and_sync_peers_fanout(self, pkg, broker_server):
        server, jq = broker_server
        link = pkg.RemoteClusterClient(server.url)
        assert link.register_scheduler(id="sched-t", cluster_id="default", hostname="h",
                                       ip="1.2.3.4", port=8002)
        assert [s.id for s in server.clusters.active_schedulers()] == ["sched-t"]
        assert link.keepalive("sched-t") is True
        assert link.keepalive("ghost") is False

        worker = pkg.RemoteJobWorker(server.url, "scheduler:sched-t", poll_timeout_s=0.2)
        worker.register(pkg.SYNC_PEERS, lambda args: [{
            "id": "host-1", "hostname": "h1", "ip": "", "port": 0,
            "download_port": 0, "type": 0, "peer_count": 0,
        }])
        sp = pkg.SyncPeers(jq, server.clusters, job_timeout_s=5.0)
        answered = []
        th = threading.Thread(target=lambda: answered.append(sp.run_once()))
        th.start()
        deadline = time.time() + 4
        while time.time() < deadline and not worker.jobs_done:
            worker.poll_once()
        th.join(timeout=5)
        assert answered == [1]
        assert [r.id for r in sp.list_peers(active_only=True)] == ["host-1"]

    def test_keepalive_loop_reregisters_after_manager_restart(self, pkg, broker_server):
        server, jq = broker_server
        link = pkg.RemoteClusterClient(server.url, keepalive_interval_s=0.05)
        assert link.register_scheduler(id="sched-r")
        server.clusters._schedulers.clear()
        assert link.keepalive("sched-r") is True
        assert [s.id for s in server.clusters.active_schedulers()] == ["sched-r"]
        server.clusters._schedulers.clear()
        link.serve()
        try:
            deadline = time.time() + 3
            while not server.clusters.active_schedulers() and time.time() < deadline:
                time.sleep(0.02)
            assert [s.id for s in server.clusters.active_schedulers()] == ["sched-r"]
        finally:
            link.stop()

    def test_unauthorized_poll_and_register_log_warnings(self, pkg, caplog):
        """A 401 on the poll and on the registration surfaces at WARNING
        (jobs stuck PENDING with only debug logs was the failure mode)."""
        import logging

        srv = ThreadingHTTPServer(("127.0.0.1", 0), _Unauthorized)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            worker = pkg.RemoteJobWorker(url, "scheduler:x", poll_timeout_s=0.2)
            with caplog.at_level(logging.WARNING):
                with pytest.raises(ConnectionError):
                    worker.poll_once()
            assert any("unauthorized" in r.message for r in caplog.records)
            caplog.clear()
            link = pkg.RemoteClusterClient(url)
            with caplog.at_level(logging.WARNING):
                assert link.register_scheduler(id="sched-x") is False
            assert any("unauthorized" in r.message.lower() for r in caplog.records)
        finally:
            srv.shutdown()
            srv.server_close()

    def test_announcer_drives_remote_cluster_link(self, pkg, broker_server, tmp_path):
        server, jq = broker_server
        link = pkg.RemoteClusterClient(server.url)
        ann = pkg.Announcer(
            scheduler_id="sched-a", storage=pkg.Storage(str(tmp_path)),
            trainer=None, cluster_manager=link, cluster_id="c9",
            hostname="hh", ip="9.9.9.9",
        )
        ann.announce_to_manager()
        got = server.clusters.active_schedulers()
        assert [(s.id, s.cluster_id) for s in got] == [("sched-a", "c9")]
        ann.keepalive()


def _call(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"}, method=method)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read() or b"{}")


def test_live_cluster_config_changes_the_next_scheduling_pass(tmp_path):
    """``TestLiveClusterConfig`` on the port, composed in process: an
    update of the default cluster on the port's manager binary reaches the
    port's scheduler in serve mode through dynconfig, and the next
    registration gets one parent where it got several."""
    from dragonfly2_tpu_torch import rpc
    from dragonfly2_tpu_torch.cli import manager as manager_cli
    from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
    from dragonfly2_tpu_torch.config import ManagerConfig, SchedulerConfigFile

    mcfg = ManagerConfig()
    mcfg.server.host, mcfg.server.port = "127.0.0.1", 0
    mcfg.registry.blob_dir = str(tmp_path / "blobs")
    manager = manager_cli.serve(mcfg)
    scfg = SchedulerConfigFile()
    scfg.server.host, scfg.server.port = "127.0.0.1", 0
    scfg.storage.dir = str(tmp_path / "records")
    scfg.scheduling.retry_interval_s = 0.0
    scfg.network_topology.enable = False
    scfg.manager_addr = manager.url
    scfg.dynconfig_refresh_s = 0.2
    serving = None
    try:
        serving = scheduler_cli.serve(scfg, device="cpu")
        serving.job_worker.poll_timeout_s = 0.2
        assert serving.dynconfig.last_refresh_ok
        assert (tmp_path / "records" / "dynconfig_cache.json").exists()
        hosts = [t_resource.Host(id=f"live-{i}", hostname=f"live-{i}", ip="127.0.0.1",
                                 port=8002, download_port=8001) for i in range(5)]
        client = rpc.RemoteScheduler(serving.url, timeout=10)
        url = "https://origin/live-config-blob"
        for h in hosts[:3]:  # three completed parents
            res = client.register_peer(host=h, url=url)
            client.set_task_info(res.peer, 2 * PIECE, 2, PIECE)
            client.report_pieces_finished(res.peer, [
                {"number": n, "length": PIECE, "cost_ns": 10**7} for n in range(2)])
            client.report_peer_finished(res.peer)
        reg = client.register_peer(host=hosts[3], url=url)
        assert reg.schedule is not None and len(reg.schedule.parents) >= 2
        client.report_peer_failed(reg.peer)

        _call(manager.url, "POST", "/api/v1/clusters/default:update",
              {"scheduler_cluster_config": {"candidate_parent_limit": 1,
                                            "filter_parent_limit": 15}})
        deadline = time.time() + 10
        n_parents = 99
        while time.time() < deadline:
            reg = client.register_peer(host=hosts[4], url=url)
            n_parents = len(reg.schedule.parents) if reg.schedule else 0
            client.report_peer_failed(reg.peer)
            if n_parents == 1:
                break
            time.sleep(0.2)
        assert n_parents == 1, f"live scheduler still hands out {n_parents} parents"
        assert serving.service.scheduling.config.candidate_parent_limit == 1
    finally:
        if serving is not None:
            serving.stop()
        manager.stop()


class _RangeOrigin(BaseHTTPRequestHandler):
    BLOB = bytes(i % 251 for i in range(4 * PIECE))
    hits = []

    def log_message(self, *args):
        pass

    def do_HEAD(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.BLOB)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()

    def do_GET(self):
        type(self).hits.append(self.path)
        rng = self.headers.get("Range")
        body, code = self.BLOB, 200
        if rng:
            s, e = rng.split("=", 1)[1].split("-")
            body = self.BLOB[int(s): (int(e) if e else len(self.BLOB) - 1) + 1]
            code = 206
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_rest_preheat_reaches_a_seed_daemon_across_processes(tmp_path):
    """``TestCrossProcessPreheat`` on the port's three binaries, each its
    own process: a REST preheat on the manager binary reaches the
    scheduler binary's job queue and a ``dfdaemon --seed-peer`` process,
    the group reads SUCCESS and the seed holds every piece; then each
    binary exits 0 on SIGINT."""
    procs = []

    def spawn(module, argv, prefix, env):
        proc = subprocess.Popen(
            [sys.executable, "-m", module, *argv], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=str(REPO),
            env={**os.environ, "PYTHONPATH": str(REPO), **env},
        )
        procs.append(proc)
        deadline = time.time() + 60
        while time.time() < deadline:
            ready, _, _ = select.select([proc.stdout], [], [], 60)
            assert ready, f"{module}: silent"
            line = proc.stdout.readline()
            assert line, f"{module} exited: rc {proc.poll()}"
            if line.startswith(prefix):
                threading.Thread(target=lambda: [None for _ in proc.stdout],
                                 daemon=True).start()
                return line.strip()
        raise AssertionError(f"{module}: never printed {prefix!r}")

    origin_srv = ThreadingHTTPServer(("127.0.0.1", 0), _RangeOrigin)
    threading.Thread(target=origin_srv.serve_forever, daemon=True).start()
    layer_urls = [f"http://127.0.0.1:{origin_srv.server_address[1]}/layer-{i}"
                  for i in range(2)]
    _RangeOrigin.hits.clear()
    try:
        mline = spawn("dragonfly2_tpu_torch.cli.manager", [], "manager: serving", {
            "DRAGONFLY_MANAGER_SERVER_HOST": "127.0.0.1",
            "DRAGONFLY_MANAGER_SERVER_PORT": "0",
            "DRAGONFLY_MANAGER_REGISTRY_BLOB_DIR": str(tmp_path / "blobs")})
        manager_url = re.search(r"REST on (\S+)", mline).group(1)
        sline = spawn("dragonfly2_tpu_torch.cli.scheduler", ["--device", "cpu"],
                      "scheduler: serving", {
                          "DRAGONFLY_SCHEDULER_SERVER_HOST": "127.0.0.1",
                          "DRAGONFLY_SCHEDULER_SERVER_PORT": "0",
                          "DRAGONFLY_SCHEDULER_SCHEDULING_RETRY_INTERVAL_S": "0",
                          "DRAGONFLY_SCHEDULER_STORAGE_DIR": str(tmp_path / "records"),
                          "DRAGONFLY_SCHEDULER_MANAGER_ADDR": manager_url})
        sched_url = re.search(r"rpc on (\S+?),", sline).group(1)
        queue = re.search(r"job queue (\S+) on", sline).group(1)
        dline = spawn("dragonfly2_tpu_torch.cli.dfdaemon",
                      ["--scheduler", sched_url, "--seed-peer"], "dfdaemon: serving", {
                          "DF_DAEMON_STATE": str(tmp_path / "d.json"),
                          "DRAGONFLY_DAEMON_SERVER_HOST": "127.0.0.1",
                          "DRAGONFLY_DAEMON_SERVER_PORT": "0",
                          "DRAGONFLY_DAEMON_SERVER_ADVERTISE_IP": "127.0.0.1",
                          "DRAGONFLY_DAEMON_STORAGE_DIR": str(tmp_path / "seedstore"),
                          "DRAGONFLY_DAEMON_PIECE_SIZE": str(PIECE)})
        piece_port = int(re.search(r"pieces on :(\d+)", dline).group(1))

        client = t_remote.RemoteJobClient(manager_url)
        group = client.create_group(t_preheat.PREHEAT,
                                    {"urls": layer_urls, "piece_size": PIECE}, [queue])
        deadline = time.time() + 30
        st = {}
        while time.time() < deadline:
            st = client.group_state(group["group_id"])
            if st["state"] in ("SUCCESS", "FAILURE"):
                break
            time.sleep(0.1)
        assert st["state"] == "SUCCESS", st
        from dragonfly2_tpu_torch.utils import idgen

        for url in layer_urls:
            task_id = idgen.task_id(url)
            bitmap = b""
            deadline = time.time() + 10  # the trigger returns at the first piece
            while time.time() < deadline and bitmap != b"\x01" * 4:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{piece_port}/tasks/{task_id}/pieces",
                        timeout=5) as resp:
                    bitmap = resp.read()
                time.sleep(0.05)
            assert bitmap == b"\x01" * 4, (url, bitmap)
        assert len(_RangeOrigin.hits) == 8  # each layer's 4 pieces, once, to the seed
    finally:
        for proc in reversed(procs):
            proc.send_signal(2)
        rcs = [proc.wait(timeout=30) for proc in reversed(procs)]
        origin_srv.shutdown()
        origin_srv.server_close()
    assert rcs == [0, 0, 0]


# -- tests/test_jobs_extended.py ----------------------------------------------


def _make_host(pkg, i):
    return pkg.Host(id=f"sp-host-{i}", hostname=f"sp-{i}", ip=f"10.9.0.{i}",
                    port=8002, download_port=8001)


class TestSyncPeers:
    def test_merge_and_inactive_marking(self, pkg):
        resource = pkg.Resource()
        for i in range(3):
            resource.store_host(_make_host(pkg, i))
        broker = pkg.JobQueue()
        clusters = pkg.ClusterManager()
        sched = clusters.register_scheduler(
            pkg.SchedulerInstance(id="sched-A", cluster_id="c1", ip="1.1.1.1", port=1))
        worker = pkg.Worker(broker, f"scheduler:{sched.id}")
        worker.register("sync_peers", pkg.make_sync_peers_handler(resource))
        worker.serve()
        try:
            sp = pkg.SyncPeers(broker, clusters, job_timeout_s=10.0)
            assert sp.run_once() == 1
            peers = sp.list_peers("sched-A", active_only=True)
            assert {p.id for p in peers} == {f"sp-host-{i}" for i in range(3)}
            resource.host_manager.delete("sp-host-1")
            sp.run_once()
            active = {p.id for p in sp.list_peers("sched-A", active_only=True)}
            assert active == {"sp-host-0", "sp-host-2"}
            all_recs = {p.id: p.active for p in sp.list_peers("sched-A")}
            assert all_recs["sp-host-1"] is False
        finally:
            worker.stop()

    def test_dead_scheduler_inventory_goes_inactive(self, pkg):
        resource = pkg.Resource()
        resource.store_host(_make_host(pkg, 9))
        broker = pkg.JobQueue()
        clusters = pkg.ClusterManager(keepalive_ttl=0.2)
        sched = clusters.register_scheduler(
            pkg.SchedulerInstance(id="dying", cluster_id="c1", ip="1.1.1.1", port=1))
        worker = pkg.Worker(broker, f"scheduler:{sched.id}")
        worker.register("sync_peers", pkg.make_sync_peers_handler(resource))
        worker.serve()
        try:
            sp = pkg.SyncPeers(broker, clusters, job_timeout_s=10.0)
            sp.run_once()
            assert sp.list_peers("dying", active_only=True)
            time.sleep(0.3)
            sp.run_once()
            assert sp.list_peers("dying", active_only=True) == []
        finally:
            worker.stop()

    def test_job_records_pruned(self, pkg):
        resource = pkg.Resource()
        broker = pkg.JobQueue()
        clusters = pkg.ClusterManager()
        sched = clusters.register_scheduler(
            pkg.SchedulerInstance(id="s", cluster_id="c", ip="1.1.1.1", port=1))
        worker = pkg.Worker(broker, f"scheduler:{sched.id}")
        worker.register("sync_peers", pkg.make_sync_peers_handler(resource))
        worker.serve()
        try:
            sp = pkg.SyncPeers(broker, clusters, interval_s=0.001, job_timeout_s=5.0,
                               prune_age_s=0.01)
            for _ in range(5):
                sp.run_once()
            time.sleep(0.05)
            sp.run_once()
            assert len(broker.jobs) <= 2
        finally:
            worker.stop()

    def test_consumerless_queue_bounded(self, pkg):
        broker = pkg.JobQueue(max_backlog=5)
        jobs = [broker.enqueue("sync_peers", {}, queue_name="dead",
                               expires_at=time.time() + 0.01) for _ in range(12)]
        assert broker._q("dead").qsize() <= 5
        assert sum(1 for j in jobs if "evicted" in j.error) >= 7
        time.sleep(0.05)
        broker.prune(max_age_s=0.01)
        assert len(broker.jobs) == 0

    def test_expired_jobs_not_replayed(self, pkg):
        broker = pkg.JobQueue()
        job = broker.enqueue("sync_peers", {}, queue_name="q", expires_at=time.time() - 1)
        worker = pkg.Worker(broker, "q")
        worker.register("sync_peers", lambda a: ["should-not-run"])
        worker.drain()
        assert job.state.value == "FAILURE" and "expired" in job.error

    def test_unanswered_scheduler_skipped(self, pkg):
        broker = pkg.JobQueue()
        clusters = pkg.ClusterManager()
        clusters.register_scheduler(
            pkg.SchedulerInstance(id="dead", cluster_id="c1", ip="1.1.1.1", port=1))
        sp = pkg.SyncPeers(broker, clusters, job_timeout_s=0.1)
        assert sp.run_once() == 0


LAYERS = ["sha256:l1", "sha256:l2", "sha256:l3"]
TOKEN = "reg-token-1"


class _RegistryHandler(BaseHTTPRequestHandler):
    """Minimal distribution registry: token flow + manifest list + blobs."""

    require_auth = True
    blobs = {}

    def _json(self, code, payload, ctype="application/json", extra=None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        host = f"127.0.0.1:{self.server.server_address[1]}"
        if self.path.startswith("/token"):
            self._json(200, {"token": TOKEN})
            return
        if self.require_auth and self.headers.get("Authorization") != f"Bearer {TOKEN}":
            self._json(401, {"errors": [{"code": "UNAUTHORIZED"}]}, extra={
                "WWW-Authenticate": f'Bearer realm="http://{host}/token",service="reg"'})
            return
        if self.path == "/v2/proj/app/manifests/v1":
            self._json(200, {"manifests": [
                {"digest": "sha256:amd", "platform": {"os": "linux", "architecture": "amd64"}},
                {"digest": "sha256:arm", "platform": {"os": "linux", "architecture": "arm64"}},
            ]}, ctype="application/vnd.oci.image.index.v1+json")
        elif self.path == "/v2/proj/app/manifests/sha256:amd":
            self._json(200, {"layers": [{"digest": d} for d in LAYERS[:2]]},
                       ctype="application/vnd.oci.image.manifest.v1+json")
        elif self.path == "/v2/proj/app/manifests/sha256:arm":
            self._json(200, {"layers": [{"digest": LAYERS[2]}]},
                       ctype="application/vnd.oci.image.manifest.v1+json")
        elif self.path.startswith("/v2/proj/app/blobs/"):
            blob = self.blobs.get(self.path.rsplit("/", 1)[1])
            if blob is None:
                self._json(404, {})
                return
            rng = self.headers.get("Range")
            body, code = blob, 200
            if rng:
                s, e = rng.split("=", 1)[1].split("-")
                body, code = blob[int(s): int(e) + 1], 206
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json(404, {})

    def do_HEAD(self):
        if self.require_auth and self.headers.get("Authorization") != f"Bearer {TOKEN}":
            self.send_error(401)
            return
        blob = self.blobs.get(self.path.rsplit("/", 1)[1])
        if blob is None or "/blobs/" not in self.path:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture
def registry():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _RegistryHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


class TestImageResolver:
    def test_parse_manifest_url(self, pkg):
        base, repo, ref = pkg.parse_manifest_url(
            "https://reg.example/v2/lib/nginx/manifests/1.25")
        assert base == "https://reg.example"
        assert repo == "lib/nginx" and ref == "1.25"
        with pytest.raises(ValueError):
            pkg.parse_manifest_url("https://reg.example/lib/nginx:1.25")

    def test_token_flow_and_platform_filter(self, pkg, registry):
        r = pkg.ImageResolver(username="u", password="p", platform="linux/amd64")
        resolved = r.resolve_layers(f"{registry}/v2/proj/app/manifests/v1")
        assert resolved.urls == [f"{registry}/v2/proj/app/blobs/{d}" for d in LAYERS[:2]]
        assert resolved.headers["Authorization"] == f"Bearer {TOKEN}"

    def test_all_platforms_when_unspecified(self, pkg, registry):
        r = pkg.ImageResolver(username="u", password="p")
        assert len(r.resolve_layers(f"{registry}/v2/proj/app/manifests/v1").urls) == 3

    def test_no_platform_match_raises(self, pkg, registry):
        r = pkg.ImageResolver(username="u", password="p", platform="windows/amd64")
        with pytest.raises(LookupError):
            r.resolve_layers(f"{registry}/v2/proj/app/manifests/v1")

    def test_preheat_carries_auth_to_blob_fetch(self, pkg, registry, tmp_path):
        """The pull token reaches the blob GETs: a seed daemon preheating a
        private registry downloads layer bytes end to end."""
        blob_bytes = {d: bytes([i]) * 8192 for i, d in enumerate(LAYERS)}
        _RegistryHandler.blobs = blob_bytes
        s = pkg.scheduler
        res = s.Resource()
        sched = s.SchedulerService(res, s.Scheduling(s.Evaluator(),
                                                     s.SchedulingConfig(retry_interval=0)),
                                   None, s.NetworkTopology(res.host_manager))
        host = pkg.Host(id="seed-0", hostname="seed-0", ip="127.0.0.1", port=8002,
                        download_port=8001)
        res.store_host(host)
        src_registry = pkg.source.SourceRegistry()
        src_registry.register("http", pkg.source.HTTPSourceClient())
        fetcher = pkg.source.PieceSourceFetcher(registry=src_registry)
        seed = pkg.Daemon(host, sched, storage_root=str(tmp_path / "seed"),
                          source_fetcher=fetcher, prefer_native=False)
        broker = pkg.JobQueue()
        worker = pkg.Worker(broker, "scheduler:s1")
        worker.register(pkg.PREHEAT, pkg.make_preheat_handler(
            seed, content_length_for=fetcher.content_length))
        resolver = pkg.ImageResolver(username="u", password="p", platform="linux/amd64")
        job = pkg.preheat_image(broker, f"{registry}/v2/proj/app/manifests/v1",
                                ["scheduler:s1"], resolver, piece_size=4096)
        worker.drain()
        failures = [j.error for j in broker.jobs.values() if j.error]
        assert broker.group_state(job.group.id).value == "SUCCESS", failures
        for d in LAYERS[:2]:
            tid = pkg.idgen.task_id(f"{registry}/v2/proj/app/blobs/{d}")
            assert seed.read_task_bytes(tid) == blob_bytes[d]

    def test_preheat_image_fans_out_layers(self, pkg, registry):
        broker = pkg.JobQueue()
        r = pkg.ImageResolver(username="u", password="p", platform="linux/amd64")
        captured = {}
        worker = pkg.Worker(broker, "scheduler:s1")
        worker.register(pkg.PREHEAT, lambda args: captured.update(args) or {})
        job = pkg.preheat_image(broker, f"{registry}/v2/proj/app/manifests/v1",
                                ["scheduler:s1"], r)
        worker.drain()
        assert broker.group_state(job.group.id).value == "SUCCESS"
        assert captured["urls"] == [f"{registry}/v2/proj/app/blobs/{d}" for d in LAYERS[:2]]
        assert captured["headers"]["Authorization"] == f"Bearer {TOKEN}"
        assert captured["priority"] == 6  # preheat runs at the background class


# -- the two packages against each other -------------------------------------


def _norm(obj, ids):
    """Replace generated ids (32/12-hex strings) by their order of first
    appearance, and drop times."""
    if isinstance(obj, dict):
        return {k: _norm(v, ids) for k, v in obj.items()
                if k not in ("created_at", "started_at", "finished_at", "updated_at")}
    if isinstance(obj, list):
        return [_norm(v, ids) for v in obj]
    if isinstance(obj, str) and re.fullmatch(r"[0-9a-f]{12}|[0-9a-f]{32}", obj):
        return ids.setdefault(obj, f"id{len(ids)}")
    return obj


def _job_ops(pkg):
    """A seeded sequence of broker operations → the group snapshots."""
    r = np.random.default_rng(SEED)
    jq = pkg.JobQueue(backend=pkg.MemoryBackend())
    groups = []
    for g in range(6):
        queues = [f"scheduler:s{k}" for k in sorted(r.choice(4, int(r.integers(1, 4)),
                                                             replace=False))]
        kind = pkg.PREHEAT if g % 2 == 0 else pkg.SYNC_PEERS
        groups.append(jq.create_group_job(kind, {q: {"urls": [f"https://o/{g}"]}
                                                 for q in queues}).id)
    for q in [f"scheduler:s{k}" for k in range(4)]:
        while True:
            job = jq.poll(q, timeout=0.01)
            if job is None:
                break
            ok = bool(r.random() < 0.7)
            jq.set_result(job.id, pkg.JobState.SUCCESS if ok else pkg.JobState.FAILURE,
                          result={"n": int(r.integers(0, 9))} if ok else None,
                          error="" if ok else "origin 503")
    snaps = [jq.group_snapshot(g) for g in groups]
    return snaps, jq.list_groups()


def test_job_queues_give_equal_group_snapshots():
    ids_j, ids_t = {}, {}
    snaps_j, listed_j = _job_ops(_jax())
    snaps_t, listed_t = _job_ops(_torch())
    assert _norm(snaps_t, ids_t) == _norm(snaps_j, ids_j)
    assert _norm(listed_t, ids_t) == _norm(listed_j, ids_j)
    states = {s["state"] for s in snaps_t}
    assert "SUCCESS" in states and "FAILURE" in states


def _crud_ops(pkg):
    from dataclasses import asdict

    r = np.random.default_rng(SEED + 1)
    crud = pkg.CrudStore(backend=pkg.MemoryBackend())
    crud.ensure_default_cluster()
    for i in range(4):
        crud.create("application", id=f"app-{i}", name=f"app-{i}", url=f"https://a/{i}",
                    priority=int(r.integers(0, 5)))
        crud.create("cluster", id=f"c{i}", name=f"cluster-{i}",
                    scheduler_cluster_config={
                        "candidate_parent_limit": int(r.integers(1, 8)),
                        "filter_parent_limit": int(r.integers(8, 40))},
                    client_config={"load_limit": int(r.integers(10, 100))},
                    scopes={"idc": f"idc-{i}", "cidrs": [f"10.{i}.0.0/16"]},
                    tenant_qos={"t-gold": {"tenant_class": "gold",
                                           "weight": float(r.integers(1, 5))}})
    crud.update("cluster", "c1", scheduler_cluster_config={"filter_parent_limit": 6})
    crud.update("application", "app-2", bio="warm")
    crud.delete("application", "app-3")
    errors = []
    for bad in ({"scheduler_cluster_config": {"filter_parent_limit": "x"}},
                {"scopes": []}, {"nope": 1}):
        try:
            crud.update("cluster", "c2", **bad)
        except (ValueError, TypeError) as exc:
            errors.append(type(exc).__name__)
    configs = [crud.cluster_config(c) for c in ("default", "c0", "c1", "c2", "c3")]
    rows = {k: sorted((asdict(x) for x in crud.list(k)), key=lambda d: d["id"])
            for k in ("application", "cluster", "config")}
    return configs, rows, errors


def test_crud_stores_give_equal_config_payloads_and_rows():
    configs_j, rows_j, errors_j = _crud_ops(_jax())
    configs_t, rows_t, errors_t = _crud_ops(_torch())
    assert configs_t == configs_j and rows_t == rows_j and errors_t == errors_j
    assert configs_t[2]["scheduler_cluster_config"] == {"filter_parent_limit": 6}
    assert len(errors_t) == 3
