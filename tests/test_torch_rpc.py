"""Port counterparts of the JAX package's ``tests/test_rpc.py`` cases that
need no peer daemon: the hash ring, retry, the trainer wire (the
Announcer to a remote trainer, the chunked upload), concurrent
registrations, and the four-arrow loop (``TestFullWireLoop``) with the
port's manager, scheduler and trainer in child processes on the CPU and
``RemoteScheduler`` clients in place of the daemons.

Every server binds port 0 and is stopped in a ``finally``; every client
call has a timeout.  Port calls pass ``device="cpu"``.
"""

from __future__ import annotations

import json
import os
import select
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu import rpc as jrpc
from dragonfly2_tpu_torch import rpc
from dragonfly2_tpu_torch.cli.scheduler import SchedulerConfig, build
from dragonfly2_tpu_torch.manager import ModelRegistry
from dragonfly2_tpu_torch.records.columnar import ColumnarReader, ColumnarWriter
from dragonfly2_tpu_torch.records.features import DOWNLOAD_COLUMNS
from dragonfly2_tpu_torch.records.synthetic import PIECE_SIZE, SyntheticCluster
from dragonfly2_tpu_torch.rpc import trainer_transport
from dragonfly2_tpu_torch.scheduler.announcer import Announcer
from dragonfly2_tpu_torch.sim.swarm import host_from_latent
from dragonfly2_tpu_torch.trainer.service import MLP_MODEL_NAME, TrainerService
from dragonfly2_tpu_torch.trainer.train import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30.0


@pytest.fixture(scope="module")
def cluster():
    return SyntheticCluster(num_hosts=48, seed=42)


# -- the hash ring and retry, against the reference's ------------------------


@pytest.mark.parametrize("case", ["stable_assignment", "empty_ring"])
def test_hash_ring(case):
    if case == "empty_ring":
        assert rpc.HashRing().pick("x") is None is jrpc.HashRing().pick("x")
        return
    ring, jring = rpc.HashRing(["s1", "s2", "s3"]), jrpc.HashRing(["s1", "s2", "s3"])
    keys = [f"task-{i}" for i in range(200)]
    owners = {k: ring.pick(k) for k in keys}
    assert owners == {k: jring.pick(k) for k in keys}
    assert set(owners.values()) == {"s1", "s2", "s3"}
    # Removing one backend only moves its keys.
    ring.remove("s2")
    jring.remove("s2")
    assert all(ring.pick(k) == (owners[k] if owners[k] != "s2" else jring.pick(k))
               for k in keys)
    assert all(ring.pick(k) in ("s1", "s3") for k in keys)


@pytest.mark.parametrize("case", ["retries_then_succeeds", "exhausted_raises"])
def test_retry(case):
    for retry_call in (rpc.retry_call, jrpc.retry_call):
        calls = []

        def flaky():
            calls.append(1)
            if case == "exhausted_raises" or len(calls) < 3:
                raise (TimeoutError if case == "exhausted_raises" else ConnectionError)("x")
            return "ok"

        if case == "retries_then_succeeds":
            assert retry_call(flaky, attempts=4, sleep=lambda s: None) == "ok"
            assert len(calls) == 3
        else:
            with pytest.raises(TimeoutError):
                retry_call(flaky, attempts=2, sleep=lambda s: None)
            assert len(calls) == 2


# -- the trainer wire ---------------------------------------------------------


class _Shards:
    """The record storage surface the Announcer reads (flush and the two
    shard lists), over shards written here."""

    def __init__(self, downloads, topologies=()):
        self.downloads, self.topologies = list(downloads), list(topologies)

    def flush(self):
        pass

    def download_columnar_paths(self):
        return self.downloads

    def network_topology_columnar_paths(self):
        return self.topologies


def test_announcer_to_remote_trainer(tmp_path, cluster):
    """The scheduler→trainer dataset stream over HTTP: the Announcer
    uploads a columnar shard to a remote trainer, which trains and
    registers the model."""
    registry = ModelRegistry()
    service = TrainerService(registry, data_dir=str(tmp_path / "staged"),
                             train_config=TrainConfig(epochs=2, warmup_steps=5),
                             device="cpu")
    server = rpc.TrainerHTTPServer(service)
    server.serve()
    try:
        shard = tmp_path / "download.dfc"
        with ColumnarWriter(str(shard), DOWNLOAD_COLUMNS) as w:
            w.append(cluster.generate_feature_rows(1500, seed=3))
        client = rpc.RemoteTrainer(server.url, timeout=TIMEOUT)
        announcer = Announcer("sched-9", _Shards([str(shard)]), client,
                              ip="10.0.0.9", hostname="sched-9")
        key = announcer.announce_to_trainer()
        run = client.runs[key]
        assert run.error is None, run.error
        assert run.done.is_set() and run.download_rows == 1500 and run.models
        models = registry.list(scheduler_id="sched-9", name=MLP_MODEL_NAME)
        assert [m.id for m in models] == run.models
    finally:
        server.stop()


def test_chunked_upload_reassembles(tmp_path, cluster, monkeypatch):
    """A shard larger than one chunk arrives byte-identical."""
    service = TrainerService(data_dir=str(tmp_path / "staged"), device="cpu")
    server = rpc.TrainerHTTPServer(service)
    server.serve()
    try:
        shard = tmp_path / "big.dfc"
        with ColumnarWriter(str(shard), DOWNLOAD_COLUMNS) as w:
            w.append(cluster.generate_feature_rows(4000, seed=4))
        assert shard.stat().st_size > 4 * 64 * 1024
        monkeypatch.setattr(trainer_transport, "UPLOAD_CHUNK_BYTES", 64 * 1024)
        client = rpc.RemoteTrainer(server.url, timeout=TIMEOUT)
        session = client.open_train_stream(ip="1.2.3.4", hostname="s", scheduler_id="s")
        session.send_download_shard(str(shard))
        staged = list((tmp_path / "staged").glob("*/download_big.dfc"))
        assert len(staged) == 1
        assert staged[0].read_bytes() == shard.read_bytes()
        assert len(ColumnarReader(str(staged[0]))) == 4000
    finally:
        server.stop()


# -- concurrent registrations --------------------------------------------------


def test_concurrent_registrations_no_500(tmp_path, cluster):
    """Peers registering for one task from many threads at once must all
    get an answer (no FSM race surfacing as a 500)."""
    cfg = SchedulerConfig()
    cfg.storage.dir = str(tmp_path / "records")
    cfg.scheduling.retry_interval_s = 0.0
    service = build(cfg, device="cpu")
    server = rpc.SchedulerHTTPServer(service)
    server.serve()
    try:
        hosts = [host_from_latent(h) for h in cluster.hosts]
        url = "https://origin/contended"
        seed = rpc.RemoteScheduler(server.url, timeout=TIMEOUT)
        res = seed.register_peer(host=hosts[0], url=url)
        seed.set_task_info(res.peer, 2 * PIECE_SIZE, 2, PIECE_SIZE)
        seed.report_pieces_finished(res.peer, [
            {"number": n, "length": PIECE_SIZE, "cost_ns": 10**7} for n in range(2)])
        seed.report_peer_finished(res.peer)
        results, errors = {}, []

        def register(i):
            try:
                client = rpc.RemoteScheduler(server.url, timeout=TIMEOUT)
                results[i] = client.register_peer(host=hosts[i], url=url)
            except Exception as exc:  # collected and asserted below
                errors.append(exc)

        threads = [threading.Thread(target=register, args=(i,)) for i in range(1, 17)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(results) == 16
        assert all(r.schedule is not None and r.schedule.parents for r in results.values())
        # The server counts a request after writing its answer: the last
        # handler thread may still be finishing when its client returns.
        deadline = time.monotonic() + TIMEOUT
        while (server.stats.snapshot()["register_peer"]["requests"] < 17
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert server.stats.snapshot()["register_peer"]["requests"] == 17
    finally:
        server.stop()


# -- the four-arrow loop, each server its own process ------------------------------


def _spawn(procs, argv, env, marker):
    """Start a child, wait for the line starting with ``marker``; → URL."""
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)
    procs.append(proc)  # before any assert: the finally always reaps it
    deadline = time.monotonic() + 60
    while True:
        ready, _, _ = select.select([proc.stdout], [], [], max(deadline - time.monotonic(), 0))
        assert ready, f"{argv} printed no {marker!r} line within 60 s"
        line = proc.stdout.readline()
        assert line, (argv, proc.wait(), proc.stderr.read()[-2000:])
        if line.startswith(marker):
            return line[len(marker):].split()[0].rstrip(",")


def test_four_arrow_loop(tmp_path, cluster):
    """Every arrow a real wire: the manager (REST), the trainer binary and
    the scheduler binary in serve mode, each its own process; peers here
    download through ``RemoteScheduler``; the scheduler's Announcer
    streams the records to the trainer, whose models land in the
    MANAGER process; activation over REST; an ML evaluator subscribed
    over the wire installs the artifact."""
    env = {**os.environ, "PYTHONPATH": REPO}
    manager_code = (
        "import sys, time\n"
        "from dragonfly2_tpu_torch.manager import ModelRegistry\n"
        "from dragonfly2_tpu_torch.manager.cluster import ClusterManager\n"
        "from dragonfly2_tpu_torch.manager.rest import ManagerRESTServer\n"
        "srv = ManagerRESTServer(ModelRegistry(), ClusterManager())\n"
        "srv.serve(); print('READY', srv.url, flush=True); time.sleep(300)\n"
    )
    procs = []
    try:
        murl = _spawn(procs, [sys.executable, "-c", manager_code], env, "READY ")
        turl = _spawn(procs, [
            sys.executable, "-m", "dragonfly2_tpu_torch.cli.trainer", "--device", "cpu",
            "--manager", murl,
        ], {**env, "DRAGONFLY_TRAINER_SERVER_HOST": "127.0.0.1",
            "DRAGONFLY_TRAINER_SERVER_PORT": "0",
            "DRAGONFLY_TRAINER_DATA_DIR": str(tmp_path / "staged"),
            "DRAGONFLY_TRAINER_TRAINING_EPOCHS": "2"}, "trainer: ingest on ")
        surl = _spawn(procs, [
            sys.executable, "-m", "dragonfly2_tpu_torch.cli.scheduler", "--device", "cpu",
        ], {**env, "DRAGONFLY_SCHEDULER_SERVER_HOST": "127.0.0.1",
            "DRAGONFLY_SCHEDULER_SERVER_PORT": "0",
            "DRAGONFLY_SCHEDULER_STORAGE_DIR": str(tmp_path / "records"),
            "DRAGONFLY_SCHEDULER_SCHEDULING_ALGORITHM": "ml",
            "DRAGONFLY_SCHEDULER_SCHEDULING_RETRY_INTERVAL_S": "0",
            "DRAGONFLY_SCHEDULER_MANAGER_ADDR": murl,
            "DRAGONFLY_SCHEDULER_TRAINER_ENABLE": "true",
            "DRAGONFLY_SCHEDULER_TRAINER_ADDR": turl,
            "DRAGONFLY_SCHEDULER_TRAINER_INTERVAL_S": "2"}, "scheduler: serving rpc on ")

        # Peers: one RemoteScheduler each, downloads with parent
        # attribution so the scheduler writes DFC rows.
        hosts = [host_from_latent(h) for h in cluster.hosts]
        index = {h.id: i for i, h in enumerate(hosts)}
        clients = [rpc.RemoteScheduler(surl, timeout=TIMEOUT) for _ in hosts]
        r = np.random.default_rng(0)
        for d in range(160):
            child = int(r.integers(0, len(hosts)))
            res = clients[child].register_peer(host=hosts[child],
                                               url=f"https://origin/wire-{d % 4}")
            peer = res.peer
            if peer.task.content_length < 0:
                clients[child].set_task_info(peer, 4 * PIECE_SIZE, 4, PIECE_SIZE)
            parents = res.schedule.parents if res.schedule is not None else []
            pieces = []
            for n in range(peer.task.total_piece_count):
                if parents:
                    parent = parents[n % len(parents)]
                    pid, bw = parent.id, cluster.bandwidth(index[parent.host.id], child)
                else:
                    pid, bw = "", float(cluster.down_cap[child]) * 0.5
                pieces.append({"number": n, "parent_id": pid, "length": PIECE_SIZE,
                               "cost_ns": int(PIECE_SIZE / bw * 1e9)})
            clients[child].report_pieces_finished(peer, pieces)
            clients[child].report_peer_finished(peer)

        # The Announcer uploads every 2 s: wait for the MLP in the manager.
        registry = rpc.RemoteRegistry(murl, timeout=TIMEOUT)
        deadline = time.monotonic() + 60
        models = []
        while not models and time.monotonic() < deadline:
            time.sleep(0.5)
            models = registry.list(name=MLP_MODEL_NAME)
        assert models, "no model reached the manager within 60 s"
        with urllib.request.urlopen(murl + "/api/v1/schedulers", timeout=TIMEOUT) as resp:
            schedulers = json.loads(resp.read())
        assert [s["id"] for s in schedulers] == [models[0].scheduler_id]
        registry.activate(models[-1].id)

        from dragonfly2_tpu_torch.scheduler import MLEvaluator, ModelSubscriber

        ev = MLEvaluator()
        sub = ModelSubscriber(registry, ev, scheduler_id=models[-1].scheduler_id)
        assert sub.refresh() is True
        assert ev.has_model
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.communicate(timeout=TIMEOUT)

