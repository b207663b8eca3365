"""Cluster e2e: dfget + preheat + the train→activate→evaluator loop
against a COMPOSED cluster of the port (reference: test/e2e run inside
kind, Makefile:358-366).

Addresses come from the environment, so the same script drives both the
docker-compose topology (service hostnames) and ``run_local``'s process
topology (loopback).  Exit code 0 = every stage passed.

Stages:
  1. liveness — manager /healthy, scheduler registered with the manager;
  2. back-to-source + P2P — daemon A pulls a blob from the origin,
     daemon B gets the same blob WITHOUT new origin fetches;
  3. preheat — a REST job fans to the scheduler's queue and the seed
     daemon warms the layer from the origin;
  4. learning loop — records stream to the trainer, the model lands in
     the MANAGER, REST activation flips it live, and a scheduler-side
     ML evaluator subscriber hot-swaps to the trained scorer;
  5. live cluster config — a PATCH on the manager changes the RUNNING
     scheduler's candidate-parent limit through dynconfig (observed on
     the scheduling wire, not just the config endpoint);
  6. multi-replica (with ``SCHEDULER_B_URL``) — tasks land on their
     ring owners, and a probe pushed to replica A ranks on replica B.

Port of ``deploy/e2e_loop.py``: stages 1-6 as there, over the port's
modules.  Each ``e2e:`` line ends with its stage's seconds so far
(``[stage N: S s]``).  Stage 4 also shows where the round trained: the
trainer's run record names the device its parameters lie on, which must
be ``TRAINER_DEVICE``'s type (``cuda`` unless set), and the round's
seconds.

  python -m dragonfly2_tpu_torch.deploy.e2e_loop
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

MANAGER = os.environ.get("MANAGER_URL", "http://127.0.0.1:65003")
SCHEDULER = os.environ.get("SCHEDULER_URL", "http://127.0.0.1:8002")
DAEMON_A = os.environ.get("DAEMON_A_CONTROL", "http://127.0.0.1:65010")
DAEMON_B = os.environ.get("DAEMON_B_CONTROL", "http://127.0.0.1:65011")
ORIGIN_BIND = os.environ.get("ORIGIN_BIND", "127.0.0.1:8099")
ORIGIN_URL = os.environ.get("ORIGIN_URL", "http://127.0.0.1:8099")
TRAINER_DEVICE = os.environ.get("TRAINER_DEVICE", "cuda")
PIECE = 64 * 1024
BLOB = bytes(i % 251 for i in range(4 * PIECE))


class _Stage:
    """The running stage and when it began: each line carries its
    stage's seconds so far."""

    number = 0
    t0 = 0.0

    @classmethod
    def begin(cls, number: int) -> None:
        cls.number, cls.t0 = number, time.perf_counter()


def log(msg: str) -> None:
    print(f"e2e: {msg} [stage {_Stage.number}: "
          f"{time.perf_counter() - _Stage.t0:.3f} s]", flush=True)


def call(base, method, path, body=None, timeout=30):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        base + path, data=data,
        headers={"Content-Type": "application/json"}, method=method,
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def wait_for(what, fn, timeout=120):
    deadline = time.time() + timeout
    last = None
    while time.time() < deadline:
        try:
            out = fn()
            if out:
                return out
            last = "falsy"
        except Exception as exc:  # noqa: BLE001 — booting cluster
            last = exc
        # 0.2s granularity: the loop runs ~20 waits per drill and a 1s
        # poll overshoots each by ~0.5s — pure dead time on local wires.
        time.sleep(0.2)
    raise SystemExit(f"e2e: TIMEOUT waiting for {what}: {last}")


class _Origin(BaseHTTPRequestHandler):
    hits = []

    def log_message(self, *args):
        pass

    def do_HEAD(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(BLOB)))
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()

    def do_GET(self):
        type(self).hits.append(self.path)
        rng = self.headers.get("Range")
        body, code = BLOB, 200
        if rng:
            s, e = rng.split("=", 1)[1].split("-")
            body = BLOB[int(s): (int(e) if e else len(BLOB) - 1) + 1]
            code = 206
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def main() -> int:
    host, port = ORIGIN_BIND.rsplit(":", 1)
    origin = ThreadingHTTPServer((host, int(port)), _Origin)
    threading.Thread(target=origin.serve_forever, daemon=True).start()

    # -- 1. liveness --------------------------------------------------------
    _Stage.begin(1)
    wait_for("manager", lambda: call(MANAGER, "GET", "/api/v1/healthy")["ok"])
    scheds = wait_for(
        "scheduler registration",
        lambda: call(MANAGER, "GET", "/api/v1/schedulers"),
    )
    sched_id = scheds[0]["id"]
    log(f"manager healthy; scheduler {sched_id} registered")
    wait_for("daemon A", lambda: call(DAEMON_A, "GET", "/healthy")["ok"])
    wait_for("daemon B", lambda: call(DAEMON_B, "GET", "/healthy")["ok"])

    # -- 2. back-to-source then P2P -----------------------------------------
    _Stage.begin(2)
    url = f"{ORIGIN_URL}/blob-1"
    r = call(DAEMON_A, "POST", "/download",
             {"url": url, "piece_size": PIECE}, timeout=120)
    assert r.get("ok"), r
    hits_after_seed = len(_Origin.hits)
    assert hits_after_seed > 0, "daemon A never reached the origin"
    log(f"daemon A seeded blob-1 ({r['pieces']} pieces, "
        f"{'source' if r.get('back_to_source') else 'p2p'})")

    r = call(DAEMON_B, "POST", "/download",
             {"url": url, "piece_size": PIECE}, timeout=120)
    assert r.get("ok"), r
    assert not r.get("back_to_source"), "daemon B fell back to source"
    assert len(_Origin.hits) == hits_after_seed, "P2P still hit the origin"
    log("daemon B fetched blob-1 P2P, origin untouched")

    # -- 3. preheat through the job plane -----------------------------------
    _Stage.begin(3)
    group = call(MANAGER, "POST", "/api/v1/jobs", {
        "type": "preheat",
        "args": {"urls": [f"{ORIGIN_URL}/layer-0"], "piece_size": PIECE},
        "queues": [f"scheduler:{sched_id}"],
    })
    state = wait_for(
        "preheat job",
        lambda: (lambda s: s if s["state"] in ("SUCCESS", "FAILURE") else None)(
            call(MANAGER, "GET", f"/api/v1/jobs/{group['group_id']}")
        ),
    )
    assert state["state"] == "SUCCESS", state
    log("preheat fanned to the scheduler queue and the seed daemon served it")

    # -- 4. the learning loop -----------------------------------------------
    # Records → trainer ingest → model in the MANAGER → activate → a
    # scheduler-side ML evaluator pulls the artifact (the evaluator seam).
    _Stage.begin(4)
    from ..records.columnar import ColumnarWriter
    from ..records.features import DOWNLOAD_COLUMNS
    from ..records.synthetic import SyntheticCluster
    from ..rpc import RemoteRegistry, RemoteTrainer
    from ..scheduler import MLEvaluator, ModelSubscriber

    trainer_url = os.environ.get("TRAINER_URL", "http://trainer:9090")
    # A directory of its own, not a fixed /tmp name: runs side by side
    # must not write one shard.
    shard_dir = tempfile.mkdtemp(prefix="e2e-")
    shard = os.path.join(shard_dir, "e2e_download.dfc")
    cluster = SyntheticCluster(num_hosts=64, seed=3)
    with ColumnarWriter(shard, DOWNLOAD_COLUMNS) as w:
        w.append(cluster.generate_feature_rows(2000, seed=7))
    trainer = RemoteTrainer(trainer_url, timeout=600)
    session = trainer.open_train_stream(
        ip="0.0.0.0", hostname="e2e", scheduler_id=sched_id
    )
    session.send_download_shard(shard)
    shutil.rmtree(shard_dir, ignore_errors=True)
    key = session.close_and_train()
    run = trainer.runs[key]
    assert run.error is None, run.error
    # The round trained on the trainer's device, not only somewhere.
    assert run.device.split(":")[0] == TRAINER_DEVICE.split(":")[0], (
        f"trainer run {key} trained on {run.device!r}, not {TRAINER_DEVICE!r}"
    )
    log(f"trainer run {key} finished on {run.device} in {run.seconds:.3f} s")

    registry = RemoteRegistry(MANAGER)
    models = wait_for(
        "model in manager",
        lambda: registry.list(scheduler_id=sched_id, name="parent-bandwidth-mlp"),
    )
    registry.activate(models[0].id)
    active = registry.active_model(sched_id, "parent-bandwidth-mlp")
    assert active is not None and active.id == models[0].id
    evaluator = MLEvaluator()
    sub = ModelSubscriber(registry, evaluator, scheduler_id=sched_id)
    assert sub.refresh() is True and evaluator.has_model
    log(f"model v{active.version} activated; ML evaluator hot-swapped")

    # -- 5. live cluster config ----------------------------------------------
    # PATCH on the manager → the RUNNING scheduler's next pass caps
    # candidate parents at 1, observed via a real registration.
    _Stage.begin(5)
    from ..rpc import RemoteScheduler
    from ..scheduler.resource import Host

    call(MANAGER, "POST", "/api/v1/clusters/default:update",
         {"scheduler_cluster_config": {
             "candidate_parent_limit": 1, "filter_parent_limit": 15}})
    # Multi-replica: blob-1's swarm state lives on its consistent-hash
    # owner — register the probe peer THERE (any other replica answers
    # the wrong-shard steering redirect).  Ownership is the MANAGER's
    # published shard ring (DESIGN.md §24), the same map the shards'
    # guards enforce — never a locally invented hash.
    scheduler_for_blob1 = SCHEDULER
    if os.environ.get("SCHEDULER_B_URL"):
        from ..scheduler.sharding import ShardRing
        from ..utils import idgen

        published = ShardRing.from_payload(
            call(MANAGER, "GET", "/api/v1/clusters/default:config")
            ["scheduler_ring"]
        )
        scheduler_for_blob1 = published.url_of(
            published.owner(idgen.task_id(url))
        )
    client = RemoteScheduler(scheduler_for_blob1)
    probe_host = Host(id="e2e-probe", hostname="e2e-probe", ip="127.0.0.1",
                      download_port=1)

    def parents_now():
        reg = client.register_peer(host=probe_host, url=url)
        n = len(reg.schedule.parents) if reg.schedule else 0
        client.report_peer_failed(reg.peer)
        return n

    n_parents = wait_for(
        "live candidate limit", lambda: parents_now() == 1 and 1, timeout=60
    )
    log(f"cluster-config PATCH applied live: {n_parents} candidate parent")

    # -- 6. multi-replica: steering + cross-replica topology ----------------
    scheduler_b = os.environ.get("SCHEDULER_B_URL", "")
    if scheduler_b:
        _Stage.begin(6)
        from ..scheduler.sharding import ShardRing
        from ..utils import idgen

        ring_payload = call(
            MANAGER, "GET", "/api/v1/clusters/default:config"
        )["scheduler_ring"]
        assert len(ring_payload["members"]) == 2, ring_payload
        shard_ring = ShardRing.from_payload(ring_payload)
        # Find a blob whose task the PUBLISHED ring places on EACH
        # replica, download both through daemon A, and verify the swarm
        # state lives exactly on the ring-predicted owner (a child
        # registration there sees daemon A as a parent).
        owners = {}
        i = 0
        while len(set(owners.values())) < 2 and i < 64:
            name = f"steer-{i}"
            owners[name] = shard_ring.url_of(
                shard_ring.owner(idgen.task_id(f"{ORIGIN_URL}/{name}"))
            )
            i += 1
        assert len(set(owners.values())) == 2, "hash ring never split"
        picks = {}
        for name, owner in owners.items():
            if owner not in picks:
                picks[owner] = name
        for owner_url, name in picks.items():
            url2 = f"{ORIGIN_URL}/{name}"
            r = call(DAEMON_A, "POST", "/download",
                     {"url": url2, "piece_size": PIECE}, timeout=120)
            assert r.get("ok"), r
            owner_client = RemoteScheduler(owner_url)
            probe2 = Host(id=f"e2e-steer-{name}", hostname="e2e-steer",
                          ip="127.0.0.1", download_port=1)
            reg = owner_client.register_peer(host=probe2, url=url2)
            parent_hosts = {
                p.host.id for p in (reg.schedule.parents or [])
            } if reg.schedule and reg.schedule.parents else set()
            owner_client.report_peer_failed(reg.peer)
            assert parent_hosts, (
                f"task {name} not on its ring owner {owner_url}"
            )
        log(f"steering: tasks {sorted(picks.values())} landed on their "
            f"ring owners across 2 replicas")

        # A probe pushed to replica A becomes ranking input (folded RTT)
        # on replica B via the manager's shared-topology sync.
        a = RemoteScheduler(SCHEDULER)
        src = Host(id="e2e-prober", hostname="e2e-prober", ip="127.0.0.1",
                   download_port=1)
        dst = Host(id="e2e-probed", hostname="e2e-probed", ip="127.0.0.2",
                   download_port=1)
        a.announce_host(src)
        a.announce_host(dst)
        a.sync_probes_finished(src, [(dst.id, 7_500_000)])
        b = RemoteScheduler(scheduler_b)

        def rtt_on_b():
            out = b._call("topology_rtt", {"src": src.id, "dst": dst.id})
            return out.get("rtt_ns")

        rtt = wait_for("cross-replica topology sync", rtt_on_b, timeout=60)
        assert abs(rtt - 7_500_000) < 2_000_000, rtt
        log(f"probe pushed to replica A ranks on replica B (rtt {rtt} ns)")

    log("ALL STAGES PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
