"""Port parity: the span sites, ``dragonfly2_tpu_torch`` against
``dragonfly2_tpu``.

For one lifecycle drill (``sim.lifecycle.run_lifecycle_drill``: the
daemon's ``lifecycle/epoch`` and ``lifecycle/promote``, the controller's
``rollout/transition``), one online dispatch (``trainer/dispatch``), one
coalesced batcher flush (``scheduler/eval.flush``), the manager's REST
handler spans (``manager/GET``, ``manager/POST``), the preheat fan-out and
its execution (``jobs/preheat``, ``jobs/preheat.execute``), the shard
guard's membership sweep and the client-side migration edge
(``scheduler/shard.handoff``), and a two-daemon
download (``daemon/download``, ``daemon/piece``, ``daemon/source.piece``,
``daemon/report.flush``: one daemon back to source, one P2P; and over the
wire with the child's piece window through the native fetch loop, whose
``daemon/piece`` spans carry ``native``), the multiset of
(span name, sorted attribute keys) each package exports is equal.
Where the values are inputs and not trained weights they are compared
too.  ``jit_compiles`` is 0 in the port here: no shape witness
(``utils/dftrace.py``) is installed in the test process.

Both packages' default tracers are swapped for in-memory rings and
restored after.  The port runs on the CPU.
"""

from __future__ import annotations

import collections
import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import dragonfly2_tpu.manager as j_manager
import dragonfly2_tpu.manager.rest as j_rest
import dragonfly2_tpu.scheduler.microbatch as j_mb
import dragonfly2_tpu.sim.lifecycle as j_sim
import dragonfly2_tpu.utils.tracing as jtr
import dragonfly2_tpu_torch.manager as t_manager
import dragonfly2_tpu_torch.manager.rest as t_rest
import dragonfly2_tpu_torch.scheduler.microbatch as t_mb
import dragonfly2_tpu_torch.sim.lifecycle as t_sim
import dragonfly2_tpu_torch.utils.tracing as ttr

PKGS = {"jax": jtr, "torch": ttr}


@pytest.fixture()
def rings():
    saved = [(m, m.default_tracer.exporter, m.enabled()) for m in PKGS.values()]
    out = {}
    for name, m in PKGS.items():
        out[name] = m.default_tracer.exporter = m.InMemoryExporter(max_spans=1 << 16)
        m.set_enabled(True)
    yield out
    for m, exporter, enabled in saved:
        m.default_tracer.exporter = exporter
        m.set_enabled(enabled)


def _inventory(ring, names):
    return collections.Counter(
        (s.name, tuple(sorted(s.attributes))) for s in ring.spans if s.name in names)


DRILL = dict(epoch_records=128, batch_size=32, announces=24, parents=4,
             min_shadow_samples=40, min_canary_samples=40)
LIFECYCLE_SPANS = {"rollout/transition", "lifecycle/epoch", "lifecycle/promote"}


def test_lifecycle_drill_spans_equal(rings):
    port = t_sim.run_lifecycle_drill(t_sim.LifecycleDrillConfig(**DRILL), device="cpu")
    ref = j_sim.run_lifecycle_drill(j_sim.LifecycleDrillConfig(**DRILL))
    assert port["ok"] and ref["ok"]
    inv = {name: _inventory(ring, LIFECYCLE_SPANS) for name, ring in rings.items()}
    assert inv["torch"] == inv["jax"]
    assert {name for name, _keys in inv["torch"]} == LIFECYCLE_SPANS

    def transitions(ring):
        return [(s.attributes["from_phase"], s.attributes["to_phase"],
                 s.attributes["version"], s.attributes.get("reason", "").split(":")[0])
                for s in ring.spans if s.name == "rollout/transition"]

    assert transitions(rings["torch"]) == transitions(rings["jax"])
    assert any(t[1] == "rolled_back" for t in transitions(rings["torch"]))


def test_online_dispatch_spans_equal(rings):
    import dragonfly2_tpu.trainer.online_graph as jog
    import dragonfly2_tpu_torch.trainer.online_graph as tog
    from dragonfly2_tpu.models.hop import HopConfig as JHopConfig
    from dragonfly2_tpu.trainer.train import TrainConfig as JTrainConfig
    from dragonfly2_tpu_torch.models.hop import HopConfig
    from dragonfly2_tpu_torch.trainer.train import TrainConfig

    n, hop = 64, dict(hidden=16, out_dim=8, node_embed_dim=4)
    base = dict(num_nodes=n, max_neighbors=4, batch_size=64, super_steps=2,
                queue_capacity=16, total_steps_hint=100)
    rng = np.random.default_rng(0)
    nf = rng.standard_normal((n, 12)).astype(np.float32)
    src = rng.integers(0, n, 256).astype(np.int32)
    dst = ((src + rng.integers(1, n, 256)) % n).astype(np.int32)
    rtt = rng.random(256).astype(np.float32)
    es = rng.integers(0, n, 128 * 3).astype(np.int32)
    ed = ((es + 1) % n).astype(np.int32)
    y = rng.random(128 * 3).astype(np.float32)
    jt = jog.OnlineGraphTrainer(
        jog.OnlineGraphConfig(model=JHopConfig(dropout=0.0, **hop), native_ingest=False,
                              train=JTrainConfig(warmup_steps=2), **base),
        node_feats=nf, topo_src=src, topo_dst=dst, topo_rtt=rtt)
    tt = tog.OnlineGraphTrainer(
        tog.OnlineGraphConfig(model=HopConfig(dropout=0.0, **hop),
                              train=TrainConfig(warmup_steps=2), **base),
        node_feats=nf, topo_src=src, topo_dst=dst, topo_rtt=rtt, device="cpu")
    for trainer in (jt, tt):
        trainer.feed_downloads(es, ed, y)
        assert trainer.run(max_dispatches=3, idle_timeout=0.1) == 3

    def dispatches(ring):
        return [(s.name, dict(s.attributes)) for s in ring.spans if s.name == "trainer/dispatch"]

    assert dispatches(rings["torch"]) == dispatches(rings["jax"]) == [
        ("trainer/dispatch", {"dispatch": i, "records": 128}) for i in range(3)]


def test_batcher_flush_spans_equal(rings):
    class SumScorer:
        wants_features = True

        def score(self, feats, src_buckets=None, dst_buckets=None):
            return feats.sum(axis=1)

    flushes = {}
    for name, mb in (("jax", j_mb), ("torch", t_mb)):
        b = mb.ScorerBatcher(SumScorer(), linger_s=0.05)
        barrier = threading.Barrier(4)

        def worker(i, b=b, barrier=barrier):
            barrier.wait()
            b.score(np.full((i + 1, 3), float(i), np.float32), tenant=f"t{i % 2}")

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
        spans = [s for s in rings[name].spans if s.name == "scheduler/eval.flush"]
        assert sum(s.attributes["batch"] for s in spans) == 4
        assert sum(s.attributes["rows"] for s in spans) == 1 + 2 + 3 + 4
        flushes[name] = _inventory(rings[name], {"scheduler/eval.flush"})
    assert flushes["torch"] == {("scheduler/eval.flush", ("batch", "jit_compiles", "rows")):
                                sum(flushes["torch"].values())}
    assert set(flushes["torch"]) == set(flushes["jax"])
    assert all(s.attributes["jit_compiles"] == 0 for s in rings["torch"].spans
               if s.name == "scheduler/eval.flush")


def test_manager_rest_spans_equal(rings):
    for name, manager, rest in (("jax", j_manager, j_rest), ("torch", t_manager, t_rest)):
        srv = rest.ManagerRESTServer(manager.ModelRegistry(), manager.ClusterManager())
        srv.serve()
        try:
            with PKGS[name].default_tracer.span("client") as root:
                headers = PKGS[name].default_tracer.inject()
            for method, path, body in (("GET", "/api/v1/healthy", None),
                                       ("POST", "/api/v1/topology",
                                        {"scheduler_id": "s", "edges": []}),
                                       ("GET", "/api/v1/no-such-route", None)):
                req = urllib.request.Request(
                    srv.url + path, method=method, headers=headers,
                    data=None if body is None else json.dumps(body).encode())
                try:
                    urllib.request.urlopen(req, timeout=30).close()
                except urllib.error.HTTPError as exc:
                    assert exc.code == 404
        finally:
            srv.stop()
        spans = [s for s in rings[name].spans if s.name.startswith("manager/")]
        assert [s.attributes["path"] for s in spans] == [
            "/api/v1/healthy", "/api/v1/topology", "/api/v1/no-such-route"]
        assert all((s.trace_id, s.parent_id) == (root.trace_id, root.span_id) for s in spans)
    assert _inventory(rings["torch"], {"manager/GET", "manager/POST"}) == _inventory(
        rings["jax"], {"manager/GET", "manager/POST"})


DAEMON_SPANS = {"daemon/download", "daemon/piece", "daemon/source.piece",
                "daemon/report.flush"}


def test_two_daemon_download_spans_equal(rings, tmp_path):
    """Daemon 0 goes back to source, daemon 1 downloads P2P from it, in
    each package's in-process swarm.  The report batcher lingers past the
    download, so each P2P download flushes its reports once, at close."""
    from tests.test_daemon import PIECE, _Swarm as JSwarm
    from tests.test_torch_daemon import _Swarm as TSwarm

    url = "https://origin/span-inventory"
    results = {}
    for name, swarm_cls in (("jax", JSwarm), ("torch", TSwarm)):
        swarm = swarm_cls(tmp_path / name, n_hosts=2)
        for d in swarm.daemons:
            d.conductor.report_linger_s = 60.0
        r0 = swarm.daemons[0].download(url, piece_size=PIECE, content_length=4 * PIECE)
        r1 = swarm.daemons[1].download(url, piece_size=PIECE)
        assert r0.ok and r0.back_to_source and r1.ok and not r1.back_to_source
        results[name] = (r0, r1)
        for d in swarm.daemons:
            d.stop()
    inv = {name: _inventory(ring, DAEMON_SPANS) for name, ring in rings.items()}
    assert inv["torch"] == inv["jax"]
    assert {name for name, _keys in inv["torch"]} == DAEMON_SPANS
    assert sum(n for (name, _k), n in inv["torch"].items() if name == "daemon/piece") == 4
    assert sum(n for (name, _k), n in inv["torch"].items()
               if name == "daemon/source.piece") == 4

    def values(ring):
        return sorted(
            (s.name, s.attributes.get("number", -1), s.attributes.get("bytes", -1),
             s.attributes.get("reports", -1), s.attributes.get("back_to_source"))
            for s in ring.spans if s.name in DAEMON_SPANS)

    assert values(rings["torch"]) == values(rings["jax"])



PREHEAT_SPANS = {"jobs/preheat", "jobs/preheat.execute"}


def test_preheat_spans_equal(rings):
    """The manager's fan-out (``jobs/preheat``, for a URL list and for an
    image's layers) and the worker-side execution
    (``jobs/preheat.execute``) export the same spans in both packages."""
    import importlib

    class Resolver:
        def resolve_layers(self, manifest_url):
            return types.SimpleNamespace(urls=[manifest_url + "/l1", manifest_url + "/l2"],
                                         headers={"Authorization": "Bearer t"})

    class SeedDaemon:
        def __init__(self):
            self.calls = []

        def download(self, url, **kw):
            self.calls.append((url, int(kw["priority"])))
            return types.SimpleNamespace(ok=True, pieces=3)

    results = {}
    for name in ("jax", "torch"):
        root = "dragonfly2_tpu" if name == "jax" else "dragonfly2_tpu_torch"
        queue = importlib.import_module(f"{root}.jobs.queue")
        preheat = importlib.import_module(f"{root}.jobs.preheat")
        broker = queue.JobQueue()
        preheat.preheat(broker, ["https://o/a", "https://o/b"], ["scheduler:s1", "scheduler:s2"])
        preheat.preheat_image(broker, "https://reg/v2/app/manifests/v1", ["scheduler:s1"],
                              Resolver())
        seed = SeedDaemon()
        handler = preheat.make_preheat_handler(seed)
        results[name] = (handler({"urls": ["https://o/a"], "piece_size": 4096,
                                  "priority": 6}), seed.calls)
    assert results["torch"] == results["jax"] == ({"https://o/a": 3}, [("https://o/a", 6)])
    inv = {name: _inventory(ring, PREHEAT_SPANS) for name, ring in rings.items()}
    assert inv["torch"] == inv["jax"]
    assert {name for name, _keys in inv["torch"]} == PREHEAT_SPANS
    assert sum(inv["torch"].values()) == 3

    def values(ring):
        return sorted((s.name, s.attributes.get("urls", -1), s.attributes.get("queues", -1),
                       s.attributes.get("image", "")) for s in ring.spans
                      if s.name in PREHEAT_SPANS)

    assert values(rings["torch"]) == values(rings["jax"])


HANDOFF_SPANS = {"scheduler/shard.handoff"}


def test_shard_handoff_spans_equal(rings):
    """The shard guard's sweep on a ring-version bump and the client's
    ``handoff_span`` export the same ``scheduler/shard.handoff`` spans,
    with the same shard, ring version and tasks moved, in both packages."""
    import importlib

    for name in ("jax", "torch"):
        root = "dragonfly2_tpu" if name == "jax" else "dragonfly2_tpu_torch"
        sched = importlib.import_module(f"{root}.scheduler")
        sharding = importlib.import_module(f"{root}.scheduler.sharding")
        resource_mod = importlib.import_module(f"{root}.scheduler.resource")
        guard = sched.ShardGuard("s0")
        service = sched.SchedulerService(
            sched.Resource(),
            sched.Scheduling(sched.Evaluator(), sched.SchedulingConfig(retry_interval=0)),
            None, None, shard_guard=guard,
        )
        guard.update_ring(sched.ShardRing({"s0": ""}, version=1))
        for i in range(40):
            host = resource_mod.Host(id=f"h{i}", hostname=f"h{i}", ip=f"10.0.0.{i}",
                                     port=8002, download_port=8001)
            service.register_peer(host=host, url=f"https://o/{i}")
        guard.update_ring(sched.ShardRing({f"s{i}": "" for i in range(4)}, version=2))
        with sharding.handoff_span("t-1", from_shard="s1", to_shard="s0", ring_version=2):
            pass
    inv = {name: _inventory(ring, HANDOFF_SPANS) for name, ring in rings.items()}
    assert inv["torch"] == inv["jax"]
    assert sum(inv["torch"].values()) == 3

    def values(ring):
        return sorted(tuple(sorted((k, str(v)) for k, v in s.attributes.items()))
                      for s in ring.spans if s.name in HANDOFF_SPANS)

    assert values(rings["torch"]) == values(rings["jax"])
    moved = [s.attributes["tasks_moved"] for s in rings["torch"].spans
             if s.name in HANDOFF_SPANS and "tasks_moved" in s.attributes]
    assert moved[0] == 0 and 0 < moved[1] < 40


def _native_window_download(pkg: str, tmp_path, pieces):
    """One wire parent (the Python store and server) warmed back to
    source, then one child on the native store with ``native_fetch``: its
    piece window goes through the native fetch loop, in ``pkg``."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    daemon, conductor_mod = mod("daemon"), mod("daemon.conductor")
    rpc, sched, resource_mod = mod("rpc"), mod("scheduler"), mod("scheduler.resource")
    from_records = mod("records.storage")
    server_mod = mod("rpc.scheduler_server")

    class Origin:
        def fetch(self, url, number, piece_size):
            # A remote origin's latency: the parent's piece costs are its
            # origin times, and at microseconds a stall would make it a bad
            # node (the evaluator's 20x rule) for the child.
            time.sleep(0.02)
            return pieces[number]

    url, piece = "https://origin/native-window-spans", len(pieces[0])
    resource = sched.Resource()
    service = sched.SchedulerService(
        resource, sched.Scheduling(sched.Evaluator(), sched.SchedulingConfig(retry_interval=0)),
        from_records.Storage(str(tmp_path / pkg / "records"), buffer_size=8),
        sched.NetworkTopology(resource.host_manager))
    server = server_mod.SchedulerHTTPServer(service)
    server.serve()
    servers = []
    try:
        nodes = []
        for name, native, source in (("parent", False, Origin()), ("child", True, None)):
            storage = daemon.DaemonStorage(str(tmp_path / pkg / name), prefer_native=native)
            assert storage.is_native == native
            piece_server = rpc.PieceHTTPServer(daemon.UploadManager(storage))
            piece_server.serve()
            servers.append(piece_server)
            host = resource_mod.Host(id=f"nw-{name}", hostname=f"nw-{name}", ip="127.0.0.1",
                                     port=8002, download_port=piece_server.port)
            client = rpc.RemoteScheduler(server.url, timeout=5.0)
            nodes.append(conductor_mod.Conductor(
                host, storage, client, piece_fetcher=rpc.HTTPPieceFetcher(client.resolve_host),
                source_fetcher=source, native_fetch=native))
        r0 = nodes[0].download(url, piece_size=piece, content_length=piece * len(pieces))
        r1 = nodes[1].download(url, piece_size=piece, content_length=piece * len(pieces))
        assert r0.ok and r0.back_to_source and r1.ok and not r1.back_to_source
        assert nodes[1].storage.read_task_bytes(r1.task_id) == b"".join(pieces)
    finally:
        for s in servers:
            s.stop()
        server.stop()


def test_native_fetch_window_spans_equal(rings, tmp_path):
    """The native fetch window's ``daemon/piece`` spans (``native=True``,
    opened at drain time from the engine's cost clock) in both packages:
    one a piece the child's window landed, with the Python arm's keys."""
    rng = np.random.default_rng(9)
    pieces = [rng.bytes(64 * 1024) for _ in range(4)]
    for pkg in ("dragonfly2_tpu", "dragonfly2_tpu_torch"):
        _native_window_download(pkg, tmp_path, pieces)
    inv = {name: _inventory(ring, DAEMON_SPANS) for name, ring in rings.items()}
    assert inv["torch"] == inv["jax"]

    def native_pieces(ring):
        # The parent's peer id up to its per-run uuid: ip-hostname.
        return sorted((s.attributes["number"], s.attributes["bytes"],
                       s.attributes["parent"].rsplit("-", 2)[0])
                      for s in ring.spans
                      if s.name == "daemon/piece" and s.attributes.get("native"))

    assert native_pieces(rings["torch"]) == native_pieces(rings["jax"])
    assert [n for n, _b, _p in native_pieces(rings["torch"])] == [0, 1, 2, 3]
