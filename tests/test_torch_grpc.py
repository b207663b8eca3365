"""The port's gRPC half, scheduler side: port counterparts of
``tests/test_grpc.py``'s ``TestSchedulerGRPC``, ``TestWireMetrics``,
``TestRateLimit``, ``TestAnnouncePeerStream`` and ``TestTenantOnWire``,
run against ``dragonfly2_tpu_torch.rpc.grpc_transport`` with the port's
daemons, plus the cross-package checks:

- ``dict_to_proto(...).SerializeToString()`` gives the same bytes in both
  packages for a fixed set of dicts, tenant included;
- both packages' protos import in either order in one process;
- the JAX ``GRPCRemoteScheduler`` against the port's
  ``SchedulerGRPCServer``, and the port's client against the JAX server,
  give the answers the HTTP wire gives;
- ``grpc://`` steering (the port's ``SteeringSchedulerClient`` with its
  default factory) follows one wrong-shard answer, as the HTTP wire's 421.

Every server binds port 0.  The origins answer after 20 ms, as a remote
origin does.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from dragonfly2_tpu_torch.daemon import DaemonStorage, UploadManager
from dragonfly2_tpu_torch.daemon.conductor import Conductor
from dragonfly2_tpu_torch.records.storage import Storage
from dragonfly2_tpu_torch.rpc import HTTPPieceFetcher, PieceHTTPServer
from dragonfly2_tpu_torch.rpc import grpc_transport as gt
from dragonfly2_tpu_torch.rpc.grpc_transport import (
    GRPCRemoteScheduler,
    GRPCStreamingScheduler,
    SchedulerGRPCServer,
)
from dragonfly2_tpu_torch.rpc.scheduler_client import RPCError
from dragonfly2_tpu_torch.scheduler import (
    Evaluator,
    NetworkTopology,
    Resource,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
)
from dragonfly2_tpu_torch.scheduler.resource import Host

REPO = Path(__file__).resolve().parents[1]
PIECE = 32 * 1024


class WireOrigin:
    def __init__(self):
        self.fetches = 0

    def content(self, url, number):
        seed = (sum(url.encode()) ^ number) & 0xFF
        return bytes((seed + i) % 256 for i in range(PIECE))

    def fetch(self, url, number, piece_size):
        self.fetches += 1
        time.sleep(0.02)
        return self.content(url, number)


class GRPCNode:
    def __init__(self, i, target, tmp_path, origin, client_cls=GRPCRemoteScheduler):
        self.storage = DaemonStorage(str(tmp_path / f"gnode{i}"), prefer_native=False)
        self.upload = UploadManager(self.storage)
        self.piece_server = PieceHTTPServer(self.upload)
        self.piece_server.serve()
        self.host = Host(id=f"gnode-{i}", hostname=f"gnode-{i}", ip="127.0.0.1",
                         download_port=self.piece_server.port)
        self.host.stats.network.idc = "idc-a"
        self.client = client_cls(target)
        self.conductor = Conductor(
            self.host, self.storage, self.client,
            piece_fetcher=HTTPPieceFetcher(self.client.resolve_host),
            source_fetcher=origin,
        )

    def stop(self):
        self.piece_server.stop()
        self.client.close()


def _service(tmp_path=None, **sched_kw):
    resource = Resource()
    return SchedulerService(
        resource,
        Scheduling(Evaluator(), SchedulingConfig(retry_interval=0, **sched_kw)),
        Storage(str(tmp_path / "records"), buffer_size=1) if tmp_path else None,
        NetworkTopology(resource.host_manager),
    )


@pytest.fixture()
def grpc_swarm(tmp_path):
    service = _service(tmp_path)
    server = SchedulerGRPCServer(service)
    server.serve()
    origin = WireOrigin()
    nodes = [GRPCNode(i, server.target, tmp_path, origin) for i in range(3)]
    yield {"server": server, "service": service, "nodes": nodes, "origin": origin}
    for n in nodes:
        n.stop()
    server.stop()


class TestSchedulerGRPC:
    def test_p2p_over_grpc(self, grpc_swarm):
        nodes, origin = grpc_swarm["nodes"], grpc_swarm["origin"]
        url = "https://origin/grpc-blob"
        r0 = nodes[0].conductor.download(url, piece_size=PIECE, content_length=4 * PIECE)
        assert r0.ok and r0.back_to_source and r0.pieces == 4
        fetches = origin.fetches
        r1 = nodes[1].conductor.download(url, piece_size=PIECE)
        assert r1.ok and not r1.back_to_source
        assert origin.fetches == fetches
        assert nodes[0].upload.upload_count == 4
        for n in range(4):
            assert nodes[1].storage.read_piece(r1.task_id, n) == origin.content(url, n)
        service = grpc_swarm["service"]
        service.storage.flush()
        downloads = service.storage.list_download()
        assert len(downloads) == 2
        assert [d for d in downloads if d.parents]

    def test_tiny_direct_piece_inline(self, grpc_swarm):
        nodes = grpc_swarm["nodes"]
        url = "https://origin/grpc-tiny"

        class TinyOrigin:
            def content_length(self, u):
                return 64

            def fetch(self, u, n, ps):
                return bytes(range(64))

        nodes[0].conductor.source_fetcher = TinyOrigin()
        assert nodes[0].conductor.download(url, piece_size=PIECE, content_length=64).ok
        r1 = nodes[1].conductor.download(url, piece_size=PIECE)
        assert r1.ok and r1.pieces == 1
        assert nodes[1].storage.read_piece(r1.task_id, 0)[:64] == bytes(range(64))

    def test_probe_roundtrip_over_grpc(self, grpc_swarm):
        nodes = grpc_swarm["nodes"]
        for n in nodes:
            n.client.announce_host(n.host)
        targets = nodes[0].client.sync_probes_start(nodes[0].host)
        assert targets
        nodes[0].client.sync_probes_finished(nodes[0].host,
                                             [(t.id, 5_000_000) for t in targets])
        assert grpc_swarm["service"].networktopology.neighbours(nodes[0].host.id)

    def test_scheduler_restart_recovery(self, tmp_path):
        """NOT_FOUND carries the typed dfcode over gRPC, so the client's
        re-announce-and-retry branch works after a scheduler restart."""
        def make_server(port=0):
            srv = SchedulerGRPCServer(_service(), port=port)
            srv.serve()
            return srv

        srv = make_server()
        port = srv.address[1]
        client = GRPCRemoteScheduler(srv.target)
        host = Host(id="r-host", hostname="r", ip="127.0.0.1", download_port=1)
        client.announce_host(host)
        srv.stop()
        srv2 = None
        for _ in range(20):
            try:
                cand = make_server(port=port)
            except (OSError, RuntimeError):
                cand = None
            if cand is not None and cand.address[1] == port:
                srv2 = cand
                break
            if cand is not None:
                cand.stop()
            time.sleep(0.25)
        assert srv2 is not None, f"port {port} never rebound"
        try:
            reg = client.register_peer(host=host, url="https://o/restart-blob")
            assert reg.peer.id
        finally:
            srv2.stop()
            client.close()

    def test_unknown_peer_maps_to_rpc_error(self, grpc_swarm):
        node = grpc_swarm["nodes"][0]
        with pytest.raises(RPCError) as exc:
            node.client._call("report_peer_finished", {"peer_id": "ghost"})
        assert "NOT_FOUND" in str(exc.value)
        d = gt.proto_to_dict(gt.dict_to_proto(
            {"peer_id": "p", "content_length": 5 << 40}, gt.pb.SetTaskInfoRequest))
        assert d["content_length"] == 5 << 40 and isinstance(d["content_length"], int)


class TestWireMetrics:
    def test_grpc_and_ratelimit_counters(self):
        from dragonfly2_tpu_torch.rpc.metrics import GRPC_REQUESTS_TOTAL, RATE_LIMITED_TOTAL
        from dragonfly2_tpu_torch.rpc.ratelimit import TokenBucket

        server = SchedulerGRPCServer(_service(), rate_limit=TokenBucket(qps=0.001, burst=2))
        server.serve()
        try:
            ok_before = GRPC_REQUESTS_TOTAL.value(service="scheduler", method="announce_host",
                                                  code="OK")
            rl_before = RATE_LIMITED_TOTAL.value(transport="grpc")
            client = GRPCRemoteScheduler(server.target)
            for hid in ("m1", "m2"):
                client.announce_host(Host(id=hid, hostname=hid, ip="127.0.0.1", download_port=1))
            with pytest.raises(RPCError):
                client.announce_host(Host(id="m3", hostname="m3", ip="127.0.0.1",
                                          download_port=1))
            assert GRPC_REQUESTS_TOTAL.value(service="scheduler", method="announce_host",
                                             code="OK") == ok_before + 2
            assert RATE_LIMITED_TOTAL.value(transport="grpc") == rl_before + 1
            client.close()
        finally:
            server.stop()


class TestRateLimit:
    def test_token_bucket_refills(self):
        from dragonfly2_tpu_torch.rpc.ratelimit import TokenBucket, maybe_bucket

        b = TokenBucket(qps=100.0, burst=3)
        assert all(b.take() for _ in range(3))
        assert not b.take()
        time.sleep(0.05)
        assert b.take()
        assert maybe_bucket(0, 0) is None
        assert maybe_bucket(5.0, None) is not None

    def test_grpc_server_rejects_when_drained(self):
        from dragonfly2_tpu_torch.rpc.ratelimit import RateLimitInterceptor, TokenBucket
        from dragonfly2_tpu_torch.rpc.ratelimit_grpc import (
            RateLimitInterceptor as LazyInterceptor,
        )

        assert RateLimitInterceptor is LazyInterceptor
        server = SchedulerGRPCServer(_service(), rate_limit=TokenBucket(qps=0.001, burst=2))
        server.serve()
        try:
            client = GRPCRemoteScheduler(server.target)
            host = Host(id="rl", hostname="rl", ip="127.0.0.1", download_port=1)
            client.announce_host(host)
            client.register_peer(host=host, url="https://o/rl-blob")
            with pytest.raises(RPCError) as exc:
                client.announce_host(Host(id="rl2", hostname="rl2", ip="127.0.0.1",
                                          download_port=1))
            assert "RESOURCE_EXHAUSTED" in str(exc.value)
            client.close()
        finally:
            server.stop()

    def test_http_server_answers_429(self):
        import json
        import urllib.error
        import urllib.request

        from dragonfly2_tpu_torch.rpc import SchedulerHTTPServer
        from dragonfly2_tpu_torch.rpc.ratelimit import TokenBucket

        server = SchedulerHTTPServer(_service(), rate_limit=TokenBucket(qps=0.001, burst=1))
        server.serve()
        try:
            req = urllib.request.Request(
                server.url + "/rpc/announce_host",
                data=json.dumps({"host": {"id": "h"}}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            urllib.request.urlopen(req, timeout=5).read()
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req, timeout=5)
            assert exc.value.code == 429
        finally:
            server.stop()


class TestAnnouncePeerStream:
    """The bidi ``announce_peer`` stream: per-peer calls ride one stream,
    and the scheduler pushes reschedules down mid-download."""

    def _swarm(self, tmp_path, **sched_kw):
        service = _service(tmp_path, **sched_kw)
        server = SchedulerGRPCServer(service)
        server.serve()
        origin = WireOrigin()
        nodes = [GRPCNode(i, server.target, tmp_path, origin, GRPCStreamingScheduler)
                 for i in range(3)]
        return server, service, nodes, origin

    def test_p2p_over_stream(self, tmp_path):
        from dragonfly2_tpu_torch.rpc.metrics import GRPC_REQUESTS_TOTAL

        server, service, nodes, origin = self._swarm(tmp_path)
        try:
            before = GRPC_REQUESTS_TOTAL.value(service="scheduler",
                                               method="stream/register_peer", code="OK")
            url = "https://origin/stream-blob"
            r0 = nodes[0].conductor.download(url, piece_size=PIECE, content_length=4 * PIECE)
            assert r0.ok and r0.back_to_source
            r1 = nodes[1].conductor.download(url, piece_size=PIECE)
            assert r1.ok and not r1.back_to_source
            service.storage.flush()
            assert [d for d in service.storage.list_download() if d.parents]
            assert GRPC_REQUESTS_TOTAL.value(service="scheduler",
                                             method="stream/register_peer",
                                             code="OK") >= before + 2
            assert "push-reschedule" in server.adapter.capabilities
        finally:
            for n in nodes:
                n.stop()
            server.stop()

    def test_slow_parent_triggers_server_push(self, tmp_path):
        """A stalled-but-not-failing parent: the stall sweep pushes fresh
        parents mid-download and the child switches without ever
        reporting a piece failure."""
        server, service, nodes, origin = self._swarm(tmp_path, candidate_parent_limit=1)
        service.hub.push_cooldown_s = 0.2
        try:
            url = "https://origin/stall-blob"
            n_pieces = 6
            assert nodes[0].conductor.download(url, piece_size=PIECE,
                                               content_length=n_pieces * PIECE).ok
            slow_host = nodes[0].host.id
            fetches = {}
            inner = nodes[2].conductor.piece_fetcher

            class SlowFetcher:
                def fetch(self, host_id, task_id, number):
                    fetches[host_id] = fetches.get(host_id, 0) + 1
                    if host_id == slow_host:
                        time.sleep(0.45)
                    return inner.fetch(host_id, task_id, number)

                def piece_bitmap(self, host_id, task_id):
                    return inner.piece_bitmap(host_id, task_id)

            nodes[2].conductor.piece_fetcher = SlowFetcher()
            result = {}
            t = threading.Thread(target=lambda: result.update(
                r=nodes[2].conductor.download(url, piece_size=PIECE)))
            t.start()
            assert nodes[1].conductor.download(url, piece_size=PIECE).ok
            pushed = 0
            deadline = time.time() + 5.0
            while not pushed and time.time() < deadline:
                pushed = service.reschedule_stalled(max_idle_s=0.25)
                time.sleep(0.05)
            t.join(timeout=15)
            r = result["r"]
            assert pushed >= 1, "stall sweep never pushed"
            assert r.ok and not r.back_to_source
            assert r.failed_pieces == 0
            assert fetches.get(nodes[1].host.id, 0) >= 1
            assert fetches.get(slow_host, 0) < n_pieces
        finally:
            for n in nodes:
                n.stop()
            server.stop()

    def test_stream_reconnect_resumes_push_registration(self, tmp_path):
        from dragonfly2_tpu_torch.scheduler.scheduling import ScheduleResult, ScheduleResultKind

        server, service, nodes, origin = self._swarm(tmp_path)
        try:
            url = "https://origin/resume-blob"
            assert nodes[0].conductor.download(url, piece_size=PIECE,
                                               content_length=2 * PIECE).ok
            client = nodes[1].client
            peer = client.register_peer(host=nodes[1].host, url=url).peer
            assert service.hub.subscribed(peer.id)
            with client._stream_mu:
                sendq = client._sendq
            sendq.put(None)
            deadline = time.time() + 5
            while (service.hub.subscribed(peer.id) or client._sendq is not None) \
                    and time.time() < deadline:
                time.sleep(0.02)
            assert not service.hub.subscribed(peer.id)
            client.report_piece_finished(peer, 0, parent_id="", length=PIECE, cost_ns=1)
            deadline = time.time() + 5
            while not service.hub.subscribed(peer.id) and time.time() < deadline:
                time.sleep(0.02)
            assert service.hub.subscribed(peer.id)
            assert service.hub.push(
                peer.id, ScheduleResult(kind=ScheduleResultKind.NEED_BACK_TO_SOURCE))
            got = None
            deadline = time.time() + 5
            while got is None and time.time() < deadline:
                got = client.take_pushed_schedule(peer)
                time.sleep(0.02)
            assert got is not None and got.kind is ScheduleResultKind.NEED_BACK_TO_SOURCE
        finally:
            for n in nodes:
                n.stop()
            server.stop()

    def test_stream_falls_back_to_unary(self, tmp_path):
        server, service, nodes, origin = self._swarm(tmp_path)
        try:
            client = nodes[0].client
            client._stream_call = lambda *a, **k: (_ for _ in ()).throw(
                ConnectionError("stream down"))
            assert nodes[0].conductor.download("https://origin/fallback-blob",
                                               piece_size=PIECE,
                                               content_length=2 * PIECE).ok
        finally:
            for n in nodes:
                n.stop()
            server.stop()


class TestTenantOnWire:
    REGISTER = {
        "host_id": "h-1", "url": "https://origin/t", "peer_id": "p-1",
        "task_id": "task-1", "tag": "", "application": "", "priority": 2,
        "tenant": "t-gold",
    }

    def test_register_dict_round_trips_tenant(self):
        from dragonfly2_tpu_torch.rpc.protos import tenantext as pbx

        out = gt.proto_to_dict(gt.dict_to_proto(self.REGISTER, pbx.RegisterPeerRequest))
        assert (out["tenant"], out["host_id"], out["priority"]) == ("t-gold", "h-1", 2)

    def test_announce_dict_round_trips_tenant(self):
        from dragonfly2_tpu_torch.rpc.protos import tenantext as pbx

        req = {"host": {"id": "h-1", "hostname": "h-1", "ip": "127.0.0.1"},
               "protocol_version": 2, "tenant": "t-gold"}
        out = gt.proto_to_dict(gt.dict_to_proto(req, pbx.AnnounceHostRequest))
        assert (out["tenant"], out["host"]["id"], out["protocol_version"]) == (
            "t-gold", "h-1", 2)

    def test_wire_compat_with_pre_tenant_binaries(self):
        from dragonfly2_tpu_torch.rpc.protos import dragonfly_pb2 as pb
        from dragonfly2_tpu_torch.rpc.protos import tenantext as pbx

        base = {k: v for k, v in self.REGISTER.items() if k != "tenant"}
        old_bytes = gt.dict_to_proto(base, pb.RegisterPeerRequest).SerializeToString()
        new_msg = pbx.RegisterPeerRequest.FromString(old_bytes)
        assert new_msg.tenant == "" and new_msg.host_id == "h-1"
        new_bytes = gt.dict_to_proto(self.REGISTER, pbx.RegisterPeerRequest).SerializeToString()
        old_msg = pb.RegisterPeerRequest.FromString(new_bytes)
        assert old_msg.host_id == "h-1" and old_msg.priority == 2
        assert "tenant" not in type(old_msg).DESCRIPTOR.fields_by_name

    def test_stream_envelope_register_arm_compat(self):
        from dragonfly2_tpu_torch.rpc.protos import dragonfly_pb2 as pb
        from dragonfly2_tpu_torch.rpc.protos import tenantext as pbx

        env = pbx.AnnouncePeerRequest(seq=7)
        gt.dict_to_proto_into(self.REGISTER, env.register)
        assert env.register.tenant == "t-gold"
        old_env = pb.AnnouncePeerRequest.FromString(env.SerializeToString())
        assert old_env.seq == 7 and old_env.WhichOneof("payload") == "register"
        assert old_env.register.host_id == "h-1"

    def test_register_over_grpc_carries_tenant(self, grpc_swarm):
        node = grpc_swarm["nodes"][0]
        node.client.tenant = "t-gold"
        res = node.client.register_peer(host=node.host, url="https://origin/tenant-blob")
        peer = grpc_swarm["service"].resource.peer_manager.load(res.peer.id)
        assert peer is not None and peer.tenant == "t-gold"

    def test_announce_over_grpc_carries_tenant(self, grpc_swarm, monkeypatch):
        service = grpc_swarm["service"]
        seen = {}
        orig = service.announce_host

        def spy(host, *, tenant=""):
            seen["tenant"] = tenant
            return orig(host, tenant=tenant)

        monkeypatch.setattr(service, "announce_host", spy)
        node = grpc_swarm["nodes"][1]
        node.client.tenant = "t-silver"
        node.client.announce_host(node.host)
        assert seen["tenant"] == "t-silver"

    def test_register_over_stream_carries_tenant(self, tmp_path):
        service = _service(tmp_path)
        server = SchedulerGRPCServer(service)
        server.serve()
        try:
            client = GRPCStreamingScheduler(server.target)
            client.tenant = "t-stream"
            host = Host(id="stream-h", hostname="stream-h", ip="127.0.0.1", download_port=1)
            res = client.register_peer(host=host, url="https://origin/stream-tenant")
            peer = service.resource.peer_manager.load(res.peer.id)
            assert peer is not None and peer.tenant == "t-stream"
            client.close()
        finally:
            server.stop()


# -- across the two packages --------------------------------------------------

WIRE_DICTS = [
    ("announce_host", {"host": {"id": "h-1", "hostname": "h-1", "ip": "10.0.0.1",
                                "port": 8002, "download_port": 8001},
                       "protocol_version": 2, "tenant": "t-gold"}),
    ("register_peer", TestTenantOnWire.REGISTER),
    ("register_peer", {k: v for k, v in TestTenantOnWire.REGISTER.items() if k != "tenant"}),
    ("set_task_info", {"peer_id": "p-1", "content_length": 5 << 40, "total_piece_count": 3}),
    ("report_piece_finished", {"peer_id": "p-1", "piece_number": 4, "parent_id": "p-0",
                               "length": 1 << 22, "cost_ns": 123456789012}),
    ("report_piece_failed", {"peer_id": "p-1", "parent_id": "p-0"}),
    ("sync_probes_finished", {"host_id": "h-1",
                              "results": [{"dest": "h-2", "rtt_ns": 7_000_000}]}),
    ("leave_peer", {"peer_id": "p-9"}),
]


@pytest.mark.parametrize("method,data", WIRE_DICTS,
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(WIRE_DICTS)])
def test_proto_bytes_equal_across_packages(method, data):
    from dragonfly2_tpu.rpc import grpc_transport as jgt

    t_cls, _ = gt.SCHEDULER_METHODS[method]
    j_cls, _ = jgt.SCHEDULER_METHODS[method]
    assert t_cls.DESCRIPTOR.full_name == j_cls.DESCRIPTOR.full_name
    t_bytes = gt.dict_to_proto(data, t_cls).SerializeToString(deterministic=True)
    j_bytes = jgt.dict_to_proto(data, j_cls).SerializeToString(deterministic=True)
    assert t_bytes == j_bytes and t_bytes
    assert gt.proto_to_dict(t_cls.FromString(j_bytes)) == jgt.proto_to_dict(
        j_cls.FromString(t_bytes))


def test_serialized_descriptors_are_byte_identical():
    from dragonfly2_tpu.rpc.protos import dragonfly_pb2 as jpb

    t_src = (REPO / "dragonfly2_tpu_torch/rpc/protos/dragonfly_pb2.py").read_bytes()
    j_src = (REPO / "dragonfly2_tpu/rpc/protos/dragonfly_pb2.py").read_bytes()
    blob = [line for line in t_src.splitlines() if b"AddSerializedFile" in line]
    assert blob and blob == [line for line in j_src.splitlines() if b"AddSerializedFile" in line]
    assert gt.pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert gt.pb.DESCRIPTOR.package == "dragonfly2tpu"


_IMPORT_ORDER = """
import importlib, sys
sys.path.insert(0, {repo!r})
mods = {mods!r}
loaded = [importlib.import_module(m) for m in mods]
tx = [importlib.import_module(m.rsplit(".", 2)[0] + ".grpc_transport") for m in mods]
assert tx[0].pb.RegisterPeerResponse is tx[1].pb.RegisterPeerResponse
assert tx[0].pbx.RegisterPeerRequest.DESCRIPTOR is tx[1].pbx.RegisterPeerRequest.DESCRIPTOR
print("OK")
"""


@pytest.mark.parametrize("first", ["port", "jax"])
def test_both_packages_protos_import_in_either_order(first):
    mods = ["dragonfly2_tpu_torch.rpc.protos.tenantext", "dragonfly2_tpu.rpc.protos.tenantext"]
    if first == "jax":
        mods.reverse()
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ORDER.format(repo=str(REPO), mods=mods)],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr


def _jax_service(tmp_path):
    import dragonfly2_tpu.scheduler as js
    from dragonfly2_tpu.records.storage import Storage as JStorage

    resource = js.Resource()
    return js.SchedulerService(
        resource, js.Scheduling(js.Evaluator(), js.SchedulingConfig(retry_interval=0)),
        JStorage(str(tmp_path / "jrecords"), buffer_size=1),
        js.NetworkTopology(resource.host_manager))


def _drive(client, host_cls, tag):
    """One fixed call sequence; → what each answer holds, transport-free."""
    hosts = [host_cls(id=f"{tag}-h{i}", hostname=f"{tag}-h{i}", ip="127.0.0.1",
                      port=8002, download_port=9000 + i) for i in range(3)]
    for h in hosts:
        h.stats.network.idc = "idc-a"
        client.announce_host(h)
    url = "https://origin/cross-blob"
    seed = client.register_peer(host=hosts[0], url=url)
    client.set_task_info(seed.peer, 4 * PIECE, 4, PIECE)
    client.mark_back_to_source(seed.peer)
    for n in range(4):
        client.report_piece_finished(seed.peer, n, parent_id="", length=PIECE, cost_ns=10**6)
    client.report_peer_finished(seed.peer)
    child = client.register_peer(host=hosts[1], url=url)
    out = {
        "seed_scope": seed.size_scope.name,
        "child_kind": child.schedule.kind.name if child.schedule else None,
        "child_parents": [p.host.id for p in (child.schedule.parents if child.schedule else [])],
        "targets": sorted(t.id for t in client.sync_probes_start(hosts[2])),
    }
    try:
        client._call("report_peer_finished", {"peer_id": "ghost"})
    except Exception as exc:  # either package's RPCError
        out["ghost"] = (type(exc).__name__, exc.code)
    return out


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_cross_package_grpc_answers_equal_the_http_wires(tmp_path, direction):
    from dragonfly2_tpu.rpc import SchedulerHTTPServer as JHTTPServer
    from dragonfly2_tpu.rpc.grpc_transport import GRPCRemoteScheduler as JGRPCClient
    from dragonfly2_tpu.rpc.grpc_transport import SchedulerGRPCServer as JGRPCServer
    from dragonfly2_tpu.rpc.scheduler_client import RemoteScheduler as JHTTPClient
    from dragonfly2_tpu.scheduler.resource import Host as JHost
    from dragonfly2_tpu_torch.rpc import RemoteScheduler, SchedulerHTTPServer

    if direction == "jax_client_port_server":
        server_cls, http_cls, make_service = SchedulerGRPCServer, SchedulerHTTPServer, _service
        grpc_client, http_client, host_cls = JGRPCClient, JHTTPClient, JHost
    else:
        server_cls, http_cls, make_service = JGRPCServer, JHTTPServer, _jax_service
        grpc_client, http_client, host_cls = GRPCRemoteScheduler, RemoteScheduler, Host
    answers = {}
    for wire in ("grpc", "http"):
        service = make_service(tmp_path / wire)
        server = (server_cls if wire == "grpc" else http_cls)(service)
        server.serve()
        client = (grpc_client(server.target) if wire == "grpc"
                  else http_client(server.url))
        try:
            answers[wire] = _drive(client, host_cls, "x")
        finally:
            if wire == "grpc":
                client.close()
            server.stop()
    assert answers["grpc"] == answers["http"]
    assert answers["grpc"]["child_kind"] == "PARENTS"
    assert answers["grpc"]["child_parents"] == ["x-h0"]
    assert answers["grpc"]["ghost"] == ("RPCError", 5)


def test_grpc_steering_follows_one_wrong_shard_answer(tmp_path):
    """Two port schedulers in serve mode with a gRPC port each; the port's
    steering client over their ``grpc://`` addresses (the default
    factory's ``GRPCStreamingScheduler``) routes by the url-hash bootstrap
    ring, takes the wrong-shard answer once, and lands on the owner the
    JAX ring names."""
    import dragonfly2_tpu.scheduler.sharding as j_sharding
    import dragonfly2_tpu.utils.idgen as j_idgen
    from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
    from dragonfly2_tpu_torch.config import SchedulerConfigFile
    from dragonfly2_tpu_torch.rpc.steering import SteeringSchedulerClient
    from dragonfly2_tpu_torch.scheduler import ShardRing, metrics
    from dragonfly2_tpu_torch.utils import idgen

    servings = []
    try:
        for i in range(2):
            cfg = SchedulerConfigFile()
            cfg.server.host, cfg.server.port, cfg.server.grpc_port = "127.0.0.1", 0, 0
            cfg.storage.dir = str(tmp_path / f"records{i}")
            cfg.scheduling.retry_interval_s = 0.0
            servings.append(scheduler_cli.serve(cfg, device="cpu", seed_trigger=False))
        assert all(s.stall_monitor is not None for s in servings)
        urls = [f"grpc://{s.grpc_server.target}" for s in servings]
        jring = j_sharding.ShardRing(
            {s.scheduler_id: u for s, u in zip(servings, urls)}, version=1)
        for s in servings:
            assert s.shard_guard.update_ring(ShardRing.from_payload(jring.to_payload())) == []
        by_id = {s.scheduler_id: s for s in servings}
        client = SteeringSchedulerClient(urls)
        assert all(isinstance(c, GRPCStreamingScheduler) for c in client._clients.values())
        mismatch = next(u for u in (f"https://origin.example/g-stale-{i}" for i in range(200))
                        if client._ring.pick(idgen.task_id(u))
                        != jring.url_of(jring.owner(j_idgen.task_id(u))))
        host = Host(id="steer-g", hostname="steer-g", ip="127.0.0.1", port=8002,
                    download_port=8001)
        redirects = metrics.SHARD_REDIRECTS_TOTAL.value()
        res = client.register_peer(host=host, url=mismatch)
        assert metrics.SHARD_REDIRECTS_TOTAL.value() == redirects + 1
        owner = by_id[jring.owner(j_idgen.task_id(mismatch))]
        assert owner.service.resource.task_manager.load(res.peer.task.id) is not None
        for c in client._clients.values():
            c.close()
    finally:
        for s in servings:
            s.stop()
