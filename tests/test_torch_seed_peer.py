"""Port parity: the seed peer, ``dragonfly2_tpu_torch`` against
``dragonfly2_tpu``.

The cases of ``tests/test_seeder.py`` (``TestSeedQueue``,
``TestSeederStream``, ``TestColdTaskCrossProcess``,
``TestPublicSurfaceLockdown``) run on both packages (``pkg``), the port
on the CPU; the cold task runs the port's scheduler in serve mode and a
``cli.dfdaemon.seed_peer`` composition in this process (the three-process
form is ``tests/test_torch_manager_jobs.py``'s preheat).

Then K1 with a seed parent: one seeded swarm whose candidate sets all
hold a SUPER_SEED host, built the same way in both packages, ranked by
the JAX package's ``MLEvaluator(FusedMLPScorer)`` (its jnp path) and the
port's (K1's plain version on the CPU): scores within 1e-4, orders equal
wherever adjacent reference scores differ by more than 1e-4, and the
seed's slot row carries ``type_super`` (column 9).  The seed's peer then
moves RUNNING → SUCCEEDED with no announce between, and both the ML and
the rule rankings are held again: the rule half's host-type term flips
from MAX to MIN in both packages.
"""

from __future__ import annotations

import json
import threading
import time
import types
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

import dragonfly2_tpu.daemon as j_daemon
import dragonfly2_tpu.daemon.conductor as j_conductor
import dragonfly2_tpu.daemon.seeder as j_seeder
import dragonfly2_tpu.rpc.daemon_control as j_control
import dragonfly2_tpu.scheduler as j_scheduler
import dragonfly2_tpu.scheduler.resource as j_resource
import dragonfly2_tpu.scheduler.seed_client as j_seed_client
import dragonfly2_tpu.utils.types as j_types
import dragonfly2_tpu_torch.daemon as t_daemon
import dragonfly2_tpu_torch.daemon.conductor as t_conductor
import dragonfly2_tpu_torch.daemon.seeder as t_seeder
import dragonfly2_tpu_torch.rpc.daemon_control as t_control
import dragonfly2_tpu_torch.scheduler as t_scheduler
import dragonfly2_tpu_torch.scheduler.resource as t_resource
import dragonfly2_tpu_torch.scheduler.seed_client as t_seed_client
import dragonfly2_tpu_torch.utils.types as t_types

PIECE = 32 * 1024


def _ns(daemon, conductor, seeder, control, scheduler, resource, seed_client, types_):
    return types.SimpleNamespace(
        DaemonStorage=daemon.DaemonStorage, Conductor=conductor.Conductor,
        Seeder=seeder.Seeder, SeedQueue=seeder.SeedQueue,
        DaemonControlServer=control.DaemonControlServer, s=scheduler, Host=resource.Host,
        pick_seed_host=seed_client.pick_seed_host, HostType=types_.HostType,
        Priority=types_.Priority,
    )


PKGS = {
    "jax": _ns(j_daemon, j_conductor, j_seeder, j_control, j_scheduler, j_resource,
               j_seed_client, j_types),
    "torch": _ns(t_daemon, t_conductor, t_seeder, t_control, t_scheduler, t_resource,
                 t_seed_client, t_types),
}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return PKGS[request.param]


def _service(pkg):
    s = pkg.s
    return s.SchedulerService(s.Resource(), s.Scheduling(s.Evaluator(),
                                                         s.SchedulingConfig(retry_interval=0)))


def _storage(pkg, path):
    return pkg.DaemonStorage(str(path), prefer_native=False)


class _Origin:
    def content(self, url, number):
        seed = (hash(url) ^ number) & 0xFF
        return bytes((seed + i) % 256 for i in range(PIECE))

    def fetch(self, url, number, piece_size):
        return self.content(url, number)


# -- tests/test_seeder.py -----------------------------------------------------


class TestSeedQueue:
    def test_priority_order(self, pkg):
        q = pkg.SeedQueue(max_concurrent=1)
        gate, done, ran = threading.Event(), threading.Event(), []

        def job(name):
            def run():
                ran.append(name)
                if name == "l2":
                    done.set()
            return run

        q.submit(lambda: gate.wait(5), pkg.Priority.LEVEL0)
        time.sleep(0.05)  # the blocker occupies the single worker
        q.submit(job("l2"), pkg.Priority.LEVEL2)
        q.submit(job("l0"), pkg.Priority.LEVEL0)
        q.submit(job("l1"), pkg.Priority.LEVEL1)
        gate.set()
        assert done.wait(5)
        assert ran == ["l0", "l1", "l2"]
        q.stop()

    def test_fifo_within_level(self, pkg):
        q = pkg.SeedQueue(max_concurrent=1)
        gate, done, ran = threading.Event(), threading.Event(), []
        q.submit(lambda: gate.wait(5), pkg.Priority.LEVEL0)
        time.sleep(0.05)
        for i in range(3):
            def mk(i=i):
                def run():
                    ran.append(i)
                    if i == 2:
                        done.set()
                return run
            q.submit(mk(), pkg.Priority.LEVEL1)
        gate.set()
        assert done.wait(5)
        assert ran == [0, 1, 2]
        q.stop()


class TestSeederStream:
    def test_event_sequence_and_result(self, pkg, tmp_path):
        service = _service(pkg)
        storage = _storage(pkg, tmp_path / "seednode")
        host = pkg.Host(id="seed-0", hostname="seed-0", ip="127.0.0.1", download_port=1,
                        type=pkg.HostType.SUPER_SEED)
        conductor = pkg.Conductor(host, storage, service, piece_fetcher=None,
                                  source_fetcher=_Origin())
        # Hold the tail pieces until a "piece" event proves the poller saw
        # progress (direct evidence, not a timing bet).
        progress_seen = threading.Event()
        inner_fetch = conductor.source_fetcher.fetch

        def gated_fetch(url, number, piece_size):
            if number >= 2:
                progress_seen.wait(10)
            return inner_fetch(url, number, piece_size)

        conductor.source_fetcher.fetch = gated_fetch
        seeder = pkg.Seeder(conductor, storage)
        events = []

        def emit(e):
            events.append(e)
            if e["event"] == "piece":
                progress_seen.set()

        res = seeder.obtain("https://origin/seed-blob", piece_size=PIECE,
                            content_length=4 * PIECE, priority=pkg.Priority.LEVEL1,
                            emit=emit, poll_interval_s=0.01)
        assert res["ok"] and res["pieces"] == 4
        kinds = [e["event"] for e in events]
        assert kinds[0] == "accepted" and events[0]["priority"] == 1
        assert kinds[-1] == "done" and events[-1]["ok"]
        assert "piece" in kinds
        seeder.queue.stop()

    def test_pick_seed_host_ranking(self, pkg):
        H = pkg.Host
        normal = H(id="n", hostname="n", ip="1.1.1.1", port=9)
        weak = H(id="w", hostname="w", ip="1.1.1.2", port=9, type=pkg.HostType.WEAK_SEED)
        sup = H(id="s", hostname="s", ip="1.1.1.3", port=9, type=pkg.HostType.SUPER_SEED)
        portless = H(id="p", hostname="p", ip="1.1.1.4", port=0,
                     type=pkg.HostType.SUPER_SEED)
        assert pkg.pick_seed_host([normal, weak, sup, portless]).id == "s"
        assert pkg.pick_seed_host([normal, weak]).id == "w"
        assert pkg.pick_seed_host([normal]) is None


class TestPublicSurfaceLockdown:
    def test_public_endpoint_rejects_download(self, pkg, tmp_path):
        """The routable seed endpoint does NOT expose /download, and a
        malformed /obtain_seeds body gets a clean 400."""
        service = _service(pkg)
        storage = _storage(pkg, tmp_path / "pub")
        host = pkg.Host(id="s0", hostname="s0", ip="127.0.0.1", download_port=1,
                        type=pkg.HostType.SUPER_SEED)
        conductor = pkg.Conductor(host, storage, service, piece_fetcher=None,
                                  source_fetcher=_Origin())
        seeder = pkg.Seeder(conductor, storage)
        srv = pkg.DaemonControlServer(conductor, piece_size=PIECE, seeder=seeder, public=True)
        srv.serve()
        try:
            for path, body, code in (
                ("/download", {"url": "https://x", "output": "/nonexistent/evil"}, 404),
                ("/obtain_seeds", [1, 2], 400),
                ("/obtain_seeds", {"url": "https://x", "priority": 99}, 400),
            ):
                req = urllib.request.Request(srv.url + path, data=json.dumps(body).encode(),
                                             headers={"Content-Type": "application/json"},
                                             method="POST")
                with pytest.raises(urllib.error.HTTPError) as exc:
                    urllib.request.urlopen(req, timeout=5)
                assert exc.value.code == code
        finally:
            srv.stop()
            seeder.queue.stop()


class _RangeOrigin(BaseHTTPRequestHandler):
    BLOB = bytes(i % 251 for i in range(6 * PIECE))
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
            body, code = self.BLOB[int(s): (int(e) if e else len(self.BLOB) - 1) + 1], 206
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def test_cold_task_triggers_the_seed_daemon(tmp_path):
    """``TestColdTaskCrossProcess`` on the port, in process: a client with
    no source client registers a COLD task with the port's scheduler in
    serve mode; the scheduler's ``RemoteSeedPeerClient`` dials the seed
    composition's public ``/obtain_seeds``, the seed fetches from the
    origin, and the client's pieces all come from the seed."""
    from dragonfly2_tpu_torch.cli import dfdaemon
    from dragonfly2_tpu_torch.cli import scheduler as scheduler_cli
    from dragonfly2_tpu_torch.config import DaemonConfig, SchedulerConfigFile
    from dragonfly2_tpu_torch.rpc import HTTPPieceFetcher, PieceHTTPServer, RemoteScheduler

    origin_srv = ThreadingHTTPServer(("127.0.0.1", 0), _RangeOrigin)
    threading.Thread(target=origin_srv.serve_forever, daemon=True).start()
    origin_url = f"http://127.0.0.1:{origin_srv.server_address[1]}/cold-blob"
    _RangeOrigin.hits.clear()
    scfg = SchedulerConfigFile()
    scfg.server.host, scfg.server.port = "127.0.0.1", 0
    scfg.scheduling.retry_interval_s = 0.0
    scfg.storage.dir = str(tmp_path / "records")
    scfg.network_topology.enable = False
    serving = seed = ps = None
    try:
        serving = scheduler_cli.serve(scfg, device="cpu")
        assert type(serving.service.seed_peer_trigger).__name__ == "RemoteSeedPeerClient"
        dc = DaemonConfig()
        dc.server.host, dc.server.port, dc.server.advertise_ip = "127.0.0.1", 0, "127.0.0.1"
        dc.storage.dir = str(tmp_path / "seedstore")
        dc.piece_size = PIECE
        seed = dfdaemon.build(dc, serving.url)
        seed.update(dfdaemon.seed_peer(seed, dc))
        assert seed["host"].type is t_types.HostType.SUPER_SEED
        assert seed["host"].port == seed["seed_endpoint"].address[1]
        seed["announcer"].announce_once()

        storage = t_daemon.DaemonStorage(str(tmp_path / "clientnode"))
        ps = PieceHTTPServer(t_daemon.UploadManager(storage))
        ps.serve()
        host = t_resource.Host(id="client-0", hostname="client-0", ip="127.0.0.1",
                               download_port=ps.port)
        client = RemoteScheduler(serving.url)
        conductor = t_conductor.Conductor(
            host, storage, client, piece_fetcher=HTTPPieceFetcher(client.resolve_host),
            source_fetcher=None)  # MUST come from the seed, not the origin
        r = conductor.download(url=origin_url, piece_size=PIECE, content_length=6 * PIECE)
        assert r.ok and not r.back_to_source and r.pieces == 6
        assert _RangeOrigin.hits, "origin never touched"
        for n in range(6):
            assert storage.read_piece(r.task_id, n) == _RangeOrigin.BLOB[
                n * PIECE:(n + 1) * PIECE]
        svc = serving.service
        child = next(p for p in svc.resource.peer_manager.items() if p.host.id == "client-0")
        parents = {svc.resource.peer_manager.load(pc.parent_id).host.id
                   for pc in child.pieces.values()}
        assert parents == {seed["host"].id}
    finally:
        if ps is not None:
            ps.stop()
        if seed is not None:
            seed["announcer"].stop()
            seed["piece_server"].stop()
            if "seed_endpoint" in seed:
                seed["seed_endpoint"].stop()
                seed["seeder"].queue.stop()
        if serving is not None:
            serving.stop()
        origin_srv.shutdown()
        origin_srv.server_close()


# -- K1 with a seed parent ----------------------------------------------------


def _weights(seed=5, dims=(32, 64, 64, 1)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3,
             rng.standard_normal(dims[i + 1]).astype(np.float32) * 0.05)
            for i in range(len(dims) - 1)]


N_HOSTS, N_SETS, SET_SIZE = 60, 30, 12


def _sets(seed_idx, seed=17):
    rng = np.random.default_rng(seed)
    for _ in range(N_SETS):
        others = [int(x) for x in rng.choice(N_HOSTS, SET_SIZE + 2, replace=False)
                  if x != seed_idx]
        child, cand = others[0], others[1:SET_SIZE] + [seed_idx]
        rng.shuffle(cand)
        yield child, cand


def _orders_agree(order, ref_scores, tol):
    ranked = sorted(range(len(ref_scores)), key=lambda i: -ref_scores[i])
    for a, b in zip(ranked, ranked[1:]):
        if ref_scores[a] - ref_scores[b] > tol and order.index(a) > order.index(b):
            return False
    return True


def _ranked(ml, rule, cache, task, peers, fused, sets):
    """→ [(K1 scores, ML order as candidate indices, rule scores, the
    candidates' type_super column)] over the candidate sets."""
    out = []
    total = task.total_piece_count
    for child, cand in sets:
        parents = [peers[i] for i in cand]
        edge, slots, cslot, _, _ = ml._featurize_slots(parents, peers[child])
        dst = np.full(len(slots), cslot, dtype=np.int64)
        scores = np.asarray(fused.score(edge, src_buckets=slots, dst_buckets=dst),
                            dtype=np.float64)
        by_id = {p.id: k for k, p in enumerate(parents)}
        order = [by_id[p.id] for p in ml.evaluate_parents(parents, peers[child], total)]
        rule_scores = np.asarray(rule.evaluate_all(parents, peers[child], total))
        super_col = cache.matrix_snapshot()[1][np.asarray(slots), 9]
        out.append((scores, order, rule_scores, np.asarray(super_col)))
    return out


def test_k1_ranks_a_super_seed_parent_as_the_jax_package_does():
    from dragonfly2_tpu.ops.pallas_score import FusedMLPScorer as JaxFusedMLPScorer
    from dragonfly2_tpu.sim.swarm import build_announce_swarm as jax_swarm
    from dragonfly2_tpu_torch.ops.fused_score import FusedMLPScorer
    from dragonfly2_tpu_torch.sim.swarm import build_announce_swarm

    weights = _weights()
    sides = {}
    for name, swarm, fused_cls, s, kw in (
        ("jax", jax_swarm, JaxFusedMLPScorer, j_scheduler, {"use_pallas": False}),
        ("torch", build_announce_swarm, FusedMLPScorer, t_scheduler, {"device": "cpu"}),
    ):
        task, peers = swarm(N_HOSTS, seed=9)
        seed_idx = next((i for i, p in enumerate(peers)
                         if p.host.type is not PKGS[name].HostType.NORMAL), None)
        if seed_idx is None:  # the cluster drew no seed host: make host 0 one
            seed_idx = 0
            peers[0].host.type = PKGS[name].HostType.SUPER_SEED
        cache = s.HostFeatureCache(max_hosts=256)
        fused = fused_cls(cache, weights, **kw)
        ml = s.MLEvaluator(fused, feature_cache=cache)
        rule = s.Evaluator(feature_cache=cache)
        sides[name] = (ml, rule, cache, task, peers, fused, seed_idx)
    assert sides["jax"][6] == sides["torch"][6]
    seed_idx = sides["torch"][6]
    sets = list(_sets(seed_idx))

    def hold(phase):
        got = {name: _ranked(*side[:6], sets) for name, side in sides.items()}
        for (js, jo, jr, jc), (ts, to, tr, tc) in zip(got["jax"], got["torch"]):
            np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4)
            assert _orders_agree(to, js, 1e-4), phase
            assert _orders_agree(jo, js, 1e-4), phase
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_array_equal(tc, jc)
        assert all(c.sum() >= 1 for *_, c in got["torch"]), "no type_super row"
        return got

    before = hold("seed RUNNING")
    for name, side in sides.items():
        seed_peer = side[4][seed_idx]
        assert seed_peer.fsm.current == "Running"
        seed_peer.fsm.event("DownloadSucceeded")
    after = hold("seed SUCCEEDED")
    # The rule half's host-type term reads the peer's state, not a stamp
    # the next announce refreshes: the seed's rule score falls by
    # 0.15 x (MAX - MIN) in both packages.
    k = sets[0][1].index(seed_idx)
    for name in ("jax", "torch"):
        drop = before[name][0][2][k] - after[name][0][2][k]
        assert drop == pytest.approx(0.15, abs=1e-6), name
