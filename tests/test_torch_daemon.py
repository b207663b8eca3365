"""Port parity: the peer daemon's data plane, ``dragonfly2_tpu_torch``
against ``dragonfly2_tpu``.

The cases of ``tests/test_daemon.py`` that the download path covers, on
the port (piece storage on the native store and the Python one; the
swarms on the Python store, as the reference's; the native fetch loop is
``tests/test_torch_native_fetch.py``'s): piece
storage, upload caps, the shaper, PEX, the conductor through the real
scheduler, the review regressions, the host announcer, swarm churn, the
peer engine, the PEX worker pool and tiny-file direct pieces.

Then the two packages against each other: a task written by either
package's Python store is reloaded by the other, and its ``header.json``,
``pieces.jsonl`` and piece bytes are byte-equal for the same pieces.
"""

import numpy as np
import pytest

from dragonfly2_tpu_torch.daemon import (
    Daemon,
    DaemonStorage,
    TrafficShaper,
    UploadManager,
)
from dragonfly2_tpu_torch.daemon.pex import GossipBus, MemberMeta, PeerExchange
from dragonfly2_tpu_torch.daemon.upload import UploadBusy
from dragonfly2_tpu_torch.records.storage import Storage
from dragonfly2_tpu_torch.scheduler import (
    Evaluator,
    NetworkTopology,
    Resource,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
)
from dragonfly2_tpu_torch.scheduler.resource import Host

PIECE = 64 * 1024  # 64 KiB pieces keep the tests fast


def make_host(i, **kw):
    h = Host(
        id=f"host-{i}", hostname=f"host-{i}", ip=f"10.0.0.{i}", port=8002,
        download_port=8001, **kw,
    )
    h.stats.network.idc = "idc-a"
    return h


class FakeOrigin:
    """Deterministic origin content, piece-addressable."""

    def __init__(self, total_pieces=4):
        self.total_pieces = total_pieces
        self.fetches = 0

    def content(self, url, number):
        seed = (hash(url) ^ number) & 0xFFFF
        return bytes((seed + i) % 256 for i in range(PIECE))

    def fetch(self, url, number, piece_size):
        self.fetches += 1
        return self.content(url, number)


@pytest.fixture(params=["native", "python"])
def engine_pref(request):
    return request.param == "native"


class TestDaemonStorage:
    def test_write_read_bitmap(self, tmp_path, engine_pref):
        st = DaemonStorage(str(tmp_path / "s"), prefer_native=engine_pref)
        assert st.is_native == engine_pref
        st.register_task("t1", piece_size=PIECE, content_length=4 * PIECE)
        st.write_piece("t1", 0, b"a" * PIECE)
        st.write_piece("t1", 2, b"c" * 100)
        assert st.read_piece("t1", 0) == b"a" * PIECE
        assert st.read_piece("t1", 2) == b"c" * 100
        assert list(st.piece_bitmap("t1", 4)) == [1, 0, 1, 0]
        assert st.task_bytes("t1") == PIECE + 100

    def test_crash_reload(self, tmp_path, engine_pref):
        root = str(tmp_path / "s")
        st = DaemonStorage(root, prefer_native=engine_pref)
        st.register_task("t1", piece_size=PIECE, content_length=2 * PIECE)
        st.write_piece("t1", 1, b"x" * PIECE)
        st.close()
        st2 = DaemonStorage(root, prefer_native=engine_pref)
        assert st2.reload_persistent_tasks(st2.scan_disk_tasks()) == ["t1"]
        assert st2.read_piece("t1", 1) == b"x" * PIECE

    def test_quota_reclaims_lru(self, tmp_path, engine_pref):
        st = DaemonStorage(
            str(tmp_path / "s"), quota_bytes=3 * PIECE, prefer_native=engine_pref
        )
        import time

        for i, tid in enumerate(["old", "mid", "new"]):
            st.register_task(tid, piece_size=PIECE, content_length=2 * PIECE)
            st.write_piece(tid, 0, b"d" * PIECE)
            st.write_piece(tid, 1, b"d" * PIECE)
            time.sleep(0.01)
        reclaimed = st.reclaim()
        assert "old" in reclaimed
        assert st.total_bytes() <= 3 * PIECE


class TestUploadManager:
    def test_concurrency_cap(self, tmp_path):
        st = DaemonStorage(str(tmp_path / "s"), prefer_native=False)
        st.register_task("t", piece_size=PIECE, content_length=PIECE)
        st.write_piece("t", 0, b"z" * PIECE)
        um = UploadManager(st, concurrent_limit=0)
        with pytest.raises(UploadBusy):
            um.serve_piece("t", 0)
        um.concurrent_limit = 1
        assert um.serve_piece("t", 0) == b"z" * PIECE
        assert um.upload_count == 1

    def test_serve_range(self, tmp_path):
        st = DaemonStorage(str(tmp_path / "s"), prefer_native=False)
        st.register_task("t", piece_size=4, content_length=12)
        st.write_piece("t", 0, b"abcd")
        st.write_piece("t", 1, b"efgh")
        st.write_piece("t", 2, b"ijkl")
        um = UploadManager(st)
        assert um.serve_range("t", 2, 8, 4) == b"cdefghij"


class TestTrafficShaper:
    def test_proportional_allocation(self):
        ts = TrafficShaper(100.0, min_share=0.1)
        ts.add_task("a")
        ts.add_task("b")
        assert ts.budget("a") == 50.0
        ts.record("a", 900)
        ts.record("b", 100)
        alloc = ts.allocate()
        assert alloc["a"] > alloc["b"]
        assert alloc["a"] + alloc["b"] == pytest.approx(100.0)
        assert alloc["b"] >= 10.0  # floor


class TestPeerExchange:
    def test_advertise_and_reclaim(self):
        bus = GossipBus()
        a = PeerExchange(MemberMeta("host-a"), bus)
        b = PeerExchange(MemberMeta("host-b"), bus)
        a.serve()
        b.serve()
        a.advertise("task-1", {0, 1, 2})
        assert b.find_peers_with_task("task-1") == ["host-a"]
        assert b.find_peers_with_piece("task-1", 1) == ["host-a"]
        assert b.find_peers_with_piece("task-1", 9) == []
        # Late joiner learns existing holdings.
        c = PeerExchange(MemberMeta("host-c"), bus)
        c.serve()
        assert c.find_peers_with_task("task-1") == ["host-a"]
        # Leave reclaims.
        a.stop()
        assert b.find_peers_with_task("task-1") == []
        assert {m.host_id for m in b.members()} == {"host-c"}


class _Swarm:
    """Scheduler + N daemons in one process."""

    def __init__(self, tmp_path, n_hosts=4, record_storage=None):
        self.resource = Resource()
        self.scheduler = SchedulerService(
            self.resource,
            Scheduling(Evaluator(), SchedulingConfig(retry_interval=0)),
            record_storage,
            NetworkTopology(self.resource.host_manager),
        )
        self.origin = FakeOrigin()
        self.registry = {}
        self.bus = GossipBus()
        self.daemons = []
        for i in range(n_hosts):
            host = make_host(i)
            self.resource.store_host(host)
            d = Daemon(
                host,
                self.scheduler,
                storage_root=str(tmp_path / f"d{i}"),
                daemon_registry=self.registry,
                gossip_bus=self.bus,
                source_fetcher=self.origin,
                prefer_native=False,
            )
            self.daemons.append(d)


class TestConductorE2E:
    def test_first_peer_back_to_source_then_p2p(self, tmp_path):
        swarm = _Swarm(tmp_path)
        url = "https://origin/blob-1"
        # First peer: no parents → back-to-source.
        r0 = swarm.daemons[0].download(
            url, piece_size=PIECE, content_length=4 * PIECE
        )
        assert r0.ok and r0.back_to_source and r0.pieces == 4
        fetches_after_seed = swarm.origin.fetches
        assert fetches_after_seed == 4

        # Second peer: scheduler must hand it daemon 0 as parent; the bytes
        # flow through daemon 0's upload manager, not the origin.
        r1 = swarm.daemons[1].download(url, piece_size=PIECE)
        assert r1.ok and not r1.back_to_source
        assert swarm.origin.fetches == fetches_after_seed  # origin untouched
        assert swarm.daemons[0].upload.upload_count == 4
        # Bytes identical to origin content.
        for n in range(4):
            assert swarm.daemons[1].storage.read_piece(r1.task_id, n) == \
                swarm.origin.content(url, n)

        # Third peer: two candidate parents now.
        r2 = swarm.daemons[2].download(url, piece_size=PIECE)
        assert r2.ok and not r2.back_to_source
        # pex knows the holders.
        assert set(
            swarm.daemons[3].pex.find_peers_with_task(r1.task_id)
        ) >= {"host-0", "host-1"}

    def test_concurrent_back_to_source_groups(self, tmp_path):
        """piece_manager.go:793-873: range groups fetched concurrently."""
        import threading
        import time as _time

        class SlowOrigin(FakeOrigin):
            def __init__(self):
                super().__init__(total_pieces=8)
                self.in_flight = 0
                self.max_in_flight = 0
                self._lock = threading.Lock()

            def fetch(self, url, number, piece_size):
                with self._lock:
                    self.in_flight += 1
                    self.max_in_flight = max(self.max_in_flight, self.in_flight)
                _time.sleep(0.02)
                try:
                    return super().fetch(url, number, piece_size)
                finally:
                    with self._lock:
                        self.in_flight -= 1

        swarm = _Swarm(tmp_path)
        origin = SlowOrigin()
        d = swarm.daemons[0]
        d.conductor.source_fetcher = origin
        d.conductor.concurrent_source_groups = 4
        url = "https://origin/concurrent-blob"
        r = d.download(url, piece_size=PIECE, content_length=8 * PIECE)
        assert r.ok and r.back_to_source and r.pieces == 8
        assert origin.max_in_flight > 1  # groups genuinely overlapped
        for n in range(8):
            assert d.storage.read_piece(r.task_id, n) == origin.content(url, n)
        # Next peer still gets the bytes over P2P.
        r1 = swarm.daemons[1].download(url, piece_size=PIECE)
        assert r1.ok and not r1.back_to_source

    def test_concurrent_back_to_source_group_failure_cancels(self, tmp_path):
        class FlakyOrigin(FakeOrigin):
            def fetch(self, url, number, piece_size):
                if number == 5:
                    raise IOError("origin 500")
                return super().fetch(url, number, piece_size)

        swarm = _Swarm(tmp_path)
        d = swarm.daemons[0]
        d.conductor.source_fetcher = FlakyOrigin()
        d.conductor.concurrent_source_groups = 4
        r = d.download(
            "https://origin/flaky-blob", piece_size=PIECE, content_length=8 * PIECE
        )
        assert not r.ok

    def test_download_records_written(self, tmp_path):
        store = Storage(str(tmp_path / "records"), buffer_size=1)
        swarm = _Swarm(tmp_path, record_storage=store)
        url = "https://origin/blob-2"
        swarm.daemons[0].download(url, piece_size=PIECE, content_length=2 * PIECE)
        swarm.daemons[1].download(url, piece_size=PIECE)
        store.flush()
        downloads = store.list_download()
        assert len(downloads) == 2
        p2p = [d for d in downloads if d.parents]
        assert len(p2p) == 1
        assert p2p[0].parents[0].observed_bandwidth() > 0

    def test_parent_failure_reschedules(self, tmp_path):
        swarm = _Swarm(tmp_path)
        url = "https://origin/blob-3"
        swarm.daemons[0].download(url, piece_size=PIECE, content_length=2 * PIECE)
        swarm.daemons[1].download(url, piece_size=PIECE)
        # Sabotage daemon 0's storage so piece fetches from it fail; the
        # conductor must blocklist it and still finish via daemon 1 or source.
        task_id = swarm.daemons[1].storage.scan_disk_tasks()[0]
        swarm.daemons[0].storage.delete_task(task_id)
        r = swarm.daemons[2].download(url, piece_size=PIECE)
        assert r.ok

    def test_daemon_reload_advertises(self, tmp_path):
        swarm = _Swarm(tmp_path)
        url = "https://origin/blob-4"
        r = swarm.daemons[0].download(url, piece_size=PIECE, content_length=2 * PIECE)
        # Simulate restart: new daemon object on the same storage root.
        swarm.daemons[0].stop()
        d0b = Daemon(
            make_host(0),
            swarm.scheduler,
            storage_root=str(tmp_path / "d0"),
            daemon_registry=swarm.registry,
            gossip_bus=swarm.bus,
            source_fetcher=swarm.origin,
            prefer_native=False,
        )
        assert d0b.reload() == 1
        assert swarm.daemons[1].pex.find_peers_with_task(r.task_id) == ["host-0"]


class TestReviewRegressions:
    def test_shaper_many_tasks_no_negative_budget(self):
        ts = TrafficShaper(100.0, min_share=0.05)
        for i in range(40):
            ts.add_task(f"t{i}")
        ts.record("t0", 10_000)  # t0 hogs the window
        alloc = ts.allocate()
        assert all(v >= 0 for v in alloc.values()), alloc
        assert alloc["t0"] == max(alloc.values())
        assert sum(alloc.values()) == pytest.approx(100.0, rel=1e-6)

    def test_reload_advertises_tail_pieces(self, tmp_path):
        """A daemon holding only tail pieces must advertise them after reload."""
        swarm = _Swarm(tmp_path, n_hosts=2)
        d = swarm.daemons[0]
        tid = "tail-task"
        d.storage.register_task(tid, piece_size=PIECE, content_length=300 * PIECE)
        for n in range(250, 300):
            d.storage.write_piece(tid, n, b"x" * 10)
        d.stop()
        d0b = Daemon(
            make_host(0),
            swarm.scheduler,
            storage_root=str(tmp_path / "d0"),
            daemon_registry=swarm.registry,
            gossip_bus=swarm.bus,
            prefer_native=False,
        )
        assert d0b.reload() == 1
        holders = swarm.daemons[1].pex.find_peers_with_piece(tid, 299)
        assert holders == ["host-0"]

    def test_reclaim_retracts_pex_advertisement(self, tmp_path):
        swarm = _Swarm(tmp_path, n_hosts=2)
        url = "https://origin/evictable"
        r = swarm.daemons[0].download(url, piece_size=PIECE, content_length=2 * PIECE)
        assert swarm.daemons[1].pex.find_peers_with_task(r.task_id) == ["host-0"]
        swarm.daemons[0].delete_task(r.task_id)
        assert swarm.daemons[1].pex.find_peers_with_task(r.task_id) == []

    def test_back_to_source_resumes_not_restarts(self, tmp_path):
        """P2P pieces already on disk are not re-fetched from the origin,
        and their parent attribution survives."""
        swarm = _Swarm(tmp_path)
        url = "https://origin/resume"
        swarm.daemons[0].download(url, piece_size=PIECE, content_length=4 * PIECE)
        fetches_before = swarm.origin.fetches

        # Child daemon: manually drive the conductor so the parent dies
        # mid-download (after serving half the pieces).
        child = swarm.daemons[1]
        reg = swarm.scheduler.register_peer(host=child.host, url=url)
        task = reg.peer.task
        child.storage.register_task(task.id, piece_size=PIECE, content_length=task.content_length)
        parents = reg.schedule.parents
        for n in (0, 1):
            data = child.conductor.piece_fetcher.fetch(parents[0].host.id, task.id, n)
            child.storage.write_piece(task.id, n, data)
            swarm.scheduler.report_piece_finished(
                reg.peer, n, parent_id=parents[0].id, length=len(data), cost_ns=1000
            )
        # Origin serves only the remaining pieces.
        res = child.conductor._pull_from_source(reg.peer, 4, PIECE, 0.0)
        assert res.ok
        assert swarm.origin.fetches == fetches_before + 2  # pieces 2,3 only
        # Parent attribution for pieces 0,1 intact on the peer record.
        assert reg.peer.pieces[0].parent_id == parents[0].id
        assert reg.peer.pieces[2].parent_id == ""


class TestHostAnnouncer:
    def test_embedded_and_wire_announce(self, tmp_path):
        from dragonfly2_tpu_torch.daemon.host_announcer import HostAnnouncer

        swarm = _Swarm(tmp_path, n_hosts=1)
        host = swarm.daemons[0].host
        host.stats.cpu.percent = 0.0
        ann = HostAnnouncer(host, swarm.scheduler, collect_stats=True)
        ann.announce_once()
        stored = swarm.scheduler.resource.host_manager.load(host.id)
        assert stored is host
        # Stats were refreshed from the real machine (memory is nonzero).
        assert host.stats.memory.total > 0


class TestSwarmChurn:
    def test_quota_eviction_mid_swarm_recovers(self, tmp_path):
        """A parent evicts a hot task under quota pressure mid-swarm; later
        children still finish (reschedule or back-to-source) and pex no
        longer routes to the evicted holder."""
        swarm = _Swarm(tmp_path)
        url = "https://origin/churn"
        r0 = swarm.daemons[0].download(url, piece_size=PIECE, content_length=3 * PIECE)
        swarm.daemons[1].download(url, piece_size=PIECE)
        # Daemon 0 hits quota: its copy of the task evicts + retracts.
        swarm.daemons[0].storage.quota_bytes = 0
        evicted = swarm.daemons[0].reclaim()
        assert r0.task_id in evicted
        assert swarm.daemons[2].pex.find_peers_with_task(r0.task_id) == ["host-1"]
        # New child still completes.
        r2 = swarm.daemons[2].download(url, piece_size=PIECE)
        assert r2.ok

    def test_host_leave_reaps_peers_and_topology(self, tmp_path):
        swarm = _Swarm(tmp_path, n_hosts=3)
        url = "https://origin/leaver"
        swarm.daemons[0].download(url, piece_size=PIECE, content_length=2 * PIECE)
        # Probe edges exist touching host-0.
        swarm.scheduler.networktopology.enqueue_probe(
            "host-0", "host-1", __import__("dragonfly2_tpu_torch.scheduler.networktopology",
                fromlist=["Probe"]).Probe("host-1", 1000)
        )
        host0 = swarm.scheduler.resource.host_manager.load("host-0")
        swarm.scheduler.leave_host(host0)
        assert swarm.scheduler.networktopology.edge_count() == 0
        # Peers on host-0 are in Leave and get reaped by GC.
        reaped = swarm.scheduler.resource.peer_manager.run_gc()
        assert reaped >= 1


class TestTinyAndSeedTrigger:
    def test_tiny_direct_piece_roundtrip(self, tmp_path):
        """First peer publishes a <=128B task inline; the second peer gets
        the bytes with registration — zero transfers."""
        swarm = _Swarm(tmp_path, n_hosts=2)
        url = "https://origin/tiny-manifest"
        payload = b"x" * 100

        class TinyOrigin:
            def fetch(self, u, n, ps):
                return payload

        swarm.daemons[0].conductor.source_fetcher = TinyOrigin()
        r0 = swarm.daemons[0].download(url, piece_size=65536, content_length=100)
        assert r0.ok and r0.back_to_source
        task = swarm.scheduler.resource.task_manager.load(r0.task_id)
        assert task.direct_piece == payload
        # Second peer: inline bytes, no fetch, no parent.
        r1 = swarm.daemons[1].download(url, piece_size=65536)
        assert r1.ok and not r1.back_to_source and r1.bytes == 100
        assert swarm.daemons[1].storage.read_piece(r1.task_id, 0) == payload
        assert swarm.daemons[0].upload.upload_count == 0

class TestPeerEngine:
    """The concurrent peer engine (VERDICT r2 missing-#1/#8 done-
    conditions): parallel piece workers, streaming tasks, completed-task
    reuse, piece-metadata subscription to mid-download parents."""

    def _seed(self, swarm, url, n_pieces):
        r = swarm.daemons[0].download(
            url, piece_size=PIECE, content_length=n_pieces * PIECE
        )
        assert r.ok
        return r.task_id

    def test_pieces_fetched_concurrently_with_speedup(self, tmp_path):
        """One task's pieces overlap across 3 parents: wall-clock beats the
        sequential bound (peertask_conductor.go:1009-1077 worker pool)."""
        import time

        swarm = _Swarm(tmp_path, n_hosts=5)
        url = "https://origin/parallel-blob"
        n_pieces = 12
        self._seed(swarm, url, n_pieces)
        for i in (1, 2):  # 3 serveable parents total
            assert swarm.daemons[i].download(url, piece_size=PIECE).ok

        # The in-process fixture's piece costs are microseconds, so ONE
        # noisy fetch under full-suite load (GC pause, CPU contention)
        # trips the 20x-mean bad-node outlier rule on the seed parents
        # (evaluator.is_bad_node) and the scheduler hands the child a
        # single candidate — observed as {'host-0': 12} fan-in.  This
        # test proves the WORKER POOL fans out; bad-node filtering has
        # its own tests.  Level the stats so the candidate set is
        # deterministically all three parents.
        for p in swarm.resource.peer_manager.items():
            with p._mu:
                p.piece_costs_ns.clear()

        child = swarm.daemons[4]
        inner = child.conductor.piece_fetcher
        served_by = {}
        delay = 0.05
        import threading

        gauge = {"now": 0, "max": 0}
        gauge_mu = threading.Lock()

        class SlowFetcher:
            def fetch(self, host_id, task_id, number):
                with gauge_mu:
                    gauge["now"] += 1
                    gauge["max"] = max(gauge["max"], gauge["now"])
                try:
                    time.sleep(delay)
                    data = inner.fetch(host_id, task_id, number)
                finally:
                    with gauge_mu:
                        gauge["now"] -= 1
                served_by.setdefault(host_id, 0)
                served_by[host_id] += 1
                return data

            def piece_bitmap(self, host_id, task_id):
                return inner.piece_bitmap(host_id, task_id)

        child.conductor.piece_fetcher = SlowFetcher()
        t0 = time.monotonic()
        r = child.download(url, piece_size=PIECE)
        wall = time.monotonic() - t0
        assert r.ok and not r.back_to_source and r.pieces == n_pieces
        # Direct concurrency evidence (load-independent, unlike a wall-
        # clock bound): multiple fetches were IN FLIGHT simultaneously,
        # across multiple parents.  Wall time only guards against a fully
        # serialized regression with a generous margin.
        assert gauge["max"] >= 2, f"pieces never overlapped (max={gauge['max']})"
        assert len(served_by) >= 2, f"single-parent fan-in: {served_by}"
        assert wall < n_pieces * delay, f"slower than sequential: {wall:.2f}s"

    def test_completed_task_reuse_skips_scheduler(self, tmp_path):
        """A locally-complete task serves from disk with zero scheduler
        contact (peertask_reuse.go:49)."""
        swarm = _Swarm(tmp_path, n_hosts=2)
        url = "https://origin/reuse-blob"
        self._seed(swarm, url, 4)
        calls = []
        orig = swarm.scheduler.register_peer

        def counting(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        swarm.scheduler.register_peer = counting
        try:
            r = swarm.daemons[0].download(
                url, piece_size=PIECE, content_length=4 * PIECE
            )
        finally:
            swarm.scheduler.register_peer = orig
        assert r.ok and r.reused
        assert r.pieces == 4 and r.bytes == 4 * PIECE
        assert not calls, "reuse path contacted the scheduler"

    def test_concurrent_same_task_downloads_join(self, tmp_path):
        """Two simultaneous downloads of one task run ONE conductor; the
        second attaches (findPeerTaskConductor semantics)."""
        import threading
        import time

        swarm = _Swarm(tmp_path, n_hosts=3)
        url = "https://origin/join-blob"
        n_pieces = 6
        self._seed(swarm, url, n_pieces)

        child = swarm.daemons[2]
        inner = child.conductor.piece_fetcher

        class SlowFetcher:
            def fetch(self, host_id, task_id, number):
                time.sleep(0.03)
                return inner.fetch(host_id, task_id, number)

            def piece_bitmap(self, host_id, task_id):
                return inner.piece_bitmap(host_id, task_id)

        child.conductor.piece_fetcher = SlowFetcher()
        results = []

        def dl():
            results.append(child.download(url, piece_size=PIECE))

        threads = [threading.Thread(target=dl) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert all(r.ok for r in results)
        assert any(r.reused for r in results), "both runs fetched"
        # The parent served each piece exactly once.
        assert swarm.daemons[0].upload.upload_count == n_pieces

    def test_stream_serves_bytes_before_task_finishes(self, tmp_path):
        """open_stream yields committed pieces while the download is still
        running (StartStreamTask, peertask_manager.go:357-423)."""
        import time

        swarm = _Swarm(tmp_path, n_hosts=3)
        url = "https://origin/stream-early-blob"
        n_pieces = 6
        tid = self._seed(swarm, url, n_pieces)
        expected = b"".join(swarm.origin.content(url, n) for n in range(n_pieces))

        child = swarm.daemons[2]
        child.conductor.piece_parallelism = 1  # strictly one piece at a time
        inner = child.conductor.piece_fetcher

        class SlowFetcher:
            def fetch(self, host_id, task_id, number):
                time.sleep(0.08)
                return inner.fetch(host_id, task_id, number)

            def piece_bitmap(self, host_id, task_id):
                return inner.piece_bitmap(host_id, task_id)

        child.conductor.piece_fetcher = SlowFetcher()
        handle = child.open_stream(url, piece_size=PIECE)
        assert handle.content_length == n_pieces * PIECE
        chunks = handle.chunks()
        first = next(chunks)
        # The run is still alive after the first chunk arrives: bytes
        # flowed BEFORE the task finished.
        assert child.conductor.active_run(tid) is not None
        body = first + b"".join(chunks)
        assert body == expected
        # And the finished task is now reusable with no new traffic.
        h2 = child.open_stream(url, piece_size=PIECE)
        assert h2.reused and h2.read_all() == expected

    def test_child_completes_from_initially_empty_parent(self, tmp_path):
        """VERDICT r2 next-#8 done-condition: the child's only parent
        starts with ZERO pieces; bitmap subscription picks pieces up as
        the parent commits them mid-download."""
        import threading
        import time

        swarm = _Swarm(tmp_path, n_hosts=2)
        url = "https://origin/empty-parent-blob"
        n_pieces = 6

        real_fetch = swarm.origin.fetch

        def slow_fetch(u, number, piece_size):
            time.sleep(0.08)
            return real_fetch(u, number, piece_size)

        swarm.origin.fetch = slow_fetch

        parent = swarm.daemons[0]
        child = swarm.daemons[1]
        child.conductor.piece_poll_interval_s = 0.02
        results = {}

        def parent_dl():
            results["parent"] = parent.download(
                url, piece_size=PIECE, content_length=n_pieces * PIECE
            )

        t = threading.Thread(target=parent_dl)
        t.start()
        # Wait until the parent's run exists and is sized (registered with
        # the scheduler, zero or near-zero pieces on disk yet).
        from dragonfly2_tpu_torch.utils import idgen

        tid = idgen.task_id(url)
        deadline = time.time() + 5
        while time.time() < deadline:
            run = parent.conductor.active_run(tid)
            if run is not None and run.n_pieces > 0:
                break
            time.sleep(0.01)
        assert parent.conductor.active_run(tid) is not None

        r = child.download(url, piece_size=PIECE)
        t.join(timeout=10)
        assert results["parent"].ok and results["parent"].back_to_source
        assert r.ok and not r.back_to_source, "child should ride the parent"
        # Child never touched the origin: 6 fetches total (parent's own).
        assert swarm.origin.fetches == n_pieces
        assert child.read_task_bytes(tid) == b"".join(
            swarm.origin.content(url, n) for n in range(n_pieces)
        )


class TestPexWorkerPool:
    def test_scheduler_down_fallback_overlaps_pieces(self, tmp_path):
        """The pex fallback uses the same worker-pool shape as the
        scheduled path: pieces overlap across gossip-discovered holders."""
        import threading
        import time

        swarm = _Swarm(tmp_path, n_hosts=3)
        url = "https://origin/pex-pool-blob"
        n_pieces = 8
        r = swarm.daemons[0].download(
            url, piece_size=PIECE, content_length=n_pieces * PIECE
        )
        assert r.ok
        assert swarm.daemons[1].download(url, piece_size=PIECE).ok

        child = swarm.daemons[2]
        inner = child.conductor.piece_fetcher
        gauge = {"now": 0, "max": 0}
        mu = threading.Lock()

        class SlowFetcher:
            def fetch(self, host_id, task_id, number):
                with mu:
                    gauge["now"] += 1
                    gauge["max"] = max(gauge["max"], gauge["now"])
                try:
                    time.sleep(0.03)
                    return inner.fetch(host_id, task_id, number)
                finally:
                    with mu:
                        gauge["now"] -= 1

            def piece_bitmap(self, host_id, task_id):
                return inner.piece_bitmap(host_id, task_id)

        child.conductor.piece_fetcher = SlowFetcher()

        # Scheduler down: registration raises → the pex pool takes over.
        def dead_register(**kw):
            raise ConnectionError("scheduler down")

        child.conductor.scheduler = type(
            "Down", (), {"register_peer": staticmethod(dead_register)}
        )()
        r2 = child.conductor.download(
            url, piece_size=PIECE, content_length=n_pieces * PIECE
        )
        assert r2.ok and r2.pieces == n_pieces
        assert gauge["max"] >= 2, f"pex pieces never overlapped: {gauge}"
        assert child.read_task_bytes(r2.task_id) == b"".join(
            swarm.origin.content(url, n) for n in range(n_pieces)
        )[: n_pieces * PIECE]


# -- the two packages' piece stores against each other ----------------------


def _write_task(storage_cls, root, pieces, *, content_length, **kw):
    st = storage_cls(str(root), **kw)
    st.register_task("shared-task", piece_size=PIECE, content_length=content_length)
    for number, data in pieces:
        st.write_piece("shared-task", number, data)
    st.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_store_written_by_one_package_reloads_in_the_other(tmp_path, writer):
    from dragonfly2_tpu.daemon.storage import DaemonStorage as JDaemonStorage

    rng = np.random.default_rng(3)
    content_length = 5 * PIECE + 777
    # Out of order, a tail piece and a repeated write: the journal keeps
    # every commit line, the reload keeps the last.
    pieces = [(n, rng.bytes(PIECE)) for n in (3, 0, 1)]
    pieces += [(5, rng.bytes(777)), (1, rng.bytes(PIECE))]
    classes = {"jax": (JDaemonStorage, {"prefer_native": False}),
               "torch": (DaemonStorage, {"prefer_native": False})}
    for name, (cls, kw) in classes.items():
        _write_task(cls, tmp_path / name, pieces, content_length=content_length, **kw)
    for fname in ("header.json", "pieces.jsonl", "data"):
        assert (tmp_path / "jax" / "shared-task" / fname).read_bytes() == \
            (tmp_path / "torch" / "shared-task" / fname).read_bytes(), fname

    reader_name = "torch" if writer == "jax" else "jax"
    cls, kw = classes[reader_name]
    st = cls(str(tmp_path / writer), **kw)
    assert st.reload_persistent_tasks(st.scan_disk_tasks()) == ["shared-task"]
    want = dict(pieces)
    assert list(st.piece_bitmap("shared-task", 6)) == [1, 1, 0, 1, 0, 1]
    for number, data in want.items():
        assert st.read_piece("shared-task", number) == data
    assert st.task_bytes("shared-task") == sum(len(d) for d in want.values())
    assert st.n_pieces("shared-task") == 6
    assert st.range_file_span("shared-task", 0, 2 * PIECE) == (
        str(tmp_path / writer / "shared-task" / "data"), 0, 2 * PIECE)
    # The reader commits a new piece into the writer's task, and the writer
    # package reloads the result.
    st.write_piece("shared-task", 2, b"\x07" * PIECE)
    st.close()
    cls, kw = classes[writer]
    back = cls(str(tmp_path / writer), **kw)
    assert back.reload_persistent_tasks(back.scan_disk_tasks()) == ["shared-task"]
    assert back.held_pieces("shared-task") == 5
    assert back.read_piece("shared-task", 2) == b"\x07" * PIECE


def test_task_the_jax_daemon_wrote_reloads_in_a_port_daemon(tmp_path):
    """A JAX daemon downloads a task back to source; a port daemon restarts
    on that storage root, reloads the task, advertises it to its swarm's
    gossip and serves it from disk, with no origin fetch."""
    from dragonfly2_tpu.daemon import Daemon as JDaemon
    from dragonfly2_tpu.scheduler import Evaluator as JEvaluator
    from dragonfly2_tpu.scheduler import Resource as JResource
    from dragonfly2_tpu.scheduler import SchedulerService as JSchedulerService
    from dragonfly2_tpu.scheduler import Scheduling as JScheduling
    from dragonfly2_tpu.scheduler import SchedulingConfig as JSchedulingConfig
    from dragonfly2_tpu.scheduler.resource import Host as JHost

    url = "https://origin/cross-reload"
    root = tmp_path / "shared-root"
    j_resource = JResource()
    j_scheduler = JSchedulerService(
        j_resource, JScheduling(JEvaluator(), JSchedulingConfig(retry_interval=0)))
    j_host = JHost(id="host-0", hostname="host-0", ip="10.0.0.0", port=8002,
                   download_port=8001)
    j_resource.store_host(j_host)
    j_daemon = JDaemon(j_host, j_scheduler, storage_root=str(root),
                       source_fetcher=FakeOrigin(), prefer_native=False)
    r0 = j_daemon.download(url, piece_size=PIECE, content_length=4 * PIECE)
    assert r0.ok and r0.back_to_source
    j_daemon.stop()

    swarm = _Swarm(tmp_path, n_hosts=2)
    swarm.daemons[0].stop()
    d0 = Daemon(make_host(0), swarm.scheduler, storage_root=str(root),
                daemon_registry=swarm.registry, gossip_bus=swarm.bus,
                source_fetcher=swarm.origin)
    assert d0.reload() == 1
    assert swarm.daemons[1].pex.find_peers_with_task(r0.task_id) == ["host-0"]
    # Reuse-first: the task is whole on disk, so the download serves the
    # JAX daemon's pieces with no scheduler or origin contact.
    assert d0.download(url, piece_size=PIECE, content_length=4 * PIECE).reused
    assert swarm.origin.fetches == 0
    want = b"".join(FakeOrigin().content(url, n) for n in range(4))
    assert d0.read_task_bytes(r0.task_id) == want
