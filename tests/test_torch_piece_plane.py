"""Port parity: the piece data plane (DESIGN.md §22),
``dragonfly2_tpu_torch`` against ``dragonfly2_tpu``.

The cases of ``tests/test_piece_plane.py`` on the port: keep-alive
connection pool lifecycle, sendfile/buffered serve byte-identity (pieces
AND byte ranges), sub-piece Range reads, the commit pipeline, batched
piece reports across transports and hedged straggler fetch, on the
Python store and server (the two packages' Python planes are compared).
The native cases are ``tests/test_torch_native_server.py`` and
``tests/test_torch_native_fetch.py``; the mTLS case and the
``tools/bench_download`` smoke are ROADMAP queue 1 item 14.

Then the two packages against each other: a port ``HTTPPieceFetcher``
reads from a JAX ``PieceHTTPServer`` and the other way round, and
bodies, ranges, bitmaps, long-polls, 503s and 404s are equal.
"""

from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from dragonfly2_tpu_torch.daemon import DaemonStorage, UploadManager
from dragonfly2_tpu_torch.daemon.piece_pipeline import (
    CommitPipeline,
    PieceLatencyTracker,
    PieceReportBatcher,
    hedged_fetch,
)
from dragonfly2_tpu_torch.rpc.piece_transport import (
    HTTPPieceFetcher,
    PieceConnectionPool,
    PieceHTTPServer,
)

PIECE = 64 * 1024


def _make_store(tmp_path, name: str, pieces, piece_size=PIECE, task="t"):
    st = DaemonStorage(str(tmp_path / name), prefer_native=False)
    st.register_task(
        task, piece_size=piece_size,
        content_length=sum(len(p) for p in pieces),
    )
    for i, p in enumerate(pieces):
        st.write_piece(task, i, p)
    return st


def _settled(cond, timeout=10.0) -> bool:
    """``cond()`` once it holds, polling up to ``timeout`` s: a server
    accounts a serve after it has written the body, so a client can hold
    the whole response a moment before the count moves."""
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _blocks(n, size=PIECE, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in range(n)]


class TestConnectionPool:
    def test_reuse_across_pieces_server_side_evidence(self, tmp_path):
        blocks = _blocks(4)
        st = _make_store(tmp_path, "s", blocks)
        server = PieceHTTPServer(UploadManager(st))
        server.serve()
        try:
            fetcher = HTTPPieceFetcher(lambda hid: ("127.0.0.1", server.port))
            for rep in range(3):
                for i in range(4):
                    assert fetcher.fetch("p", "t", i) == blocks[i]
            # 12 pieces over (at most a couple of) keep-alive connections:
            # the server saw far fewer connections than requests, and the
            # pool recorded the reuses.
            assert server.connections_accepted <= 2
            assert fetcher.pool.reuses >= 10
            assert fetcher.pool.dials == server.connections_accepted
        finally:
            fetcher.close()
            server.stop()

    def test_legacy_unpooled_dials_per_piece(self, tmp_path):
        blocks = _blocks(3)
        st = _make_store(tmp_path, "s", blocks)
        server = PieceHTTPServer(UploadManager(st))
        server.serve()
        try:
            fetcher = HTTPPieceFetcher(
                lambda hid: ("127.0.0.1", server.port), pooled=False
            )
            for i in range(3):
                assert fetcher.fetch("p", "t", i) == blocks[i]
            assert server.connections_accepted == 3  # one per piece
        finally:
            server.stop()

    def test_parent_restart_stale_socket_redials(self, tmp_path):
        blocks = _blocks(2)
        st = _make_store(tmp_path, "s", blocks)
        upload = UploadManager(st)
        server = PieceHTTPServer(upload)
        server.serve()
        port = server.port
        fetcher = HTTPPieceFetcher(lambda hid: ("127.0.0.1", port))
        try:
            assert fetcher.fetch("p", "t", 0) == blocks[0]
            assert fetcher.pool.idle_count("p") == 1
            server.stop()
            # A stopped ThreadingHTTPServer closes its LISTENER but its
            # per-connection threads drain gracefully — kill the pooled
            # socket to model the restart actually severing connections.
            fetcher.pool._idle["p"][0].sock.close()
            # Same port, new server process-analog: the pooled socket is
            # dead; the retry must detect it and re-dial transparently.
            server = PieceHTTPServer(upload, port=port)
            server.serve()
            assert fetcher.fetch("p", "t", 1) == blocks[1]
            assert fetcher.pool.dials >= 2
        finally:
            fetcher.close()
            server.stop()

    def test_parent_reresolve_invalidates_pool(self, tmp_path):
        blocks = _blocks(2)
        st = _make_store(tmp_path, "s", blocks)
        upload = UploadManager(st)
        server_a = PieceHTTPServer(upload)
        server_a.serve()
        server_b = PieceHTTPServer(upload)
        server_b.serve()
        addr = {"port": server_a.port}
        fetcher = HTTPPieceFetcher(lambda hid: ("127.0.0.1", addr["port"]))
        try:
            assert fetcher.fetch("p", "t", 0) == blocks[0]
            assert fetcher.pool.idle_count("p") == 1
            # Parent restarted on a NEW announced port: the resolver now
            # answers differently → the stale-address pool entry drops.
            addr["port"] = server_b.port
            assert fetcher.fetch("p", "t", 1) == blocks[1]
            assert server_b.connections_accepted == 1
            # Only the fresh-address connection is pooled.
            assert fetcher.pool.idle_count("p") == 1
            assert fetcher.pool.dials == 2
        finally:
            fetcher.close()
            server_a.stop()
            server_b.stop()

    def test_breaker_open_drains_pool(self, tmp_path):
        blocks = _blocks(1)
        st = _make_store(tmp_path, "s", blocks)
        server = PieceHTTPServer(UploadManager(st))
        server.serve()
        fetcher = HTTPPieceFetcher(
            lambda hid: ("127.0.0.1", server.port),
            breaker_threshold=2, timeout=1.0,
        )
        try:
            assert fetcher.fetch("p", "t", 0) == blocks[0]
            assert fetcher.pool.idle_count("p") == 1
            server.stop()
            # Sever the surviving keep-alive socket too (stop() only
            # closes the listener): attempt 1 hits the dead socket,
            # attempt 2's dial is refused → threshold-2 breaker opens.
            fetcher.pool._idle["p"][0].sock.close()
            with pytest.raises(Exception):
                fetcher.fetch("p", "t", 0)
            assert fetcher._breaker("p").state == "open"
            # Breaker-open invalidated the parent's pooled sockets.
            assert fetcher.pool.idle_count("p") == 0
        finally:
            fetcher.close()

    def test_pool_bounds_idle_connections(self):
        pool = PieceConnectionPool(max_idle_per_parent=1)

        class _Conn:
            host, port = "127.0.0.1", 1
            closed = 0

            def close(self):
                self.closed += 1

        pool._addr["p"] = ("127.0.0.1", 1)
        c1, c2 = _Conn(), _Conn()
        pool.release("p", c1, reusable=True)
        pool.release("p", c2, reusable=True)  # over the idle bound
        assert pool.idle_count("p") == 1 and c2.closed == 1
        pool.invalidate("p")
        assert pool.idle_count("p") == 0 and c1.closed == 1


class TestSendfileByteIdentity:
    def _servers(self, tmp_path, blocks, piece_size=PIECE):
        st = _make_store(tmp_path, "s", blocks, piece_size=piece_size)
        upload = UploadManager(st)
        fast = PieceHTTPServer(upload, use_sendfile=True)
        slow = PieceHTTPServer(upload, use_sendfile=False)
        fast.serve()
        slow.serve()
        return st, upload, fast, slow

    def test_piece_bodies_identical(self, tmp_path):
        blocks = _blocks(4)
        st, upload, fast, slow = self._servers(tmp_path, blocks)
        try:
            ff = HTTPPieceFetcher(lambda hid: ("127.0.0.1", fast.port))
            fs = HTTPPieceFetcher(lambda hid: ("127.0.0.1", slow.port))
            for i in range(4):
                a = ff.fetch("p", "t", i)
                b = fs.fetch("p", "t", i)
                assert a == b == blocks[i]
            assert _settled(lambda: fast.sendfile_serves == 4 and upload.upload_count == 8)
            assert slow.sendfile_serves == 0
            # Both paths went through the shared accounting gate.
            assert upload.upload_count == 8
            assert upload.bytes_served == 8 * PIECE
        finally:
            ff.close()
            fs.close()
            fast.stop()
            slow.stop()

    def _range_get(self, port, task, rng_header):
        import urllib.request

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tasks/{task}",
            headers={"Range": rng_header},
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, resp.read()

    def test_range_requests_identical_and_correct(self, tmp_path):
        blocks = _blocks(4)
        blob = b"".join(blocks)
        st, upload, fast, slow = self._servers(tmp_path, blocks)
        try:
            total = len(blob)
            cases = [
                f"bytes=0-{total - 1}",            # whole object
                "bytes=0-99",                       # head
                f"bytes={PIECE - 50}-{PIECE + 49}",  # straddles a boundary
                f"bytes={total - 100}-",            # open end
                "bytes=-100",                       # suffix
                f"bytes={2 * PIECE + 7}-{2 * PIECE + 7}",  # single byte
            ]
            for case in cases:
                code_f, body_f = self._range_get(fast.port, "t", case)
                code_s, body_s = self._range_get(slow.port, "t", case)
                assert code_f == code_s == 206
                assert body_f == body_s, case
                # Correctness against the whole object's bytes.
                spec = case[len("bytes="):]
                s, e = spec.split("-", 1)
                if s == "":
                    want = blob[-int(e):]
                elif e == "":
                    want = blob[int(s):]
                else:
                    want = blob[int(s): int(e) + 1]
                assert body_f == want, case
            assert _settled(lambda: fast.sendfile_serves >= len(cases))
        finally:
            fast.stop()
            slow.stop()

    def test_small_range_reads_only_the_span(self, tmp_path):
        """The serve_range small-read fix: a 100-byte Range request must
        not materialize whole overlapping pieces (feeds the roadmap's
        OCI/ranged-reads item)."""
        blocks = _blocks(2)
        st = _make_store(tmp_path, "s", blocks)
        upload = UploadManager(st)

        calls = {"full": 0, "at": []}
        engine = st.engine
        orig_read, orig_at = engine.read_piece, engine.read_piece_at

        def counting_read(task_id, number, **kw):
            calls["full"] += 1
            return orig_read(task_id, number, **kw)

        def counting_at(task_id, number, offset, max_len):
            calls["at"].append((number, offset, max_len))
            return orig_at(task_id, number, offset, max_len)

        engine.read_piece = counting_read
        engine.read_piece_at = counting_at
        data = upload.serve_range("t", PIECE - 50, 100, PIECE)
        assert data == b"".join(blocks)[PIECE - 50: PIECE + 50]
        assert calls["full"] == 0, "whole-piece read on a 100-byte range"
        assert len(calls["at"]) == 2  # one sub-read per overlapped piece
        assert all(ml <= 100 for _, _, ml in calls["at"])

    def test_partial_task_range_falls_back_and_errors_on_hole(self, tmp_path):
        """range_file_span refuses a span over uncommitted pieces; the
        buffered fallback raises KeyError at the hole (pre-PR parity:
        the HTTP server maps it to 404)."""
        blocks = _blocks(3)
        st = DaemonStorage(str(tmp_path / "p"), prefer_native=False)
        st.register_task("t", piece_size=PIECE, content_length=3 * PIECE)
        st.write_piece("t", 0, blocks[0])
        st.write_piece("t", 2, blocks[2])  # hole at piece 1
        assert st.range_file_span("t", 0, 3 * PIECE) is None
        span = st.range_file_span("t", 10, 100)  # inside committed piece 0
        assert span is not None and span[1] == 10 and span[2] == 100
        assert st.range_file_span("t", PIECE + 10, 100) is None  # the hole
        upload = UploadManager(st)
        assert upload.serve_range("t", 0, PIECE, PIECE) == blocks[0]
        with pytest.raises(KeyError):
            upload.serve_range("t", 0, 3 * PIECE, PIECE)


class TestCommitPipeline:
    def test_commits_in_order_and_flushes_on_close(self):
        committed = []
        p = CommitPipeline(
            lambda n, d, pid, c: committed.append((n, d, pid, c)), depth=2
        )
        for i in range(6):
            assert p.submit(i, bytes([i]), "par", i * 10)
        assert p.close() is None
        assert committed == [
            (i, bytes([i]), "par", i * 10) for i in range(6)
        ]

    def test_error_latches_and_submit_refuses(self):
        def boom(n, d, pid, c):
            raise IOError("disk full")

        p = CommitPipeline(boom, depth=2)
        p.submit(0, b"x", "par", 1)
        deadline = time.monotonic() + 5
        while p.error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert isinstance(p.error, IOError)
        assert p.submit(1, b"y", "par", 1) is False
        assert isinstance(p.close(), IOError)

    def test_backpressure_bounds_queue(self):
        release = threading.Event()
        inflight = []

        def slow_commit(n, d, pid, c):
            inflight.append(n)
            release.wait(5)

        p = CommitPipeline(slow_commit, depth=1)
        assert p.submit(0, b"a", "p", 1)
        assert p.submit(1, b"b", "p", 1)  # fills the depth-1 queue
        blocked = {"done": False}

        def submit_third():
            p.submit(2, b"c", "p", 1)
            blocked["done"] = True

        t = threading.Thread(target=submit_third, daemon=True)
        t.start()
        time.sleep(0.15)
        assert not blocked["done"], "depth-1 queue did not backpressure"
        release.set()
        t.join(5)
        assert blocked["done"]
        p.close()


class _FakePeer:
    id = "peer-1"


class TestReportBatcher:
    def test_coalesces_into_batches(self):
        calls = []

        class Sched:
            def report_pieces_finished(self, peer, pieces):
                calls.append(list(pieces))

        b = PieceReportBatcher(Sched(), _FakePeer(), linger_s=0.05)
        for i in range(8):
            assert b.submit(i, "par", 100, 5)
        assert b.close() is None
        reported = [p["number"] for batch in calls for p in batch]
        assert sorted(reported) == list(range(8))
        # Coalescing happened: strictly fewer wire calls than reports.
        assert len(calls) < 8
        assert b.reported == 8 and b.flushes == len(calls)

    def test_falls_back_per_piece_without_batch_method(self):
        singles = []

        class Sched:
            def report_piece_finished(self, peer, number, *, parent_id="",
                                      length=0, cost_ns=0):
                singles.append((number, parent_id, length, cost_ns))

        b = PieceReportBatcher(Sched(), _FakePeer(), linger_s=0.0)
        for i in range(3):
            b.submit(i, "par", 7, 9)
        assert b.close() is None
        assert sorted(singles) == [(i, "par", 7, 9) for i in range(3)]

    def test_not_found_batch_degrades_to_singles(self):
        """N-1 wire skew: a pre-batch scheduler answers typed NOT_FOUND
        for the unknown method — the batcher degrades to per-piece
        reports for the rest of the download (DESIGN.md §10d)."""
        from dragonfly2_tpu_torch.rpc.scheduler_client import RPCError
        from dragonfly2_tpu_torch.utils.dferrors import Code

        singles = []
        batch_calls = []

        class OldSched:
            def report_pieces_finished(self, peer, pieces):
                batch_calls.append(len(pieces))
                raise RPCError(
                    "report_pieces_finished: HTTP 404: unknown method",
                    code=int(Code.NOT_FOUND),
                )

            def report_piece_finished(self, peer, number, *, parent_id="",
                                      length=0, cost_ns=0):
                singles.append(number)

        b = PieceReportBatcher(OldSched(), _FakePeer(), linger_s=0.0)
        for i in range(4):
            b.submit(i, "par", 3, 5)
        assert b.close() is None
        assert sorted(singles) == [0, 1, 2, 3]
        # The batch RPC was tried once, then remembered as unsupported.
        assert len(batch_calls) == 1

    def test_flush_error_latches(self):
        class Sched:
            def report_pieces_finished(self, peer, pieces):
                raise ConnectionError("scheduler down")

        b = PieceReportBatcher(Sched(), _FakePeer(), linger_s=0.0)
        b.submit(0, "par", 1, 1)
        deadline = time.monotonic() + 5
        while b.error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert isinstance(b.error, ConnectionError)
        assert b.submit(1, "par", 1, 1) is False
        assert isinstance(b.close(), ConnectionError)


class TestHedgedFetch:
    def test_no_threshold_means_plain_fetch(self):
        data, winner, hedged = hedged_fetch(
            lambda pid: b"x", lambda d: True, "a", "b", threshold_s=None
        )
        assert (data, winner, hedged) == (b"x", "a", False)

    def test_straggler_loses_to_hedge(self):
        stall = threading.Event()

        def fetch(pid):
            if pid == "slow":
                stall.wait(5)
                return b"late"
            return b"fast"

        data, winner, hedged = hedged_fetch(
            fetch, lambda d: True, "slow", "alt", threshold_s=0.05
        )
        stall.set()
        assert (data, winner, hedged) == (b"fast", "alt", True)

    def test_fast_primary_failure_propagates_not_hedges(self):
        def fetch(pid):
            raise ConnectionError("refused")

        with pytest.raises(ConnectionError):
            hedged_fetch(fetch, lambda d: True, "a", "b", threshold_s=5.0)

    def test_invalid_hedge_body_loses_to_valid_primary(self):
        def fetch(pid):
            if pid == "slow":
                time.sleep(0.15)
                return b"good"
            return b"bad"  # invalid — fails validate

        data, winner, hedged = hedged_fetch(
            fetch, lambda d: d == b"good", "slow", "alt", threshold_s=0.05
        )
        assert (data, winner, hedged) == (b"good", "slow", True)

    def test_tracker_threshold_derivation(self):
        t = PieceLatencyTracker(min_samples=4, floor_s=0.01, multiplier=2.0)
        assert t.threshold_s() is None
        for v in (0.01, 0.01, 0.01, 0.1):
            t.observe(v)
        th = t.threshold_s()
        assert th == pytest.approx(0.2)  # p99 (=0.1) × 2


class TestBatchReportRPC:
    def test_http_wire_batch_advances_scheduler_state(self, tmp_path):
        from dragonfly2_tpu_torch.records.storage import Storage
        from dragonfly2_tpu_torch.rpc import RemoteScheduler
        from dragonfly2_tpu_torch.rpc.scheduler_server import SchedulerHTTPServer
        from dragonfly2_tpu_torch.scheduler import (
            Evaluator,
            NetworkTopology,
            Resource,
            SchedulerService,
            Scheduling,
            SchedulingConfig,
        )
        from dragonfly2_tpu_torch.scheduler.resource import Host

        resource = Resource()
        service = SchedulerService(
            resource,
            Scheduling(Evaluator(), SchedulingConfig(retry_interval=0)),
            Storage(str(tmp_path / "records"), buffer_size=1),
            NetworkTopology(resource.host_manager),
        )
        server = SchedulerHTTPServer(service)
        server.serve()
        try:
            client = RemoteScheduler(server.url)
            host = Host(id="n0", hostname="n0", ip="127.0.0.1",
                        download_port=1)
            host.stats.network.idc = "idc-a"
            reg = client.register_peer(host=host, url="https://o/batch-rpc")
            client.set_task_info(reg.peer, 4 * PIECE, 4, PIECE)
            client.report_pieces_finished(
                reg.peer,
                [
                    {"number": i, "parent_id": "", "length": PIECE,
                     "cost_ns": 1000 + i}
                    for i in range(4)
                ],
            )
            # Client mirror advanced per piece...
            assert len(reg.peer.finished_pieces) == 4
            # ...and the SERVER's peer saw all four from one RPC.
            srv_peer = service.resource.peer_manager.load(reg.peer.id)
            assert srv_peer is not None and len(srv_peer.finished_pieces) == 4
        finally:
            server.stop()


# -- the two packages' piece planes against each other ----------------------


def _raw_get(port, path, headers=None):
    """(status, selected headers, body) of one plain GET."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return (resp.status, resp.headers.get("Content-Range"),
                    resp.headers.get("Content-Length"), resp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, None, None, b""


def _planes(tmp_path, blocks, *, concurrent_limit=50):
    """One store per package with the same pieces (piece 2 missing), an
    upload manager and a running piece server over each."""
    from dragonfly2_tpu.daemon import DaemonStorage as JDaemonStorage
    from dragonfly2_tpu.daemon import UploadManager as JUploadManager
    from dragonfly2_tpu.rpc.piece_transport import PieceHTTPServer as JPieceHTTPServer

    out = {}
    for name, (st_cls, um_cls, srv_cls, kw) in {
        "jax": (JDaemonStorage, JUploadManager, JPieceHTTPServer, {"prefer_native": False}),
        "torch": (DaemonStorage, UploadManager, PieceHTTPServer, {"prefer_native": False}),
    }.items():
        st = st_cls(str(tmp_path / name), **kw)
        st.register_task("t", piece_size=PIECE, content_length=len(blocks) * PIECE)
        for i, b in enumerate(blocks):
            if i != 2:
                st.write_piece("t", i, b)
        upload = um_cls(st, concurrent_limit=concurrent_limit)
        server = srv_cls(upload)
        server.serve()
        out[name] = (st, upload, server)
    return out


def _fetcher(pkg, port):
    from dragonfly2_tpu.rpc.piece_transport import HTTPPieceFetcher as JHTTPPieceFetcher

    cls = JHTTPPieceFetcher if pkg == "jax" else HTTPPieceFetcher
    return cls(lambda hid: ("127.0.0.1", port), breaker_threshold=100)


@pytest.mark.parametrize("server_pkg,fetcher_pkg", [("jax", "torch"), ("torch", "jax")])
def test_fetcher_reads_the_other_packages_server(tmp_path, server_pkg, fetcher_pkg):
    blocks = _blocks(4)
    planes = _planes(tmp_path, blocks)
    fetchers = {}
    try:
        fetchers = {pkg: _fetcher(fetcher_pkg, planes[pkg][2].port) for pkg in planes}
        f = fetchers[server_pkg]
        for i in (0, 1, 3):
            assert f.fetch("p", "t", i) == blocks[i]
        # The bitmap and the long-poll answer alike from both servers.
        bitmaps = {pkg: fx.piece_bitmap("p", "t") for pkg, fx in fetchers.items()}
        assert bitmaps["jax"] == bitmaps["torch"] == bytes([1, 1, 0, 1])
        t0 = time.monotonic()
        waited = {pkg: fx.wait_piece_bitmap("p", "t", 3, 0.2) for pkg, fx in fetchers.items()}
        assert waited["jax"] == waited["torch"] == bytes([1, 1, 0, 1])
        assert time.monotonic() - t0 >= 0.3  # each parked out its window
        # A missing piece is a 404 on both, and permanent for the fetcher.
        with pytest.raises(Exception) as exc:
            f.fetch("p", "t", 2)
        assert "404" in str(exc.value)
    finally:
        for fx in fetchers.values():
            fx.close()
        for _st, _up, srv in planes.values():
            srv.stop()


def test_both_servers_answer_byte_equal(tmp_path):
    blocks = _blocks(4)
    planes = _planes(tmp_path, blocks)
    blob = b"".join(blocks)
    try:
        total = len(blob)
        paths = [("/pieces/t/0", None), ("/pieces/t/3", None), ("/pieces/t/2", None),
                 ("/pieces/t/9", None), ("/pieces/nope/0", None),
                 ("/tasks/t/pieces", None), ("/tasks/t/pieces?have=3&wait_ms=50", None),
                 ("/tasks/nope/pieces", None), ("/no/such/route", None)]
        for rng in ("bytes=0-99", f"bytes={PIECE - 50}-{PIECE + 49}", "bytes=-100",
                    f"bytes={3 * PIECE}-", f"bytes={total + 5}-", "bytes=0-"):
            paths.append(("/tasks/t", {"Range": rng}))
        for path, headers in paths:
            got = {pkg: _raw_get(srv.port, path, headers) for pkg, (_s, _u, srv) in planes.items()}
            assert got["jax"] == got["torch"], (path, headers, got["jax"][:3], got["torch"][:3])
        assert _raw_get(planes["torch"][2].port, "/tasks/t", {"Range": "bytes=0-99"})[3] \
            == blob[:100]
    finally:
        for _st, _up, srv in planes.values():
            srv.stop()


def test_busy_servers_answer_503_alike(tmp_path):
    blocks = _blocks(2)
    planes = _planes(tmp_path, blocks, concurrent_limit=0)
    try:
        got = {pkg: _raw_get(srv.port, "/pieces/t/0") for pkg, (_s, _u, srv) in planes.items()}
        assert got["jax"][0] == got["torch"][0] == 503
        for server_pkg, fetcher_pkg in (("jax", "torch"), ("torch", "jax")):
            f = _fetcher(fetcher_pkg, planes[server_pkg][2].port)
            try:
                with pytest.raises(Exception) as exc:
                    f.fetch("p", "t", 0)
                assert "busy" in str(exc.value) or "503" in str(exc.value)
            finally:
                f.close()
    finally:
        for _st, _up, srv in planes.values():
            srv.stop()


def test_long_poll_clamp_equals_the_reference_constant():
    from dragonfly2_tpu.records import abi_contracts
    from dragonfly2_tpu.rpc import piece_transport as j_pt
    from dragonfly2_tpu_torch.rpc import piece_transport as t_pt

    assert t_pt.LONG_POLL_MAX_MS == j_pt.LONG_POLL_MAX_MS \
        == abi_contracts.constant("kLongPollMaxMs")
