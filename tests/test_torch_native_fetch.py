"""Port parity: the port's in-engine client fetch loop
(``Conductor._native_fetch_window`` over ``native.pf_*``, built from the
port's own ``native.cpp``), the cases of ``tests/test_native_fetch.py``.

The fallback matrix proved byte-identical (native store and fetch loop,
native store with the Python arm, the Python store — every piece, every
Range shape, and the corrupt-body refusal), with the library present and
force-absent; each dispatch gate of the reference's routing matrix (the
knob, a Python store, TLS, an attached tee consumer, a piece-plane fault
scenario, the dispatch seam raising); and the SIGKILL between a C++
commit and its Python bookkeeping (``tests/_torch_native_kill_child.py``),
whose store a fresh conductor resumes.  The reference's bench smoke
(``tools/bench_download.py``) is not ported.  No case skips: the port's
library must build here.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from dragonfly2_tpu_torch import native  # noqa: E402
from dragonfly2_tpu_torch.daemon import DaemonStorage, UploadManager  # noqa: E402
from dragonfly2_tpu_torch.daemon.conductor import Conductor  # noqa: E402
from dragonfly2_tpu_torch.records.storage import Storage  # noqa: E402
from dragonfly2_tpu_torch.rpc import HTTPPieceFetcher, RemoteScheduler  # noqa: E402
from dragonfly2_tpu_torch.rpc.piece_transport import PieceHTTPServer  # noqa: E402
from dragonfly2_tpu_torch.rpc.scheduler_server import SchedulerHTTPServer  # noqa: E402
from dragonfly2_tpu_torch.scheduler import (  # noqa: E402
    Evaluator,
    NetworkTopology,
    Resource,
    SchedulerService,
    Scheduling,
    SchedulingConfig,
)
from dragonfly2_tpu_torch.scheduler.resource import Host  # noqa: E402
from dragonfly2_tpu_torch.utils import faultinject  # noqa: E402
from dragonfly2_tpu_torch.utils.faultinject import (  # noqa: E402
    FaultInjector,
    FaultSpec,
    installed,
)

PIECE = 64 * 1024
N_PIECES = 6


def _origin_pieces(seed: int, n: int = N_PIECES, piece: int = PIECE):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, 256, piece, dtype=np.uint8).tobytes()
        for _ in range(n)
    ]


class _Origin:
    """An origin that answers each piece after ``LATENCY_S``, as a remote
    one does.  A parent reports its origin times as its piece costs, and
    the scheduler's bad-node rule drops a parent whose last cost is over
    20 times the mean of the others: answered in microseconds, a stall of
    a few ms on a loaded machine made the warm parent a bad node and sent
    a child with no source client back to source."""

    LATENCY_S = 0.02

    def __init__(self, pieces):
        self.pieces = pieces

    def fetch(self, url, number, piece_size):
        time.sleep(self.LATENCY_S)
        return self.pieces[number]


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """One scheduler + one warm plain-HTTP wire parent holding every
    piece of the sweep task — the swarm every arm downloads from."""
    tmp = tmp_path_factory.mktemp("native-fetch-plane")
    pieces = _origin_pieces(11)
    url = "https://origin/native-fetch-sweep"
    content_length = N_PIECES * PIECE

    resource = Resource()
    service = SchedulerService(
        resource,
        Scheduling(Evaluator(), SchedulingConfig(retry_interval=0)),
        Storage(str(tmp / "records"), buffer_size=8),
        NetworkTopology(resource.host_manager),
    )
    server = SchedulerHTTPServer(service)
    server.serve()

    pstore = DaemonStorage(str(tmp / "parent"), prefer_native=False)
    piece_server = PieceHTTPServer(UploadManager(pstore))
    piece_server.serve()
    phost = Host(
        id="nf-parent", hostname="nf-parent", ip="127.0.0.1",
        port=8002, download_port=piece_server.port,
    )
    phost.stats.network.idc = "idc-a"
    pclient = RemoteScheduler(server.url, timeout=5.0)
    parent = Conductor(
        phost, pstore, pclient,
        piece_fetcher=HTTPPieceFetcher(pclient.resolve_host),
        source_fetcher=_Origin(pieces),
    )
    warm = parent.download(
        url, piece_size=PIECE, content_length=content_length
    )
    assert warm.ok and warm.pieces == N_PIECES
    cleanup = []
    yield {
        "tmp": tmp,
        "scheduler": server,
        "url": url,
        "pieces": pieces,
        "content_length": content_length,
        "pclient": pclient,
        "service": service,
        "cleanup": cleanup,
    }
    for child_server, child_storage in cleanup:
        child_server.stop()
        child_storage.close()
    piece_server.stop()
    server.stop()
    assert native.leaked_servers() == (0, 0)


def _child_download(
    plane, store_dir, name, *, native_fetch, prefer_native=True,
    tenant="", piece_parallelism=4,
):
    """One wire child over the plane's swarm.  The child serves its own
    store for real (completed peers become parent candidates for later
    children — a dead advertised port would poison the pool); the plane
    fixture owns server/storage shutdown."""
    storage = DaemonStorage(str(store_dir), prefer_native=prefer_native)
    child_server = PieceHTTPServer(UploadManager(storage))
    child_server.serve()
    plane["cleanup"].append((child_server, storage))
    client = RemoteScheduler(plane["scheduler"].url, timeout=5.0)
    host = Host(
        id=name, hostname=name, ip="127.0.0.1", port=8002,
        download_port=child_server.port,
    )
    host.stats.network.idc = "idc-a"
    conductor = Conductor(
        host, storage, client,
        piece_fetcher=HTTPPieceFetcher(client.resolve_host, tenant=tenant),
        source_fetcher=None,
        native_fetch=native_fetch,
        piece_parallelism=piece_parallelism,
    )
    r = conductor.download(
        plane["url"], piece_size=PIECE,
        content_length=plane["content_length"],
    )
    return storage, r


RANGE_SHAPES = [
    "bytes=0-{last}",            # whole object
    "bytes=0-99",                # head
    "bytes={cross_lo}-{cross_hi}",  # straddles a piece boundary
    "bytes={tail}-",             # open end
    "bytes=-100",                # suffix
    "bytes={mid}-{mid}",         # single byte
]


def _range_cases(total):
    return [
        s.format(
            last=total - 1,
            cross_lo=PIECE - 50,
            cross_hi=PIECE + 49,
            tail=total - 100,
            mid=2 * PIECE + 7,
        )
        for s in RANGE_SHAPES
    ]


def _range_get(port, task, rng_header):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/tasks/{task}",
        headers={"Range": rng_header},
    )
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.status, resp.read()


class TestFallbackMatrixByteIdentity:
    """native-both vs native-server-only vs pure-Python over the SAME
    seeded swarm: identical task bytes, identical pieces, identical
    Range bodies — with the native library present AND force-absent."""

    @pytest.mark.parametrize("lib_present", [True, False])
    def test_arms_byte_identical(self, plane, tmp_path, monkeypatch,
                                 lib_present):
        if not lib_present:
            monkeypatch.setattr(native, "available", lambda: False)
        blob = b"".join(plane["pieces"])
        arms = {
            "nativeboth": dict(native_fetch=True, prefer_native=True),
            "nativeserver": dict(native_fetch=False, prefer_native=True),
            "python": dict(native_fetch=False, prefer_native=False),
        }
        stores = {}
        try:
            for arm, kw in arms.items():
                storage, r = _child_download(
                    plane, tmp_path / f"{arm}-{lib_present}",
                    f"nf-{arm}-{int(lib_present)}", **kw,
                )
                assert r.ok and r.pieces == N_PIECES, (arm, r)
                assert storage.is_native == (lib_present and kw["prefer_native"]), arm
                stores[arm] = (storage, r.task_id)
                # Whole task AND every piece, against the origin bytes.
                assert storage.read_task_bytes(r.task_id) == blob, arm
                for n, want in enumerate(plane["pieces"]):
                    assert storage.read_piece(r.task_id, n) == want, (arm, n)

            # Every Range shape, served straight off each arm's store
            # through the piece transport, must agree byte-for-byte.
            servers = {
                arm: PieceHTTPServer(UploadManager(st))
                for arm, (st, _) in stores.items()
            }
            try:
                for srv in servers.values():
                    srv.serve()
                for case in _range_cases(len(blob)):
                    bodies = {}
                    for arm, srv in servers.items():
                        code, body = _range_get(
                            srv.port, stores[arm][1], case
                        )
                        assert code == 206, (arm, case)
                        bodies[arm] = body
                    assert len(set(bodies.values())) == 1, (case, bodies)
            finally:
                for srv in servers.values():
                    srv.stop()
        finally:
            pass  # plane cleanup owns the child stores/servers


class _CorruptHandler(BaseHTTPRequestHandler):
    """A parent that advertises every piece but serves WRONG-LENGTH
    bodies — valid HTTP framing, corrupt payload."""

    protocol_version = "HTTP/1.1"
    n_pieces = N_PIECES

    def do_GET(self):
        if "/pieces/" in self.path:
            body = b"\x5a" * (PIECE // 2)  # half-length garbage
        elif self.path.rstrip("/").endswith("/pieces"):
            body = b"\x01" * self.n_pieces  # "I hold everything"
        else:
            body = b""
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # noqa: D102 — keep pytest output clean
        pass


class TestCorruptBodyRefusal:
    """A body that fails the expected-length check is refused by BOTH
    arms: nothing commits, the download does not complete corrupt."""

    @pytest.mark.parametrize("native_fetch", [True, False])
    def test_same_refusal_both_arms(self, plane, tmp_path, native_fetch):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _CorruptHandler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = "https://origin/native-fetch-corrupt"
        pieces = _origin_pieces(13)
        tmp = plane["tmp"]
        try:
            # An honest conductor seeds the task on the scheduler, but
            # its ANNOUNCED download port is the corrupt server: every
            # child fetch lands there.
            chost = Host(
                id=f"nf-corrupt-parent-{int(native_fetch)}",
                hostname=f"nf-corrupt-parent-{int(native_fetch)}",
                ip="127.0.0.1", port=8002,
                download_port=httpd.server_address[1],
            )
            chost.stats.network.idc = "idc-a"
            cclient = RemoteScheduler(plane["scheduler"].url, timeout=5.0)
            seeder_store = DaemonStorage(
                str(tmp / f"corrupt-seed-{int(native_fetch)}"),
                prefer_native=False,
            )
            seeder = Conductor(
                chost, seeder_store, cclient,
                piece_fetcher=HTTPPieceFetcher(cclient.resolve_host),
                source_fetcher=_Origin(pieces),
            )
            warm = seeder.download(
                url, piece_size=PIECE, content_length=N_PIECES * PIECE
            )
            assert warm.ok

            storage = DaemonStorage(
                str(tmp_path / "victim"), prefer_native=native_fetch
            )
            client = RemoteScheduler(plane["scheduler"].url, timeout=5.0)
            host = Host(
                id=f"nf-corrupt-child-{int(native_fetch)}",
                hostname=f"nf-corrupt-child-{int(native_fetch)}",
                ip="127.0.0.1", port=8002, download_port=1,
            )
            host.stats.network.idc = "idc-a"
            conductor = Conductor(
                host, storage, client,
                piece_fetcher=HTTPPieceFetcher(client.resolve_host),
                source_fetcher=None,
                native_fetch=native_fetch,
                piece_wait_timeout_s=2.0,
            )
            r = conductor.download(
                url, piece_size=PIECE, content_length=N_PIECES * PIECE
            )
            # Identical refusal: no corrupt byte ever commits.
            assert not r.ok
            assert storage.held_pieces(r.task_id) == 0
            storage.close()
        finally:
            httpd.shutdown()
            httpd.server_close()


class _FetcherSpy:
    """Wraps native.NativePieceFetcher, counting constructions — the
    witness that a gate routed the download to the Python arm."""

    def __init__(self):
        self.constructed = 0
        self._real = native.NativePieceFetcher

    def __call__(self, *a, **kw):
        self.constructed += 1
        return self._real(*a, **kw)


@pytest.fixture()
def fetcher_spy(monkeypatch):
    spy = _FetcherSpy()
    monkeypatch.setattr(native, "NativePieceFetcher", spy)
    return spy


class TestDispatchGates:
    def test_native_path_used_when_ungated(self, plane, tmp_path,
                                           fetcher_spy):
        storage, r = _child_download(
            plane, tmp_path / "s", "nf-gate-on", native_fetch=True
        )
        assert r.ok and fetcher_spy.constructed == 1

    def test_knob_off_routes_python(self, plane, tmp_path, fetcher_spy):
        storage, r = _child_download(
            plane, tmp_path / "s", "nf-gate-knob", native_fetch=False
        )
        assert r.ok and fetcher_spy.constructed == 0

    def test_python_store_routes_python(self, plane, tmp_path, fetcher_spy):
        storage, r = _child_download(
            plane, tmp_path / "s", "nf-gate-pystore",
            native_fetch=True, prefer_native=False,
        )
        assert r.ok and fetcher_spy.constructed == 0

    def test_tls_endpoint_is_not_native_dialable(self):
        import ssl

        ctx = ssl.create_default_context()
        fetcher = HTTPPieceFetcher(
            lambda hid: ("127.0.0.1", 1), ssl_context=ctx
        )
        assert fetcher.native_endpoint("h") is None
        plain = HTTPPieceFetcher(lambda hid: ("127.0.0.1", 7))
        assert plain.native_endpoint("h") == ("127.0.0.1", 7)

    def test_piece_fault_scenario_routes_python_and_bites(
        self, plane, tmp_path, fetcher_spy
    ):
        inj = FaultInjector(
            [FaultSpec(site="piece.fetch", kind="delay", every=3,
                       delay_s=0.01)]
        )
        with installed(inj):
            storage, r = _child_download(
                plane, tmp_path / "s", "nf-gate-fault", native_fetch=True
            )
        assert r.ok and fetcher_spy.constructed == 0
        # The scenario actually bit on the Python arm — the gate did not
        # just bypass the native path, it preserved fault semantics.
        assert any(i.site == "piece.fetch" for i in inj.history)

    def test_dispatch_seam_raise_routes_python(self, plane, tmp_path,
                                               fetcher_spy):
        inj = FaultInjector(
            [FaultSpec(site="daemon.piece.native_fetch", kind="dferror",
                       every=1)]
        )
        with installed(inj):
            storage, r = _child_download(
                plane, tmp_path / "s", "nf-gate-seam", native_fetch=True
            )
        assert r.ok and fetcher_spy.constructed == 0
        assert any(
            i.site == "daemon.piece.native_fetch" for i in inj.history
        )
        assert storage.read_task_bytes(r.task_id) == b"".join(
            plane["pieces"]
        )

    def test_tee_consumer_routes_python(self, plane, tmp_path, fetcher_spy):
        storage = DaemonStorage(str(tmp_path / "s"), prefer_native=True)
        client = RemoteScheduler(plane["scheduler"].url, timeout=5.0)
        host = Host(
            id="nf-gate-tee", hostname="nf-gate-tee", ip="127.0.0.1",
            port=8002, download_port=1,
        )
        host.stats.network.idc = "idc-a"
        conductor = Conductor(
            host, storage, client,
            piece_fetcher=HTTPPieceFetcher(client.resolve_host),
            source_fetcher=None,
            native_fetch=True,
        )
        handle = conductor.open_stream(
            plane["url"], piece_size=PIECE,
            content_length=plane["content_length"],
        )
        got = b"".join(handle.chunks())
        assert got == b"".join(plane["pieces"])
        assert fetcher_spy.constructed == 0
        storage.close()


class TestSigkillMidNativeFetch:
    def test_kill_between_commit_and_bookkeeping_resumes(self, tmp_path):
        """The crash seam lands a SIGKILL on the first drained native
        completion — after its C++ commit, before any Python
        bookkeeping, with engine workers still in flight.  The durable
        plane must come back partial-but-clean: a fresh conductor over
        the same store completes and digest-checks."""
        n_pieces = 12
        content_length = n_pieces * PIECE
        url = "https://origin/native-kill-blob"
        pieces = _origin_pieces(5, n=n_pieces)

        resource = Resource()
        service = SchedulerService(
            resource,
            Scheduling(Evaluator(), SchedulingConfig(retry_interval=0)),
            Storage(str(tmp_path / "records"), buffer_size=8),
            NetworkTopology(resource.host_manager),
        )
        server = SchedulerHTTPServer(service)
        server.serve()
        pstore = DaemonStorage(str(tmp_path / "parent"), prefer_native=False)
        piece_server = PieceHTTPServer(UploadManager(pstore))
        piece_server.serve()
        phost = Host(
            id="nk-parent", hostname="nk-parent", ip="127.0.0.1",
            port=8002, download_port=piece_server.port,
        )
        phost.stats.network.idc = "idc-a"
        pclient = RemoteScheduler(server.url, timeout=5.0)
        parent = Conductor(
            phost, pstore, pclient,
            piece_fetcher=HTTPPieceFetcher(pclient.resolve_host),
            source_fetcher=_Origin(pieces),
        )
        warm = parent.download(
            url, piece_size=PIECE, content_length=content_length
        )
        assert warm.ok and warm.pieces == n_pieces

        child_store = str(tmp_path / "childstore")
        scenario = {
            "seed": 0,
            "faults": [
                # Site index 0 is the dispatch fire; index 1 is the
                # FIRST drained completion record.
                FaultSpec(
                    site="daemon.piece.native_fetch", kind="crash", at=(1,)
                ).to_dict(),
            ],
        }
        try:
            proc = subprocess.Popen(
                [
                    sys.executable,
                    str(REPO / "tests" / "_torch_native_kill_child.py"),
                    server.url, child_store, url,
                    str(content_length), str(PIECE),
                ],
                env={
                    **os.environ,
                    "DF_FAULTINJECT": json.dumps(scenario),
                    "JAX_PLATFORMS": "cpu",
                    "DF_LOCK_WITNESS": "0",
                },
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                cwd=str(REPO),
            )
            try:
                out, err = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
                pytest.fail(f"child hung: {out!r} {err!r}")
            assert proc.returncode == -signal.SIGKILL, (
                proc.returncode, out, err,
            )
            assert b'"ok"' not in out, "child finished before the kill"

            storage2 = DaemonStorage(child_store, prefer_native=True)
            loaded = storage2.reload_persistent_tasks(
                storage2.scan_disk_tasks()
            )
            assert loaded, "no partial task survived the kill"
            held_before = storage2.held_pieces(loaded[0])
            assert 0 < held_before < n_pieces, (
                f"kill landed outside the native window "
                f"({held_before} pieces)"
            )
            client2 = RemoteScheduler(server.url, timeout=5.0)
            chost = Host(
                id="nk-child-2", hostname="nk-child-2",
                ip="127.0.0.1", port=8002, download_port=1,
            )
            chost.stats.network.idc = "idc-a"
            resumer = Conductor(
                chost, storage2, client2,
                piece_fetcher=HTTPPieceFetcher(
                    client2.resolve_host, timeout=5.0
                ),
                source_fetcher=None,
            )
            r = resumer.download(
                url, piece_size=PIECE, content_length=content_length
            )
            assert r.ok
            assert storage2.read_task_bytes(r.task_id) == b"".join(pieces)
            storage2.close()
        finally:
            piece_server.stop()
            server.stop()
            assert native.leaked_servers() == (0, 0)
