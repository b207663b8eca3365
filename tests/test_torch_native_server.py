"""Port parity: the port's in-engine C++ HTTP piece server
(``dragonfly2_tpu_torch/native``'s ``ps_serve`` behind
``rpc.piece_transport.NativePieceServer``) against the reference's wire.

The cases of ``tests/test_native_server.py`` on the port's own native
library, which the port builds from its own ``native.cpp`` on first use
(no skip: the library must build here).  Pieces are fetched with the
port's ``HTTPPieceFetcher`` and with the JAX package's, so either
package's client reads the port's server; the factory's choice and the
serving cap are the reference's.
"""

import urllib.error
import urllib.request

import pytest

from dragonfly2_tpu.rpc.piece_transport import HTTPPieceFetcher as JHTTPPieceFetcher
from dragonfly2_tpu_torch import native
from dragonfly2_tpu_torch.daemon import DaemonStorage, UploadManager
from dragonfly2_tpu_torch.rpc.piece_transport import (
    HTTPPieceFetcher,
    NativePieceServer,
    PieceHTTPServer,
    make_piece_server,
)

PIECE = 64 * 1024


@pytest.fixture()
def served(tmp_path):
    storage = DaemonStorage(str(tmp_path / "store"), prefer_native=True)
    assert storage.is_native
    upload = UploadManager(storage)
    task = "t" * 16
    storage.register_task(task, piece_size=PIECE, content_length=4 * PIECE - 100)
    pieces = []
    for n in range(4):
        size = PIECE if n < 3 else PIECE - 100
        data = bytes((n * 17 + i) % 256 for i in range(size))
        pieces.append(data)
        storage.write_piece(task, n, data)
    server = NativePieceServer(upload)
    yield {"server": server, "task": task, "pieces": pieces, "storage": storage}
    server.stop()
    storage.close()
    # A wedged shutdown used to be a stderr print nobody read; now it is
    # a process-global counter (ps_leak_stats) this teardown turns into
    # a hard failure.
    assert native.leaked_servers() == (0, 0)


class TestNativePieceServer:
    @pytest.mark.parametrize("client", [HTTPPieceFetcher, JHTTPPieceFetcher],
                             ids=["torch", "jax"])
    def test_piece_fetch_via_production_fetcher(self, served, client):
        fetcher = client(
            lambda hid: ("127.0.0.1", served["server"].port)
        )
        for n, want in enumerate(served["pieces"]):
            assert fetcher.fetch("h", served["task"], n) == want

    def test_bitmap(self, served):
        fetcher = HTTPPieceFetcher(
            lambda hid: ("127.0.0.1", served["server"].port)
        )
        bm = fetcher.piece_bitmap("h", served["task"])
        assert bytes(bm) == b"\x01\x01\x01\x01"

    def test_range_request(self, served):
        port = served["server"].port
        blob = b"".join(served["pieces"])
        for rng, want in [
            ("bytes=0-99", blob[:100]),
            (f"bytes={PIECE - 10}-{PIECE + 9}", blob[PIECE - 10: PIECE + 10]),
            ("bytes=-50", blob[-50:]),
            (f"bytes={len(blob) - 20}-", blob[-20:]),
        ]:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/tasks/{served['task']}",
                headers={"Range": rng},
            )
            with urllib.request.urlopen(req, timeout=5) as resp:
                assert resp.status == 206
                assert resp.read() == want, rng

    def test_missing_piece_404(self, served):
        port = served["server"].port
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/pieces/{served['task']}/9", timeout=5
            )
        assert exc.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/pieces/ghost/0", timeout=5
            )
        assert exc.value.code == 404

    def test_bitmap_long_poll(self, served):
        """?have=N&wait_ms=M defers the bitmap until a new piece commits
        (Python-server wire parity; synchronizer subscription)."""
        import threading
        import time

        port = served["server"].port
        task = served["task"]
        held = len(served["pieces"])

        # All pieces held already → the window elapses, bitmap returned.
        t0 = time.monotonic()
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/tasks/{task}/pieces?have={held}&wait_ms=300",
            timeout=5,
        ) as resp:
            bm = resp.read()
        assert time.monotonic() - t0 >= 0.25
        assert sum(bm) == held

        # A piece landing mid-window releases the poll promptly.
        storage = served["storage"]
        t2 = "u" * 16
        storage.register_task(t2, piece_size=PIECE, content_length=2 * PIECE)

        def commit_late():
            time.sleep(0.1)
            storage.write_piece(t2, 0, b"q" * PIECE)

        threading.Thread(target=commit_late).start()
        t0 = time.monotonic()
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/tasks/{t2}/pieces?have=0&wait_ms=5000",
            timeout=10,
        ) as resp:
            bm = resp.read()
        assert time.monotonic() - t0 < 2.0
        assert list(bm) == [1, 0]

    def test_path_traversal_rejected(self, served):
        """Network-supplied task components must stay inside the store
        root (ADVICE r2: GET /pieces/../N reached <root>/../meta).  Raw
        socket — urllib would normalize the dot segments away."""
        import socket

        port = served["server"].port
        for path, codes in (
            ("/pieces/../0", (b"404",)),
            ("/pieces/./0", (b"404",)),
            ("/tasks/../pieces", (b"404",)),
            # Rangeless /tasks/<id> 416s for unknown ids (parity with the
            # Python server); the invariant is "never 200, never opens
            # outside the root".
            ("/tasks/..", (b"404", b"416")),
            ("/tasks/.", (b"404", b"416")),
        ):
            sock = socket.create_connection(("127.0.0.1", port), timeout=5)
            sock.sendall(
                f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                f"Connection: close\r\n\r\n".encode()
            )
            status = sock.makefile("rb").readline()
            assert any(c in status for c in codes), (path, status)
            sock.close()

    def test_bad_range_416(self, served):
        port = served["server"].port
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/tasks/{served['task']}",
            headers={"Range": "bytes=zz-5"},
        )
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=5)
        assert exc.value.code == 416

    def test_keep_alive_multiple_requests_one_connection(self, served):
        import socket

        port = served["server"].port
        sock = socket.create_connection(("127.0.0.1", port), timeout=5)
        f = sock.makefile("rb")
        for n in (0, 1, 2):
            sock.sendall(
                f"GET /pieces/{served['task']}/{n} HTTP/1.1\r\n"
                f"Host: x\r\n\r\n".encode()
            )
            status = f.readline()
            assert b"200" in status
            cl = 0
            while True:
                line = f.readline()
                if line == b"\r\n":
                    break
                if line.lower().startswith(b"content-length:"):
                    cl = int(line.split(b":")[1])
            body = f.read(cl)
            assert body == served["pieces"][n]
        sock.close()


class TestFactory:
    def test_native_selected_for_native_store(self, tmp_path):
        storage = DaemonStorage(str(tmp_path / "n"), prefer_native=True)
        srv = make_piece_server(UploadManager(storage))
        try:
            assert isinstance(srv, NativePieceServer)
        finally:
            srv.stop()

    def test_python_for_python_store_or_tls(self, tmp_path):
        storage = DaemonStorage(str(tmp_path / "p"), prefer_native=False)
        srv = make_piece_server(UploadManager(storage))
        assert isinstance(srv, PieceHTTPServer)
        # TLS → Python server even on a native store (native speaks
        # plain HTTP only).
        import ssl

        ctx = ssl.create_default_context(ssl.Purpose.CLIENT_AUTH)
        nstorage = DaemonStorage(str(tmp_path / "n2"), prefer_native=True)
        srv2 = make_piece_server(UploadManager(nstorage), ssl_context=ctx)
        assert isinstance(srv2, PieceHTTPServer)

    def test_bitmap_requests_exempt_from_serving_cap(self, tmp_path):
        """Long-poll subscriptions parked on a busy seed must not consume
        its piece-serving 503 slots (the data-plane cap)."""
        import threading
        import urllib.request

        storage = DaemonStorage(str(tmp_path / "cap"), prefer_native=True)
        task = "c" * 16
        storage.register_task(task, piece_size=PIECE, content_length=4 * PIECE)
        for n in range(2):
            storage.write_piece(task, n, bytes(PIECE))
        upload = UploadManager(storage)
        server = NativePieceServer(upload, concurrent_limit=2)
        try:
            port = server.port
            # Park MORE long-polls than the cap (have=4 never satisfied).
            def park():
                try:
                    urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/tasks/{task}/pieces"
                        f"?have=4&wait_ms=3000", timeout=10,
                    ).read()
                except OSError:
                    pass  # server shutdown cuts parked polls — expected

            parked = []
            for _ in range(4):
                t = threading.Thread(target=park, daemon=True)
                t.start()
                parked.append(t)
            import time

            time.sleep(0.3)  # all four are parked now
            # Piece serving still has its full budget.
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/pieces/{task}/0", timeout=5
            ) as r:
                assert r.status == 200
        finally:
            server.stop()
            storage.close()
