"""Port parity: the SNI-hijack proxy, ``dragonfly2_tpu_torch/daemon/sni.py``.

The 7 cases of ``tests/test_sni.py`` on the port, with the reference's
inputs and assertions (the module skips as the reference's does when
``cryptography`` is absent); the port's repair (``SNIProxy.stop`` leaves
no accept thread behind); and the two packages' ``parse_client_hello_sni``
equal on real ``ssl`` ClientHellos and on 200 seeded mutations of them.
"""

import socket
import ssl
import threading
import time

import pytest

pytest.importorskip(
    "cryptography", reason="SNI interception needs the gated CA surface"
)

from dragonfly2_tpu_torch.daemon.sni import SNIProxy, parse_client_hello_sni
from dragonfly2_tpu_torch.security.ca import CertificateAuthority, PeerIdentity
from dragonfly2_tpu_torch.utils import idgen

from test_torch_daemon import PIECE, _Swarm


def _capture_client_hello(server_hostname: str) -> bytes:
    """Record the raw bytes the ssl module actually sends for an SNI."""
    listener = socket.create_server(("127.0.0.1", 0))
    captured = {}

    def server():
        conn, _ = listener.accept()
        captured["hello"] = conn.recv(16384)
        conn.close()

    t = threading.Thread(target=server, daemon=True)
    t.start()
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = True
    try:
        with socket.create_connection(listener.getsockname()) as raw:
            with ctx.wrap_socket(raw, server_hostname=server_hostname):
                pass
    except (ssl.SSLError, OSError):
        pass  # handshake can't complete; we only want the ClientHello
    t.join(timeout=5)
    listener.close()
    return captured["hello"]


class TestClientHelloParser:
    def test_parses_real_ssl_module_hello(self):
        hello = _capture_client_hello("origin.internal.example")
        assert parse_client_hello_sni(hello) == "origin.internal.example"

    def test_garbage_and_short_input(self):
        assert parse_client_hello_sni(b"") is None
        assert parse_client_hello_sni(b"GET / HTTP/1.1\r\n") is None
        assert parse_client_hello_sni(b"\x16\x03\x01\x00\x05ab") is None

    def test_hello_without_sni(self):
        hello = _capture_client_hello("no-sni.example")
        # Strip the server_name extension bytes wholesale → parser must
        # return None, not crash.
        idx = hello.find(b"no-sni.example")
        assert idx > 0
        broken = hello[: idx - 9]  # truncate inside the extension block
        assert parse_client_hello_sni(broken) is None


class TestCAPersistence:
    def test_persistent_ca_survives_restart(self, tmp_path):
        d = str(tmp_path / "ca")
        ca1 = CertificateAuthority.persistent(d)
        ca2 = CertificateAuthority.persistent(d)
        assert ca1.cert_pem == ca2.cert_pem
        # The reloaded CA can still issue working identities.
        identity = PeerIdentity.issue(ca2, common_name="x", hostnames=["x"])
        assert b"BEGIN CERTIFICATE" in identity.cert_pem

    def test_slow_client_hello_times_out_not_spins(self):
        import time as _time

        from dragonfly2_tpu_torch.daemon.sni import _peek_client_hello

        listener = socket.create_server(("127.0.0.1", 0))
        client = socket.create_connection(listener.getsockname())
        conn, _ = listener.accept()
        client.sendall(b"\x16\x03\x01")  # 3 bytes of a record, then stall
        t0 = _time.monotonic()
        data = _peek_client_hello(conn, timeout=0.5)
        elapsed = _time.monotonic() - t0
        assert data == b"\x16\x03\x01"
        assert 0.3 < elapsed < 5.0  # returned at the deadline, no hang
        client.close()
        conn.close()
        listener.close()


def _client_ctx(ca: CertificateAuthority) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cadata=ca.cert_pem.decode())
    return ctx


class TestSNIHijack:
    def test_hijacked_host_served_from_p2p(self, tmp_path):
        swarm = _Swarm(tmp_path, n_hosts=2)
        swarm.origin.content_length = lambda u: 3 * PIECE
        ca = CertificateAuthority()
        proxy = SNIProxy(
            swarm.daemons[0], ca=ca, hijack=[r"\.hijack\.test$"],
            piece_size=PIECE,
        )
        proxy.serve()
        try:
            ctx = _client_ctx(ca)
            with socket.create_connection(("127.0.0.1", proxy.port)) as raw:
                with ctx.wrap_socket(
                    raw, server_hostname="origin.hijack.test"
                ) as tls:
                    # The leaf cert was minted on the fly for this SNI and
                    # chains to the daemon CA (check_hostname verified it).
                    tls.sendall(
                        b"GET /blob-sni HTTP/1.1\r\n"
                        b"Host: origin.hijack.test\r\n\r\n"
                    )
                    resp = b""
                    while True:
                        chunk = tls.recv(65536)
                        if not chunk:
                            break
                        resp += chunk
            head, _, body = resp.partition(b"\r\n\r\n")
            assert head.startswith(b"HTTP/1.1 200")
            expected = b"".join(
                swarm.origin.content("https://origin.hijack.test/blob-sni", n)
                for n in range(3)
            )
            assert body == expected
            assert proxy.stats["hijacked"] == 1
            # The bytes came through the P2P engine, not a direct fetch.
            tid = idgen.task_id("https://origin.hijack.test/blob-sni")
            assert swarm.daemons[0].storage.engine.piece_count(tid) == 3
        finally:
            proxy.stop()

    def test_unmatched_host_relayed_to_origin(self, tmp_path):
        swarm = _Swarm(tmp_path, n_hosts=1)
        ca = CertificateAuthority()
        # Real TLS upstream for "localhost", its own CA-issued identity.
        upstream_id = PeerIdentity.issue(
            ca, common_name="localhost", hostnames=["localhost"]
        )
        upstream_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            paths = upstream_id.write(d)
            upstream_ctx.load_cert_chain(paths["cert"], paths["key"])
        listener = socket.create_server(("127.0.0.1", 0))

        def upstream():
            conn, _ = listener.accept()
            with upstream_ctx.wrap_socket(conn, server_side=True) as tls:
                data = tls.recv(1024)
                tls.sendall(b"echo:" + data)

        t = threading.Thread(target=upstream, daemon=True)
        t.start()

        proxy = SNIProxy(
            swarm.daemons[0], ca=ca, hijack=[r"\.hijack\.test$"],
            relay_port=listener.getsockname()[1],
        )
        proxy.serve()
        try:
            ctx = _client_ctx(ca)
            with socket.create_connection(("127.0.0.1", proxy.port)) as raw:
                with ctx.wrap_socket(raw, server_hostname="localhost") as tls:
                    tls.sendall(b"ping")
                    assert tls.recv(1024) == b"echo:ping"
            assert proxy.stats["relayed"] == 1
            assert proxy.stats["hijacked"] == 0
        finally:
            proxy.stop()
            listener.close()
        t.join(timeout=5)


def test_stop_leaves_no_accept_thread(tmp_path):
    """The port's repair: the reference's ``stop`` closes the listener
    while its accept thread sleeps in ``accept()``, which a close does not
    wake; the port's shuts it down and joins the thread."""
    swarm = _Swarm(tmp_path, n_hosts=1)
    proxy = SNIProxy(swarm.daemons[0], ca=CertificateAuthority(), hijack=[r"x"])
    proxy.serve()
    thread = proxy._thread
    # One connection first, as a serving proxy has had: its handler
    # rejects the empty hello.
    socket.create_connection(("127.0.0.1", proxy.port)).close()
    deadline = time.monotonic() + 5
    while proxy.stats["rejected"] == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert thread.is_alive() and proxy.stats["rejected"] == 1
    proxy.stop()
    thread.join(timeout=5)
    assert not thread.is_alive()


def _hellos():
    return [_capture_client_hello(h) for h in (
        "origin.internal.example", "registry.secure.test", "a.b",
        "x" * 60 + ".example", "xn--bcher-kva.example")]


def test_parse_client_hello_sni_equal_across_packages():
    """Both packages read the same SNI (or None) from real hellos and from
    200 seeded mutations of them: truncations, flipped bytes and
    overwritten length fields."""
    import numpy as np

    from dragonfly2_tpu.daemon.sni import parse_client_hello_sni as jparse

    hellos = _hellos()
    for hello in hellos:
        assert parse_client_hello_sni(hello) == jparse(hello) is not None
    rng = np.random.default_rng(0)
    for _ in range(200):
        hello = bytearray(hellos[int(rng.integers(len(hellos)))])
        kind = int(rng.integers(3))
        if kind == 0:
            hello = hello[: int(rng.integers(len(hello)))]
        elif kind == 1:
            for at in rng.integers(0, len(hello), size=int(rng.integers(1, 8))):
                hello[int(at)] ^= int(rng.integers(1, 256))
        else:
            at = int(rng.integers(0, len(hello) - 2))
            hello[at:at + 2] = int(rng.integers(0, 1 << 16)).to_bytes(2, "big")
        assert parse_client_hello_sni(bytes(hello)) == jparse(bytes(hello))


def test_slow_reader_gets_the_whole_hijacked_body(tmp_path):
    """The port's second repair: the reference sends the hijacked body
    under the handshake timeout, and ``sendall``'s timeout bounds the whole
    send, so a client that drains the body for longer than it gets a cut
    body.  The port sends it under the idle timeout."""
    swarm = _Swarm(tmp_path, n_hosts=1)
    ca = CertificateAuthority()
    body = bytes(range(256)) * (24 << 12)  # 24 MiB: more than the socket buffers
    proxy = SNIProxy(swarm.daemons[0], ca=ca, hijack=[r"\.hijack\.test$"],
                     handshake_timeout=0.5)
    proxy._fetch_p2p = lambda url: body
    proxy.serve()
    try:
        ctx = _client_ctx(ca)
        with socket.create_connection(("127.0.0.1", proxy.port)) as raw:
            with ctx.wrap_socket(raw, server_hostname="slow.hijack.test") as tls:
                tls.sendall(b"GET /big HTTP/1.1\r\nHost: slow.hijack.test\r\n\r\n")
                resp = bytearray()
                t0 = time.monotonic()
                while True:
                    chunk = tls.recv(1 << 16)
                    if not chunk:
                        break
                    resp += chunk
                    if time.monotonic() - t0 < 1.5:
                        time.sleep(0.005)  # drain slowly past the handshake timeout
        head, _, got = bytes(resp).partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 200")
        assert len(got) == len(body) and got == body
        assert proxy.stats["hijacked"] == 1 and proxy.stats["rejected"] == 0
    finally:
        proxy.stop()
