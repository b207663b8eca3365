"""Port parity: the AF_VSOCK transport, ``dragonfly2_tpu_torch/rpc/vsock.py``
(pkg/rpc/vsock.go): the 3 cases of ``tests/test_vsock.py``; address
parsing always, the live listener and dial path when the host supports
vsock loopback (skipped otherwise, as the reference's are).
"""

import pytest

from dragonfly2_tpu_torch.rpc.vsock import (
    VMADDR_CID_ANY,
    VMADDR_CID_LOCAL,
    VsockHTTPConnection,
    VsockService,
    parse_vsock_addr,
    vsock_available,
)


class TestAddressing:
    def test_parse(self):
        assert parse_vsock_addr("vsock://2:65010") == (2, 65010)
        assert parse_vsock_addr("vsock://4294967295:0") == (4294967295, 0)
        assert parse_vsock_addr("vsock://2:100000") == (2, 100000)  # u32 ports
        for bad in ("tcp://1:2", "vsock://", "vsock://x:1", "http://h"):
            with pytest.raises(ValueError):
                parse_vsock_addr(bad)


def _loopback_works() -> bool:
    if not vsock_available():
        return False
    import socket

    try:
        s = socket.socket(socket.AF_VSOCK, socket.SOCK_STREAM)
        s.bind((VMADDR_CID_LOCAL, 0))
        s.close()
        return True
    except OSError:
        return False


class TestLiveVsock:
    def test_http_over_vsock_loopback(self):
        if not _loopback_works():
            pytest.skip("no vsock loopback on this host")
        from http.server import BaseHTTPRequestHandler

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                body = b'{"ok": true}'
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        svc = VsockService(H, 0, cid=VMADDR_CID_LOCAL)
        svc.serve()
        try:
            status, body = VsockHTTPConnection(
                VMADDR_CID_LOCAL, svc.port
            ).call("GET", "/healthy")
            assert status == 200 and b'"ok": true' in body
        finally:
            svc.stop()

    def test_bind_any_when_available(self):
        # Guard with a TRIAL BIND: socket() succeeding does not guarantee
        # bind() does (module loaded, no transport registered).
        import socket

        if not vsock_available():
            pytest.skip("AF_VSOCK unavailable")
        try:
            probe = socket.socket(socket.AF_VSOCK, socket.SOCK_STREAM)
            probe.bind((VMADDR_CID_ANY, 0xFFFFFFFF))
            probe.close()
        except OSError:
            pytest.skip("AF_VSOCK bind unsupported on this host")
        from http.server import BaseHTTPRequestHandler

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

        svc = VsockService(H, 0, cid=VMADDR_CID_ANY)
        svc.serve()
        assert svc.port > 0
        svc.stop()
