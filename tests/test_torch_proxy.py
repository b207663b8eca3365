"""Port parity: the daemon's forward proxy, ``dragonfly2_tpu_torch/daemon/
{proxy,relay}.py``, against ``dragonfly2_tpu/daemon/{proxy,relay}.py``.

Each package gets the same composition: a rule scheduler and two daemons
on the Python piece store (as the reference's tests build them), an
origin of deterministic pieces that answers after 20 ms, and a
``P2PProxy`` in front of daemon 1 whose rules divert
``https://origin/`` and rewrite ``http://registry.local/`` onto it.  A
local HTTP server is the direct origin and the CONNECT target.  The same
list of requests goes to both proxies over raw sockets: a full GET
(path-embedded and absolute-form), a Range, an unsatisfiable Range, a
malformed Range, the rewrite rule, an unmatched direct GET (whole and
ranged), a CONNECT, a CONNECT to a closed port, and a client that hangs
up mid-layer.  Both answer equal status codes, headers (but ``Date``)
and bytes, and end with equal ``stats``.  Then the port counterparts of
``tests/test_breadth.py``'s proxy tests (rules, P2P content, streaming
before the task finishes, the tunnel, the bad tunnel) and of
``tests/test_stream_tee.py:245`` (a disconnect releases the tee), and
the tunnel past 1,024 open descriptors, where the reference's relay
fails (its ``select.select``; the port waits on a selector).
"""

from __future__ import annotations

import hashlib
import http.client
import os
import socket
import time
import urllib.request
from http.server import BaseHTTPRequestHandler

import pytest

import dragonfly2_tpu.daemon.proxy as jproxy
import dragonfly2_tpu.daemon as jdaemon
import dragonfly2_tpu.scheduler as jsched
import dragonfly2_tpu.scheduler.resource as jres
import dragonfly2_tpu.utils.idgen as jidgen
import dragonfly2_tpu_torch.daemon.proxy as tproxy
import dragonfly2_tpu_torch.daemon as tdaemon
import dragonfly2_tpu_torch.scheduler as tsched
import dragonfly2_tpu_torch.scheduler.resource as tres
import dragonfly2_tpu_torch.utils.idgen as tidgen
from dragonfly2_tpu_torch.daemon.pex import GossipBus as TGossipBus
from dragonfly2_tpu_torch.rpc._server import ThreadedHTTPService
from dragonfly2_tpu.daemon.pex import GossipBus as JGossipBus

PIECE = 64 * 1024
N_PIECES = 4
ORIGIN_DELAY_S = 0.02
DIRECT_BODY = bytes(range(256)) * 40
PACKAGES = {
    "jax": (jproxy, jdaemon, jsched, jres, jidgen, JGossipBus),
    "port": (tproxy, tdaemon, tsched, tres, tidgen, TGossipBus),
}


class Origin:
    """Deterministic pieces, addressed by URL and number, answering after
    20 ms as a remote origin does."""

    def __init__(self, n_pieces=N_PIECES):
        self.n_pieces = n_pieces
        self.fetches = 0

    def content(self, url, number):
        seed = hashlib.sha256(f"{url}#{number}".encode()).digest()
        return (seed * (PIECE // len(seed) + 1))[:PIECE]

    def body(self, url):
        return b"".join(self.content(url, n) for n in range(self.n_pieces))

    def content_length(self, url):
        return self.n_pieces * PIECE

    def fetch(self, url, number, piece_size):
        time.sleep(ORIGIN_DELAY_S)
        self.fetches += 1
        return self.content(url, number)


class _Direct(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", str(len(DIRECT_BODY)))
        self.end_headers()
        self.wfile.write(DIRECT_BODY)


@pytest.fixture(scope="module")
def direct():
    srv = ThreadedHTTPService(_Direct, "127.0.0.1", 0, "direct-origin")
    srv.serve()
    yield srv
    srv.stop()


def _host(res, i):
    h = res.Host(id=f"host-{i}", hostname=f"host-{i}", ip=f"10.0.0.{i}", port=8002,
                 download_port=8001)
    h.stats.network.idc = "idc-a"
    return h


class Swarm:
    def __init__(self, pkg, tmp_path, n_hosts=2):
        proxy_mod, daemon_mod, sched, res, self.idgen, bus_cls = PACKAGES[pkg]
        self.proxy_mod = proxy_mod
        resource = sched.Resource()
        self.scheduler = sched.SchedulerService(
            resource, sched.Scheduling(sched.Evaluator(), sched.SchedulingConfig(retry_interval=0)),
            None, sched.NetworkTopology(resource.host_manager))
        self.origin = Origin()
        registry, bus = {}, bus_cls()
        self.daemons = []
        for i in range(n_hosts):
            host = _host(res, i)
            resource.store_host(host)
            self.daemons.append(daemon_mod.Daemon(
                host, self.scheduler, storage_root=str(tmp_path / f"{pkg}-d{i}"),
                daemon_registry=registry, gossip_bus=bus, source_fetcher=self.origin,
                prefer_native=False))

    def proxy(self, daemon=1, rules=None):
        m = self.proxy_mod
        rules = rules if rules is not None else [
            m.ProxyRule.compile(r"^https://origin/"),
            m.ProxyRule.compile(r"^http://registry\.local/", redirect="https://origin/"),
        ]
        p = m.P2PProxy(self.daemons[daemon], m.ProxyRouter(rules), piece_size=PIECE)
        p.serve()
        return p


def _request(port, raw: bytes, timeout=15.0):
    """Send ``raw`` and read the whole answer: (status line, headers but
    Date, body)."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall(raw)
        f = sock.makefile("rb")
        status = f.readline().decode().strip()
        headers = {}
        while True:
            line = f.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode().partition(":")
            if k.lower() != "date":
                headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", -1))
        body = f.read(n) if n >= 0 else f.read()
    return status, headers, body


def _get(path, headers=()):
    extra = "".join(f"{k}: {v}\r\n" for k, v in headers)
    return f"GET {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n{extra}\r\n".encode()


def _script(direct_port):
    """The request list, as (name, raw bytes)."""
    total = N_PIECES * PIECE
    return [
        ("full", _get("/https://origin/layer-a")),
        ("absolute_form", _get("https://origin/layer-b")),
        ("range", _get("/https://origin/layer-a", [("Range", "bytes=100-70000")])),
        ("suffix_range", _get("/https://origin/layer-c", [("Range", "bytes=-5000")])),
        ("unsatisfiable", _get("/https://origin/layer-d", [("Range", f"bytes={total + 9}-")])),
        ("malformed", _get("/https://origin/layer-e", [("Range", "bytes=9-2")])),
        ("rewrite", _get("/http://registry.local/layer-f")),
        ("direct", _get(f"/http://127.0.0.1:{direct_port}/blob")),
        ("direct_range", _get(f"http://127.0.0.1:{direct_port}/blob",
                              [("Range", "bytes=10-19")])),
        ("direct_unsatisfiable", _get(f"/http://127.0.0.1:{direct_port}/blob",
                                      [("Range", "bytes=999999-")])),
        ("direct_dead", _get("/http://127.0.0.1:1/nothing")),
    ]


def _connect(port, target_port):
    """CONNECT, then (when established) one GET through the tunnel."""
    with socket.create_connection(("127.0.0.1", port), timeout=15) as sock:
        sock.sendall(f"CONNECT 127.0.0.1:{target_port} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        f = sock.makefile("rb")
        status = f.readline().decode().strip()
        while f.readline() not in (b"\r\n", b""):
            pass
        if " 200 " not in status:
            return status, b""
        sock.sendall(b"GET /through HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
        # The origin's answer, through the tunnel, but its Date line.
        lines = f.read().split(b"\r\n")
        return status, b"\r\n".join(x for x in lines if not x.startswith(b"Date: "))


def _disconnect_mid_layer(swarm, port):
    """A client that reads the first piece of a layer daemon 0 holds, then
    hangs up: → (the tee's consumers once the client is gone, whether the
    download finished, its bytes)."""
    url = "https://origin/layer-disconnect"
    swarm.origin.n_pieces = 6
    assert swarm.daemons[0].download(url, piece_size=PIECE, content_length=6 * PIECE).ok
    child = swarm.daemons[1]
    child.conductor.piece_parallelism = 1
    inner = child.conductor.piece_fetcher

    class Slow:
        def fetch(self, host_id, task_id, number):
            time.sleep(0.05)
            return inner.fetch(host_id, task_id, number)

        def piece_bitmap(self, host_id, task_id):
            return inner.piece_bitmap(host_id, task_id)

    child.conductor.piece_fetcher = Slow()
    tid = swarm.idgen.task_id(url)
    sock = socket.create_connection(("127.0.0.1", port), timeout=15)
    sock.sendall(_get(f"/{url}"))
    f = sock.makefile("rb")
    status = f.readline()
    while f.readline() not in (b"\r\n", b""):
        pass
    first = f.read(PIECE)
    run = child.conductor.active_run(tid)
    assert run is not None, "the layer finished before the client hung up"
    sock.shutdown(socket.SHUT_RDWR)
    sock.close()
    f.close()
    deadline = time.monotonic() + 10
    while run.tee.consumer_count() and time.monotonic() < deadline:
        time.sleep(0.02)
    consumers = run.tee.consumer_count()
    result = run.wait_done(30.0)
    child.conductor.piece_fetcher = inner
    whole = child.read_task_bytes(tid) == swarm.origin.body(url)
    swarm.origin.n_pieces = N_PIECES
    return {"status": status, "first": first == swarm.origin.content(url, 0),
            "consumers": consumers, "ok": bool(result and result.ok), "bytes": whole}


@pytest.fixture(scope="module")
def answers(tmp_path_factory, direct):
    out = {}
    for pkg in PACKAGES:
        swarm = Swarm(pkg, tmp_path_factory.mktemp(pkg))
        proxy = swarm.proxy()
        try:
            got = {name: _request(proxy.port, raw) for name, raw in _script(direct.port)}
            got["connect"] = _connect(proxy.port, direct.port)
            got["connect_bad"] = _connect(proxy.port, 1)
            got["disconnect"] = _disconnect_mid_layer(swarm, proxy.port)
            got["stats"] = dict(proxy.stats)
            got["origin"] = swarm.origin
        finally:
            proxy.stop()
        out[pkg] = got
    return out


@pytest.mark.parametrize("name", [n for n, _ in _script(0)] + ["connect", "connect_bad"])
def test_both_proxies_answer_alike(answers, name):
    assert answers["port"][name] == answers["jax"][name]


def test_the_answers_are_the_origins_bytes(answers, direct):
    got, origin = answers["port"], answers["port"]["origin"]
    total = N_PIECES * PIECE
    status, headers, body = got["full"]
    assert status.endswith("200 OK") and body == origin.body("https://origin/layer-a")
    assert headers["accept-ranges"] == "bytes" and int(headers["content-length"]) == total
    assert got["absolute_form"][2] == origin.body("https://origin/layer-b")
    status, headers, body = got["range"]
    assert " 206 " in status and body == origin.body("https://origin/layer-a")[100:70001]
    assert headers["content-range"] == f"bytes 100-70000/{total}"
    assert got["suffix_range"][2] == origin.body("https://origin/layer-c")[-5000:]
    status, headers, body = got["unsatisfiable"]
    assert " 416 " in status and headers["content-range"] == f"bytes */{total}" and body == b""
    assert " 200 " in got["malformed"][0] and got["malformed"][2] == origin.body(
        "https://origin/layer-e")
    assert got["rewrite"][2] == origin.body("https://origin/layer-f")
    assert got["direct"][2] == DIRECT_BODY
    assert " 206 " in got["direct_range"][0] and got["direct_range"][2] == DIRECT_BODY[10:20]
    assert " 416 " in got["direct_unsatisfiable"][0]
    assert " 502 " in got["direct_dead"][0]
    status, body = got["connect"]
    assert " 200 " in status and body.endswith(DIRECT_BODY)
    assert " 502 " in got["connect_bad"][0]


def test_a_client_hanging_up_mid_layer_releases_the_tee(answers):
    for pkg in PACKAGES:
        got = answers[pkg]["disconnect"]
        assert got["first"] and got["consumers"] == 0 and got["ok"] and got["bytes"], (pkg, got)
    assert answers["port"]["disconnect"] == answers["jax"]["disconnect"]


def test_stats_match(answers):
    # p2p: full, absolute form, range, suffix range, malformed, rewrite and
    # the disconnected layer (the 416 counts none); direct: whole and
    # ranged (the 416 after a direct fetch counts, the dead origin none);
    # tunnel: the good CONNECT (the bad one counts none).
    assert answers["port"]["stats"] == answers["jax"]["stats"] == {
        "p2p": 7, "direct": 3, "tunnel": 1}


# -- the port counterparts of tests/test_breadth.py's proxy tests ----------


def test_rules_route_and_rewrite():
    m = tproxy
    router = m.ProxyRouter([
        m.ProxyRule.compile(r"^http://registry\.local/", redirect="http://mirror.local/"),
        m.ProxyRule.compile(r"\.layer$", use_p2p=True),
        m.ProxyRule.compile(r"^http://direct\.", use_p2p=False),
    ])
    use, url = router.route("http://registry.local/v2/blob")
    assert use and url == "http://mirror.local/v2/blob"
    assert router.route("http://x/foo.layer") == (True, "http://x/foo.layer")
    assert router.route("http://direct.example/a") == (False, "http://direct.example/a")
    assert router.route("http://other/a") == (False, "http://other/a")


def test_proxy_serves_p2p_content(tmp_path):
    swarm = Swarm("port", tmp_path)
    proxy = swarm.proxy(daemon=0)
    try:
        url = f"http://127.0.0.1:{proxy.port}/https://origin/blob-via-proxy"
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = resp.read()
        assert body == swarm.origin.body("https://origin/blob-via-proxy")
        assert proxy.stats["p2p"] == 1
    finally:
        proxy.stop()


def test_proxy_streams_before_task_finishes(tmp_path):
    swarm = Swarm("port", tmp_path)
    got = _disconnect_mid_layer(swarm, swarm.proxy().port)
    assert got["first"] and got["ok"]


def test_https_tunnel_passthrough(tmp_path, direct):
    swarm = Swarm("port", tmp_path, n_hosts=1)
    proxy = swarm.proxy(daemon=0, rules=[])
    try:
        conn = http.client.HTTPConnection("127.0.0.1", proxy.port, timeout=10)
        conn.set_tunnel("127.0.0.1", direct.port)
        conn.request("GET", "/anything")
        resp = conn.getresponse()
        assert resp.status == 200 and resp.read() == DIRECT_BODY
        assert proxy.stats["tunnel"] == 1
    finally:
        proxy.stop()


def test_connect_bad_target_502(tmp_path):
    swarm = Swarm("port", tmp_path, n_hosts=1)
    proxy = swarm.proxy(daemon=0, rules=[])
    try:
        conn = http.client.HTTPConnection("127.0.0.1", proxy.port, timeout=5)
        conn.set_tunnel("127.0.0.1", 1)  # closed port
        with pytest.raises(OSError):
            conn.request("GET", "/")
            conn.getresponse()
        assert proxy.stats["tunnel"] == 0
    finally:
        proxy.stop()


def test_relay_half_close_keeps_the_other_direction(tmp_path):
    """EOF from one side shuts only the other side's write half: bytes
    still flow the remaining way until it closes too."""
    import threading

    from dragonfly2_tpu_torch.daemon.relay import relay_bytes

    a_out, a_in = socket.socketpair()
    b_out, b_in = socket.socketpair()
    t = threading.Thread(target=relay_bytes, args=(a_in, b_in, 5.0), daemon=True)
    t.start()
    a_out.sendall(b"request")
    a_out.shutdown(socket.SHUT_WR)            # client done sending
    assert b_out.recv(100) == b"request"
    assert b_out.recv(100) == b""             # its EOF reached the far side
    b_out.sendall(b"late reply")              # the far side still answers
    b_out.shutdown(socket.SHUT_WR)
    assert a_out.recv(100) == b"late reply"
    assert a_out.recv(100) == b""
    t.join(5)
    assert not t.is_alive()
    for s in (a_out, a_in, b_out, b_in):
        s.close()


def test_relay_serves_descriptors_past_fd_setsize():
    """A daemon process holding more than 1,024 descriptors still tunnels:
    the relay's wait takes any descriptor (the reference's
    ``select.select`` raises ``ValueError`` past ``FD_SETSIZE``)."""
    import resource
    import threading

    from dragonfly2_tpu.daemon.relay import relay_bytes as jrelay
    from dragonfly2_tpu_torch.daemon.relay import relay_bytes

    soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < 1200:
        pytest.skip(f"RLIMIT_NOFILE {soft} keeps descriptors below 1,024")
    held = []
    try:
        while True:
            r, w = os.pipe()
            held += [r, w]
            if w >= 1030:
                break
        pairs = [socket.socketpair() for _ in range(2)]
        (a_out, a_in), (b_out, b_in) = pairs
        assert a_in.fileno() >= 1024
        for s in (a_out, b_out):
            s.settimeout(5.0)
        with pytest.raises(ValueError):
            jrelay(a_in, b_in, 0.1)
        t = threading.Thread(target=relay_bytes, args=(a_in, b_in, 5.0), daemon=True)
        t.start()
        a_out.sendall(b"past the set size")
        a_out.shutdown(socket.SHUT_WR)
        assert b_out.recv(100) == b"past the set size"
        b_out.shutdown(socket.SHUT_WR)
        assert a_out.recv(100) == b""
        t.join(5)
        assert not t.is_alive()
        for s in (a_out, a_in, b_out, b_in):
            s.close()
    finally:
        for fd in held:
            os.close(fd)
